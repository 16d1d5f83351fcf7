"""Assigned architecture config (see registry.py for the literature source)."""
from .registry import QWEN3_MOE_30B_A3B as CONFIG

CONFIG = CONFIG
