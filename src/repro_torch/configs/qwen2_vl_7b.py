"""Assigned architecture config (see registry.py for the literature source)."""
from .registry import QWEN2_VL_7B as CONFIG

CONFIG = CONFIG
