"""Assigned architecture config (see registry.py for the literature source)."""
from .registry import GEMMA_7B as CONFIG

CONFIG = CONFIG
