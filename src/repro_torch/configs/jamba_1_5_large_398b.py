"""Assigned architecture config (see registry.py for the literature source)."""
from .registry import JAMBA_1_5_LARGE_398B as CONFIG

CONFIG = CONFIG
