"""Assigned architecture config (see registry.py for the literature source)."""
from .registry import RWKV6_1_6B as CONFIG

CONFIG = CONFIG
