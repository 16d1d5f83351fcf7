"""Assigned architecture config (see registry.py for the literature source)."""
from .registry import INTERNLM2_20B as CONFIG

CONFIG = CONFIG
