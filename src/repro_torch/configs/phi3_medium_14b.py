"""Assigned architecture config (see registry.py for the literature source)."""
from .registry import PHI3_MEDIUM_14B as CONFIG

CONFIG = CONFIG
