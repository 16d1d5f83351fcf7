"""Assigned architecture config (see registry.py for the literature source)."""
from .registry import MUSICGEN_MEDIUM as CONFIG

CONFIG = CONFIG
