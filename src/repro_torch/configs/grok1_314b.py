"""Assigned architecture config (see registry.py for the literature source)."""
from .registry import GROK_1_314B as CONFIG

CONFIG = CONFIG
