"""Assigned architecture config (see registry.py for the literature source)."""
from .registry import COMMAND_R_PLUS_104B as CONFIG

CONFIG = CONFIG
