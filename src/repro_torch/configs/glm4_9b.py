"""Config shim: `--arch` maps here. See lm_archs.py."""
from .lm_archs import GLM4_9B as CONFIG

CONFIG = CONFIG
