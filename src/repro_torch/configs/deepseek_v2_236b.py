"""Config shim: `--arch` maps here. See lm_archs.py."""
from .lm_archs import DEEPSEEK_V2_236B as CONFIG

CONFIG = CONFIG
