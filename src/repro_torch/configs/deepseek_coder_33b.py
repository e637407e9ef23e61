"""Config shim: `--arch` maps here. See lm_archs.py."""
from .lm_archs import DEEPSEEK_CODER_33B as CONFIG

CONFIG = CONFIG
