"""Config shim: `--arch` maps here. See lm_archs.py."""
from .lm_archs import QWEN2_0_5B as CONFIG

CONFIG = CONFIG
