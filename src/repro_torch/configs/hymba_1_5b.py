"""Config shim: `--arch` maps here. See lm_archs.py."""
from .lm_archs import HYMBA_1_5B as CONFIG

CONFIG = CONFIG
