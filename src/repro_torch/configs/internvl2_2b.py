"""Config shim: `--arch` maps here. See lm_archs.py."""
from .lm_archs import INTERNVL2_2B as CONFIG

CONFIG = CONFIG
