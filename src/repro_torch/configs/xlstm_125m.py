"""Config shim: `--arch` maps here. See lm_archs.py."""
from .lm_archs import XLSTM_125M as CONFIG

CONFIG = CONFIG
