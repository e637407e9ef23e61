"""Config shim: `--arch` maps here. See lm_archs.py."""
from .lm_archs import MUSICGEN_MEDIUM as CONFIG

CONFIG = CONFIG
