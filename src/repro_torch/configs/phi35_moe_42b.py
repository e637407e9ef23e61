"""Config shim: `--arch` maps here. See lm_archs.py."""
from .lm_archs import PHI35_MOE as CONFIG

CONFIG = CONFIG
