"""Config shim: `--arch` maps here. See lm_archs.py."""
from .lm_archs import H2O_DANUBE3_4B as CONFIG

CONFIG = CONFIG
