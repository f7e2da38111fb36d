"""AdamW of the port (counterpart of ``repro.optim``)."""
from .adamw import AdamWConfig, adamw_init, adamw_update, clip_by_global_norm
