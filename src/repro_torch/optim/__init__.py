"""AdamW and the LR schedule of the port (counterpart of
``repro.optim``)."""
from .adamw import AdamWConfig, adamw_init, adamw_update, clip_by_global_norm
from .schedule import cosine_schedule
