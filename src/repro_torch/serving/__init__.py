"""Continuous-batching serving tier of the port (counterpart of
``repro.serving``): ``config``, ``kv_pool``, ``scheduler``, ``engine``."""
