"""Synthetic data of the port (counterpart of ``repro.data``)."""
from .pipeline import (DataConfig, SyntheticLM, make_batch_iterator,
                       synthetic_images)
