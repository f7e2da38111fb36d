"""Atomic, resumable checkpoints of the port (counterpart of
``repro.checkpoint``), in the JAX package's on-disk format."""
from .ckpt import (CheckpointManager, latest_step, load_checkpoint,
                   read_manifest, read_subtree_arrays, save_checkpoint)
