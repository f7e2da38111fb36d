"""ServeConfig: the serving tier's settings (copy of
``repro.serving.config``).  Field checks raise ValueError from
``__post_init__``."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Continuous-batching inference-tier knobs.

    ``max_seq`` bounds prompt + generation per sequence; the page table is
    ``ceil(max_seq / page_size)`` blocks wide.  ``pages`` sizes the shared
    physical KV pool (0 = auto: every slot can hold a full max_seq plus
    the reserved null page — no preemption possible; smaller values admit
    optimistically and preempt under pressure).  ``reload_every`` polls
    ``ckpt.dir`` for a newer checkpoint every N engine steps (hot-swap,
    ``serving.reload``).

    ``decode_backend`` is the JAX decode attention path, 'gather' or
    'paged'.  The port has one executor: both values attend over the
    pool in place through ``kernels.paged_attention`` (the paged kernel
    for CUDA tensors, its plain version for CPU tensors), as both
    ``--mesh-backend`` values run the one ``mesh_scan`` kernel.  The
    field stays so that a JAX spec round-trips.

    ``kv_dtype`` is the pool storage dtype: 'auto' follows the model
    dtype, 'bf16' halves pool bytes and page-read traffic (attention
    still accumulates f32), 'f32' stores full precision regardless of
    model dtype.
    """
    page_size: int = 16       # tokens per KV page
    max_active: int = 8       # concurrently decoding sequences (slots)
    max_queue: int = 64       # queued-but-not-admitted request cap
    max_seq: int = 256        # per-sequence cache capacity (prompt + gen)
    max_new_tokens: int = 64  # default per-request generation budget
    stop_token: int = -1      # end-of-sequence token id (-1 = none)
    temperature: float = 0.0  # 0 = greedy argmax
    top_k: int = 0            # sample from the k best logits (0 = full vocab)
    pages: int = 0            # physical KV pool size in pages (0 = auto)
    reload_every: int = 0     # hot-swap poll period in engine steps (0 = off)
    decode_backend: str = "gather"  # 'gather' | 'paged': both the kernel
    kv_dtype: str = "auto"    # KV pool storage: 'auto' | 'f32' | 'bf16'

    def __post_init__(self):
        if self.decode_backend not in ("gather", "paged"):
            raise ValueError(f"serve.decode_backend must be 'gather' or "
                             f"'paged', got {self.decode_backend!r}")
        if self.kv_dtype not in ("auto", "f32", "bf16"):
            raise ValueError(f"serve.kv_dtype must be 'auto', 'f32' or "
                             f"'bf16', got {self.kv_dtype!r}")
        for name in ("page_size", "max_active", "max_queue", "max_seq",
                     "max_new_tokens"):
            if getattr(self, name) < 1:
                raise ValueError(f"serve.{name} must be >= 1, "
                                 f"got {getattr(self, name)}")
        for name in ("temperature", "top_k", "pages", "reload_every"):
            if getattr(self, name) < 0:
                raise ValueError(f"serve.{name} must be >= 0, "
                                 f"got {getattr(self, name)}")
        if self.stop_token < -1:
            raise ValueError(f"serve.stop_token must be a token id or -1, "
                             f"got {self.stop_token}")

    @property
    def max_blocks(self) -> int:
        """Page-table width: logical blocks per sequence."""
        return -(-self.max_seq // self.page_size)

    @property
    def capacity(self) -> int:
        """Tokens one sequence's page table can address."""
        return self.max_blocks * self.page_size

    def auto_pages(self) -> int:
        """Pool size when ``pages`` is 0: one null page + a full page
        table per slot (pressure-free)."""
        return self.pages or 1 + self.max_active * self.max_blocks
