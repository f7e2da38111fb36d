"""Paged KV cache: a shared physical page pool + a free-list allocator
(counterpart of ``repro.serving.kv_pool``).

Layout per K/V leaf: ``(L, P, hkv, page_size, hd)`` — the contiguous
cache's (batch, seq) dims replaced by one physical page axis shared by
every active sequence, addressed through per-sequence page tables, so
memory scales with tokens in flight.

**Page 0 is the reserved null page**: fresh page tables point every block
at it, so inactive slot rows and not-yet-allocated blocks write and read
it harmlessly (masked to zero weight by the position-vs-length test).
"""
from __future__ import annotations

import torch

from ..models import lm
from ..models.config import ModelConfig

NULL_PAGE = 0
_KV_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def supports_paged(cfg: ModelConfig) -> bool:
    """Paged serving covers the dense-attention transformer families."""
    return not (cfg.ssm or cfg.enc_dec or cfg.moe)


class PageAllocator:
    """All-or-nothing free-list allocator over page ids 1..n_pages-1
    (page 0 is reserved as the null page, never handed out)."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError(f"pool needs >= 2 pages (page 0 is the "
                             f"reserved null page), got {n_pages}")
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, 0, -1))  # pop() serves low ids
        self._used: set = set()

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list | None:
        """n distinct pages, or None — never a partial allocation."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._used.update(out)
        return out

    def free(self, pages) -> None:
        for p in pages:
            if p not in self._used:
                raise ValueError(f"freeing page {p} that is not allocated "
                                 f"(double free or null page)")
            self._used.discard(p)
            self._free.append(p)


def init_pool(cfg: ModelConfig, n_pages: int, page_size: int,
              kv_dtype: str = "auto", device="cuda") -> dict:
    """Zeroed physical page pool.  ``kv_dtype`` is ServeConfig.kv_dtype:
    'auto' follows the model dtype, 'bf16' halves pool bytes (attention
    accumulates in f32 either way), 'f32' stores full precision."""
    if not supports_paged(cfg):
        raise NotImplementedError(f"no paged pool for {cfg.name}")
    dt = lm.torch_dtype(cfg) if kv_dtype == "auto" else _KV_DTYPES[kv_dtype]
    shape = (cfg.n_layers, n_pages, lm.ArchDims.build(cfg).kv_pad, page_size,
             cfg.hd)
    return {"layers": {"k": torch.zeros(shape, dtype=dt, device=device),
                       "v": torch.zeros(shape, dtype=dt, device=device)}}


def write_prompts(pool: dict, prefill_cache: dict, page_tables: torch.Tensor,
                  lengths: torch.Tensor) -> dict:
    """Scatter a batched prefill KV cache into each row's pages, IN PLACE
    (the JAX version returns a new pool and donates the old buffer).
    pool leaf: (L, P, kvl, ps, hd); prefill leaf: (L, b, kvl, t, hd) with
    t a multiple of ps; page_tables: (b, t // ps) page ids in
    logical-block order, null page 0 beyond a row's allocation; lengths:
    (b,) valid tokens per row (0 = pad row).

    Positions >= a row's length are zeroed before the scatter (pad-token
    KV never lands in the pool), and the null page — hit by every pad row
    and unallocated block — is re-zeroed afterwards."""
    idx = page_tables.reshape(-1).long()
    for name, pl in pool["layers"].items():
        kv = prefill_cache["layers"][name]
        n_layers, _, kvl, ps, hd = pl.shape
        b, t = kv.shape[1], kv.shape[3]
        valid = (torch.arange(t, device=kv.device)[None, :]
                 < lengths[:, None])                            # (b, t)
        kv = torch.where(valid[None, :, None, :, None], kv, 0)
        tiles = kv.reshape(n_layers, b, kvl, t // ps, ps, hd)
        tiles = tiles.permute(0, 1, 3, 2, 4, 5).reshape(
            n_layers, b * (t // ps), kvl, ps, hd)
        pl[:, idx] = tiles.to(pl.dtype)
        pl[:, NULL_PAGE] = 0
    return pool
