"""Spec -> step-builder bridge (counterpart of ``repro.api.build``, the
part with a torch meaning).

TrainSession and ServeSession build their steps here, so the train
step, the sync-state initializer and the serving steps never disagree
on the state structure.  JAX's ``param_specs``, ``sync_state_specs``
and ``decode_cache_specs`` are PartitionSpecs for shard_map and get no
twin: a rank's shard shapes come from ``models.lm.local_param_shapes``
(slices: ``lm.shard_params``) and its residual sizes from
``launch.steps._local_leaf_sizes``; the serving decode cache is a paged
pool with a fixed block table (``new_decode_cache``) for the dense
family, or JAX's contiguous cache (``lm.init_cache``) for the MoE and
ssm families: the serving builders route by family
(``lm.serves_contiguous``).
"""
from __future__ import annotations

import functools

import torch

from ..launch import steps
from ..models import lm
from ..serving import kv_pool
from .spec import RunSpec


def _cfg(spec: RunSpec, cfg):
    return cfg if cfg is not None else spec.model_config()


def warmup_photonics(spec: RunSpec, device=None):
    """Resolve the in-network ONN(s) for spec's photonic fidelity eagerly
    (None for 'behavioral') and put what they apply on ``device``, so a
    slow params source ('train') or a missing one fails before the step
    loop: the ONN for all pods * dp peers, for the cascade also the
    level-0 ONN of a pod's dp peers, and under FSDP with pods the ONN
    of the pods (the FSDP leaf group syncs over 'pod' only)."""
    from ..photonics import runtime
    sync, m = spec.resolved_sync(), spec.mesh
    module = runtime.warmup(sync, m.peers, device)
    if module is not None and sync.mode == "cascade":
        runtime.warmup(sync, m.dp, device)
    if module is not None and m.fsdp and m.pods > 1:
        runtime.warmup(sync, m.pods, device)
    return module


def _wire(spec: RunSpec, cfg):
    """(backend, sync, bf16 gradient bytes, N, the cascade's n1)."""
    from ..collectives import get_backend
    sync = spec.resolved_sync()
    nbytes = 2 * _cfg(spec, cfg).param_count()      # bf16 gradient bytes
    kw = {"n1": spec.mesh.dp} if sync.mode == "cascade" else {}
    return get_backend(sync.mode), sync, nbytes, spec.mesh.peers, kw


def modeled_time_on_wire(spec: RunSpec, cfg=None, overlap=None) -> float:
    """Analytic per-step wire-occupancy seconds of spec's sync scenario
    (the backend's ``time_on_wire``: line-rate transfer + per-bucket
    fabric reconfiguration, pipelined when overlap is on).  ``overlap``
    overrides ``spec.sync.overlap``; pure arithmetic."""
    backend, sync, nbytes, n, kw = _wire(spec, cfg)
    ov = sync.overlap if overlap is None else overlap
    return backend.time_on_wire(nbytes, n, sync.bits, overlap=ov,
                                bucket_bytes=sync.bucket_bytes, **kw)


def modeled_bytes_on_wire(spec: RunSpec, cfg=None) -> float:
    """Analytic per-step optical-wire bytes of spec's sync scenario (the
    backend's ``bytes_on_wire`` over N = pods * dp peers, with the
    cascade's level-1 split n1 = dp)."""
    backend, sync, nbytes, n, kw = _wire(spec, cfg)
    return backend.bytes_on_wire(nbytes, n, sync.bits, **kw)


def build_train_step(spec: RunSpec, cfg=None, device="cuda", world=None):
    """step(params, opt_state, sync_state, tokens, key) -> (params,
    opt_state, sync_state, metrics) over the ``pods * dp`` stacked peers,
    or as one of ``pods * dp * tp`` processes (``world``)
    (``launch.steps.make_train_step``; JAX returns it with its shard_map
    specs)."""
    return steps.make_train_step(_cfg(spec, cfg), spec.mesh.peers,
                                 spec.resolved_sync(), spec.optim, device,
                                 pods=spec.mesh.pods, world=world,
                                 ctx=spec.mesh.ctx())


def init_sync_state(spec: RunSpec, cfg=None, device="cuda",
                    world=None) -> dict:
    """Zero sync_state matching build_train_step ({} when error feedback
    is off, else {"rep": (rows, size)} and under FSDP {"fsdp": (rows,
    size)}: a row a stacked peer, one row a process)."""
    rows = spec.mesh.peers if world is None else 1
    return steps.init_sync_state(_cfg(spec, cfg), rows,
                                 spec.resolved_sync(), device,
                                 spec.mesh.ctx())


def build_prefill_step(spec: RunSpec, cfg=None):
    """step(params, tokens, lengths=None) -> (logits (b, V) f32 at each
    row's last valid position, prefill cache) through
    ``lm.batched_prefill_step`` (attention: the flash forward kernel).
    ``lengths`` None = every row is whole.  For the MoE, enc-dec and ssm
    families step(params, tokens, enc_frames=None) -> (logits at the
    last position, the contiguous prefill cache) through
    ``lm.prefill_step`` (``enc_frames`` (b, frames, d): the enc-dec
    family's encoder input)."""
    cfg = _cfg(spec, cfg)
    if lm.serves_contiguous(cfg):
        return functools.partial(lm.prefill_step, cfg)

    def step(params, tokens, lengths=None):
        if lengths is None:
            lengths = torch.full((tokens.shape[0],), tokens.shape[1],
                                 dtype=torch.int32, device=tokens.device)
        return lm.batched_prefill_step(cfg, params, tokens, lengths)
    return step


def new_decode_cache(spec: RunSpec, cfg, batch: int, max_seq: int,
                     device) -> dict:
    """A decode cache for ``batch`` sequences of up to ``max_seq``
    tokens: a paged pool (``spec.serve.page_size``, ``kv_dtype``) in
    which sequence i owns the ``ceil(max_seq / page_size)`` pages of row
    i of a fixed block table (page 0 is the null page); for the MoE,
    enc-dec and ssm families JAX's zero contiguous cache
    (``lm.init_cache``)."""
    if lm.serves_contiguous(cfg):
        return lm.init_cache(cfg, batch, max_seq, device)
    ps = spec.serve.page_size
    nb = -(-max_seq // ps)
    pool = kv_pool.init_pool(cfg, 1 + batch * nb, ps,
                             kv_dtype=spec.serve.kv_dtype, device=device)
    table = (1 + torch.arange(batch * nb, dtype=torch.int32,
                              device=device)).reshape(batch, nb)
    return {"pool": pool, "page_table": table}


def seed_cache(full: dict, pre: dict, path: tuple = ()) -> dict:
    """A prefill cache put into a fresh contiguous decode cache (JAX's
    ``ServeSession._seed_cache``): a leaf whose shape matches (a
    recurrent state; whisper's cross K/V at ``max_seq`` equal to the
    frame count) is taken as it is, in the decode cache's dtype; a KV,
    cross or compressed-cache leaf shorter on its sequence axis is
    written at offset 0 of ``full``'s leaf, in place.  A longer leaf
    raises, where JAX's ``dynamic_update_slice`` raises: the reference's
    cross cache needs ``max_seq`` >= the encoder's frames."""
    out = {}
    for k, f in full.items():
        p = pre[k]
        if isinstance(f, dict):
            out[k] = seed_cache(f, p, path + (k,))
        elif f.shape == p.shape:
            out[k] = p.to(f.dtype)
        elif any(n > m for n, m in zip(p.shape, f.shape)):
            raise ValueError(
                f"seed_cache: the prefill's {'/'.join(path + (k,))} "
                f"{tuple(p.shape)} is longer than the decode cache's "
                f"{tuple(f.shape)}" + (
                    ": the reference's cross cache is max_seq long and "
                    "needs max_seq >= the encoder's frame count"
                    if "cross" in path else ""))
        else:
            f[tuple(slice(0, n) for n in p.shape)] = p.to(f.dtype)
            out[k] = f
    return out


def build_decode_step(spec: RunSpec, cfg=None):
    """step(params, cache, token (b, 1), pos) -> (logits (b, V) f32,
    cache): every row's token at position ``pos`` through
    ``lm.paged_decode_step`` (attention: the paged_attention kernel);
    the pool is written in place.  For the MoE, enc-dec and ssm
    families the step of ``lm.decode_step`` over the contiguous cache
    (the enc-dec family's encoder output lives in its cross cache)."""
    cfg = _cfg(spec, cfg)
    if lm.serves_contiguous(cfg):
        return functools.partial(lm.decode_step, cfg)

    def step(params, cache, token, pos: int):
        lengths = torch.full((token.shape[0],), pos, dtype=torch.int32,
                             device=token.device)
        logits, pool = lm.paged_decode_step(cfg, params, cache["pool"],
                                            cache["page_table"], lengths,
                                            token)
        return logits, {**cache, "pool": pool}
    return step
