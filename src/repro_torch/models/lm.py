"""Dense transformer assembly (counterpart of ``repro.models.lm``) at
tensor parallelism 1: parameter shapes and seeded init, the
JAX-parameter bridge, the training forward and loss (``forward_lm``,
``loss_fn``), and the two steps of the continuous-batching engine —
``batched_prefill_step`` and ``paged_decode_step``.

Parameters are a plain dict with the JAX package's layout: ``embed``
(V, d), ``final_norm`` (d,), ``lm_head`` (d, V), and ``layers`` holding
each per-layer weight stacked on a leading L axis; weights are (in, out)
and used as ``x @ w``.  The JAX package scans over that axis; here a
Python loop walks it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import tree as tree_util
from . import blocks
from .config import ModelConfig
from .layers import embed_lookup, lm_loss, rmsnorm, swiglu_mlp


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_dense(cfg: ModelConfig, what: str):
    if cfg.ssm or cfg.enc_dec or cfg.moe:
        raise NotImplementedError(
            f"{what} needs a dense-attention model, got {cfg.name}")
    if cfg.qk_norm:
        raise NotImplementedError(f"qk_norm ({cfg.name}) is not ported")


@dataclasses.dataclass(frozen=True)
class ArchDims:
    """Padded dimensions derived from the config.  At tp=1 nothing is
    padded; kept so shapes read as in the JAX package."""
    h_pad: int
    kv_pad: int
    v_pad: int
    ff_pad: int
    d_model: int

    @classmethod
    def build(cls, cfg: ModelConfig):
        return cls(h_pad=cfg.n_heads, kv_pad=cfg.n_kv_heads, v_pad=cfg.vocab,
                   ff_pad=max(cfg.d_ff, 1), d_model=cfg.d_model)


# ====================== parameter shapes and init ======================

def attn_param_shapes(cfg: ModelConfig, dims: ArchDims) -> dict:
    """Per-layer attention shapes (JAX ``attn_param_specs``, tp=1)."""
    hd = cfg.hd
    return {
        "norm": (cfg.d_model,),
        "wq": (cfg.d_model, dims.h_pad * hd),
        "wk": (cfg.d_model, dims.kv_pad * hd),
        "wv": (cfg.d_model, dims.kv_pad * hd),
        "wo": (dims.h_pad * hd, cfg.d_model),
    }


def mlp_param_shapes(cfg: ModelConfig, dims: ArchDims) -> dict:
    """Per-layer SwiGLU shapes (JAX ``mlp_param_specs``, tp=1)."""
    return {
        "mlp_norm": (cfg.d_model,),
        "w_gate": (cfg.d_model, dims.ff_pad),
        "w_up": (cfg.d_model, dims.ff_pad),
        "w_down": (dims.ff_pad, cfg.d_model),
    }


def param_shapes(cfg: ModelConfig) -> dict:
    """The dense-family parameter tree's shapes (JAX ``param_specs``)."""
    _check_dense(cfg, "param_shapes")
    dims = ArchDims.build(cfg)
    layer = {**attn_param_shapes(cfg, dims), **mlp_param_shapes(cfg, dims)}
    return {"embed": (dims.v_pad, cfg.d_model),
            "final_norm": (cfg.d_model,),
            "lm_head": (cfg.d_model, dims.v_pad),
            "layers": {k: (cfg.n_layers,) + s for k, s in layer.items()}}


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Seeded parameters, the JAX ``init_params`` recipe: normal * 0.02
    (0.5 when fan_in <= 8), norms = 1, cast to the config dtype.  Draws
    come from one CPU ``torch.Generator`` in sorted-leaf order, so the
    weights do not depend on the device; they are not the numbers
    ``jax.random`` draws (carry JAX weights across with
    ``params_from_jax``)."""
    gen = torch.Generator().manual_seed(seed)
    dt = torch_dtype(cfg)
    out: dict = {}
    for path, shp in tree_util.leaves_with_paths(param_shapes(cfg)):
        fan_in = shp[-2] if len(shp) >= 2 else shp[-1]
        if len(shp) == 1 or shp[-1] == 1 or path[-1].endswith("norm"):
            w = torch.ones(shp, dtype=dt)
        else:
            w = (torch.randn(shp, generator=gen, dtype=torch.float32)
                 * (0.02 if fan_in > 8 else 0.5)).to(dt)
        tree_util.set_path(out, path, w.to(device))
    return out


def _from_numpy(a) -> torch.Tensor:
    """A numpy array (ml_dtypes bfloat16 included) as a torch tensor with
    the same bits."""
    a = np.array(a)                     # a writable copy torch can own
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """The JAX package's dense parameter dict (leaves as numpy arrays,
    e.g. ``jax.tree.map(np.asarray, params)``) as this package's
    parameters, bit for bit.  Shapes are checked against
    ``param_shapes(cfg)``."""
    out: dict = {}
    for path, shp in tree_util.leaves_with_paths(param_shapes(cfg)):
        node = tree
        for k in path:
            node = node[k]
        t = _from_numpy(node)
        if tuple(t.shape) != shp:
            raise ValueError(f"param {'/'.join(path)}: shape "
                             f"{tuple(t.shape)} != {shp}")
        tree_util.set_path(out, path, t.to(device))
    return out


def layer_params(params: dict) -> list:
    """Each layer's weights, views into the stacked tensors (one
    ``unbind`` per leaf, so a backward through them is one stack)."""
    stacked = {k: v.unbind(0) for k, v in params["layers"].items()}
    n = len(next(iter(stacked.values())))
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


def _attn_mlp_layer(cfg: ModelConfig, p: dict, x: torch.Tensor, pos):
    """One pre-norm transformer layer (attention + SwiGLU MLP); returns
    (x, {"k", "v"})."""
    a, kv = blocks.gqa_attention(cfg, p, x, pos)
    x = x + a
    x = x + swiglu_mlp(rmsnorm(x, p["mlp_norm"]), p["w_gate"], p["w_up"],
                       p["w_down"])
    return x, kv


# ============================== training ==============================

def forward_lm(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    """Training forward of the dense family.  tokens: (b, t).  Returns
    (hidden (b, t, d), aux_loss = 0.0).  The JAX version scans the
    stacked layers under ``jax.checkpoint``; a Python loop walks them
    here, with no rematerialization."""
    _check_dense(cfg, "forward_lm")
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = embed_lookup(params["embed"], tokens)
    for p in layer_params(params):
        x, _ = _attn_mlp_layer(cfg, p, x, pos)
    return x, 0.0


def loss_fn(cfg: ModelConfig, params: dict, batch: dict):
    """Next-token NLL of a (b, t + 1) token batch (dense: no MoE aux, no
    MTP).  Returns (loss, {"nll": loss})."""
    tokens = batch["tokens"].long()
    x, aux = forward_lm(cfg, params, tokens[:, :-1])
    h = rmsnorm(x, params["final_norm"])
    loss = lm_loss(h, params["lm_head"], tokens[:, 1:])
    return loss + 0.01 * aux, {"nll": loss}


def _logits(params: dict, h: torch.Tensor) -> torch.Tensor:
    """h: (b, 1, d) -> f32 logits (b, V)."""
    h = rmsnorm(h, params["final_norm"])
    return (h[:, 0] @ params["lm_head"]).float()


# =========================== serving paths ===========================

def batched_prefill_step(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                         lengths: torch.Tensor):
    """Serving prefill over a packed, right-padded prompt batch.

    tokens: (b, t) int64; lengths: (b,) valid tokens per row (0 = pad row,
    its outputs are discarded).  Right padding is harmless under the
    causal mask: every row's valid-prefix KV and last-position hidden
    state equal a solo run.  Returns (logits (b, V) f32 at position
    lengths-1, cache {"layers": {"k","v": (L, b, kvl, t, hd)}})."""
    _check_dense(cfg, "batched_prefill_step")
    b, t = tokens.shape
    pos = torch.arange(t, device=tokens.device)
    x = embed_lookup(params["embed"], tokens)
    ks, vs = [], []
    for p in layer_params(params):
        x, kv = _attn_mlp_layer(cfg, p, x, pos)
        ks.append(kv["k"])
        vs.append(kv["v"])
    last = lengths.long().clamp_min(1) - 1        # pad rows clamp to 0
    h = x[torch.arange(b, device=x.device), last][:, None]
    return _logits(params, h), {"layers": {"k": torch.stack(ks),
                                           "v": torch.stack(vs)}}


def paged_decode_step(cfg: ModelConfig, params: dict, pool: dict,
                      page_table: torch.Tensor, lengths: torch.Tensor,
                      token: torch.Tensor):
    """One continuous-batching decode step over the paged KV pool.

    pool: {"layers": {"k"/"v": (L, P, hkv, page, hd)}}, updated IN PLACE
    (the JAX step returns a new pool and donates the old buffer);
    page_table: (b, nb) int32; lengths: (b,) int32 tokens already cached
    per slot; token: (b, 1) int64 pending tokens.  Attention runs the
    paged kernel (``blocks.gqa_decode_paged``), once per layer.
    Returns (logits (b, V) f32, pool)."""
    _check_dense(cfg, "paged_decode_step")
    x = embed_lookup(params["embed"], token)
    for i, p in enumerate(layer_params(params)):
        kv = {"k": pool["layers"]["k"][i], "v": pool["layers"]["v"][i]}
        a, _ = blocks.gqa_decode_paged(cfg, p, x, lengths, kv, page_table)
        x = x + a
        x = x + swiglu_mlp(rmsnorm(x, p["mlp_norm"]), p["w_gate"], p["w_up"],
                           p["w_down"])
    return _logits(params, x), pool
