"""Model assembly (counterpart of ``repro.models.lm``): parameter
specs, shapes and seeded init, the JAX-parameter bridge, the training
forward and loss (``forward_lm``, ``loss_fn``) of the dense (with
qk-norm too), MoE, encoder-decoder, Mamba-2 hybrid and xLSTM families,
the two steps of the continuous-batching engine — ``batched_prefill_step``
and ``paged_decode_step`` (dense only, and unsharded) — and JAX's
contiguous serving steps ``init_cache``, ``prefill_step`` and
``decode_step`` of the MoE family (GQA KV caches, or MLA's int8
compressed cache), the encoder-decoder family (the decoder's self and
cross KV caches), the Mamba-2 hybrid (the SSD and conv states and a KV
cache for each use of the shared block) and the xLSTM family (its
recurrent state), unsharded.

Parameters are a plain dict with the JAX package's layout: ``embed``
(V, d), ``final_norm`` (d,), ``lm_head`` (d, V), and per family the
stacks of per-layer weights on a leading L axis: ``layers`` (dense), or
``moe_layers``, ``dense_layers`` (``first_dense_layers``) and ``mtp``
(one block, deepseek-v3's multi-token prediction) of the MoE family,
whose attention is GQA or MLA; ``encoder`` and ``decoder`` of the
encoder-decoder family (whisper), the decoder's cross-attention leaves
prefixed ``x_``; ``mamba`` of the hybrid (zamba2), with ``shared_attn``,
one attention and MLP block that is not stacked (it runs after every
group of mamba layers); ``mlstm`` and ``slstm`` of the xLSTM family (an
sLSTM layer after every group of mLSTM layers).  With qk-norm an
attention block has ``q_norm`` and ``k_norm`` (hd,) (MLA's ``q_norm``
is its latent's norm, another leaf).  A MoE layer's attention and its
``moe_block`` share one ``norm`` leaf, as JAX merges their specs.
Weights are (in, out) and used as ``x @ w``.  The JAX package scans
over the L axis; here a Python loop walks it, with JAX's two-level remat
groups as ``torch.utils.checkpoint`` (``ShardCtx.remat_groups``).

Sharding follows JAX's ``param_specs``: each leaf's spec names, per
dimension, the mesh axis it is split over ('model', 'data' under FSDP,
or None; the routed experts are split on their expert axis over
'model'), and the padded global shapes (``ArchDims``: heads, KV heads,
vocabulary and d_ff padded to a multiple of tp; kv < tp replicates KV
heads) are JAX's, so a rank's shards (``shard_params``) are slices of
JAX's global arrays, and ``assemble_leaf`` joins them back.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from .. import tree as tree_util
from . import blocks
from .config import ModelConfig
from .layers import (NO_SHARD, ShardCtx, embed_lookup, gather_fsdp,
                     lm_loss, rmsnorm, swiglu_mlp)


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def serves_contiguous(cfg: ModelConfig) -> bool:
    """Whether ``cfg`` serves on JAX's contiguous steps (``init_cache``,
    ``prefill_step``, ``decode_step``): the MoE family (GQA or MLA), the
    encoder-decoder family and the ssm families (the Mamba-2 hybrid,
    xLSTM).  The dense family serves on the paged steps."""
    return bool(cfg.moe or cfg.ssm or cfg.enc_dec)


def _check_dense(cfg: ModelConfig, what: str):
    """The paged serving steps take the dense family only: the JAX
    engine's paged steps assert ``not (cfg.ssm or cfg.enc_dec or
    cfg.moe)``; those families serve on the contiguous steps."""
    if serves_contiguous(cfg):
        family = ("MoE" if cfg.moe else "enc-dec" if cfg.enc_dec
                  else "ssm")
        raise NotImplementedError(
            f"{what} needs a dense-attention model, got {cfg.name}: the "
            f"{family} family serves on the contiguous steps "
            f"(lm.prefill_step, lm.decode_step; ServeSession)")


def _check_contiguous(cfg: ModelConfig, what: str):
    """The contiguous serving steps take the MoE, enc-dec and ssm
    families."""
    if not serves_contiguous(cfg):
        raise NotImplementedError(
            f"{what}: {cfg.name} is dense and serves on the paged steps "
            f"(batched_prefill_step, paged_decode_step)")


def pad_to(x: int, mult: int) -> int:
    return -(-x // mult) * mult


@dataclasses.dataclass(frozen=True)
class ArchDims:
    """All padded dimensions derived from (cfg, ctx), as in JAX."""
    h_pad: int      # query heads padded to a multiple of tp
    kv_pad: int     # kv heads padded/replicated to a multiple of tp
    v_pad: int      # vocab padded to a multiple of tp
    ff_pad: int
    d_model: int

    @classmethod
    def build(cls, cfg: ModelConfig, ctx: ShardCtx = NO_SHARD):
        return cls(
            h_pad=pad_to(cfg.n_heads, ctx.tp),
            kv_pad=max(cfg.n_kv_heads, ctx.tp) if cfg.n_kv_heads < ctx.tp
            else pad_to(cfg.n_kv_heads, ctx.tp),
            v_pad=pad_to(cfg.vocab, ctx.tp),
            ff_pad=pad_to(max(cfg.d_ff, 1), ctx.tp),
            d_model=cfg.d_model)


# ====================== parameter specs and shapes ======================
#
# A spec is a tuple with one entry a dimension: the mesh axis the
# dimension is split over, or None (JAX's PartitionSpec entries).

def _fsdp(ctx: ShardCtx):
    return ctx.data_axis if ctx.fsdp else None


def attn_param_specs(cfg: ModelConfig, ctx: ShardCtx, dims: ArchDims):
    """Per-layer attention (specs, shapes), JAX's ``attn_param_specs``
    (the specs with the leading layer entry); with qk-norm also the
    replicated per-head norms ``q_norm`` and ``k_norm`` (hd,)."""
    fa, ma = _fsdp(ctx), ctx.model_axis
    hd = cfg.hd
    spec = {"norm": (None, None), "wq": (None, fa, ma),
            "wk": (None, fa, ma), "wv": (None, fa, ma),
            "wo": (None, ma, fa)}
    shapes = {"norm": (cfg.d_model,),
              "wq": (cfg.d_model, dims.h_pad * hd),
              "wk": (cfg.d_model, dims.kv_pad * hd),
              "wv": (cfg.d_model, dims.kv_pad * hd),
              "wo": (dims.h_pad * hd, cfg.d_model)}
    if cfg.qk_norm:
        spec.update(q_norm=(None, None), k_norm=(None, None))
        shapes.update(q_norm=(hd,), k_norm=(hd,))
    return spec, shapes


def mla_param_specs(cfg: ModelConfig, ctx: ShardCtx, dims: ArchDims):
    """Per-layer MLA (specs, shapes), JAX's ``mla_param_specs``."""
    fa, ma = _fsdp(ctx), ctx.model_axis
    hd, rd = cfg.hd, cfg.qk_rope_dim
    spec = {"norm": (None, None), "wq_a": (None, fa, None),
            "q_norm": (None, None), "wq_b": (None, None, ma),
            "wkv_a": (None, fa, None), "kv_norm": (None, None),
            "wkv_b": (None, None, ma), "wo": (None, ma, fa)}
    shapes = {"norm": (cfg.d_model,),
              "wq_a": (cfg.d_model, cfg.q_lora_rank),
              "q_norm": (cfg.q_lora_rank,),
              "wq_b": (cfg.q_lora_rank, dims.h_pad * (hd + rd)),
              "wkv_a": (cfg.d_model, cfg.kv_lora_rank + rd),
              "kv_norm": (cfg.kv_lora_rank,),
              "wkv_b": (cfg.kv_lora_rank, dims.h_pad * 2 * hd),
              "wo": (dims.h_pad * hd, cfg.d_model)}
    return spec, shapes


def moe_param_specs(cfg: ModelConfig, ctx: ShardCtx, dims: ArchDims):
    """Per-layer routed (and shared) experts (specs, shapes), JAX's
    ``moe_param_specs``: the experts split on their leading axis over
    'model'."""
    fa, ma = _fsdp(ctx), ctx.model_axis
    ffe, d, e = cfg.moe_d_ff, cfg.d_model, cfg.n_experts
    spec = {"norm": (None, None), "router": (None, None, ma),
            "w_gate": (None, ma, fa, None), "w_up": (None, ma, fa, None),
            "w_down": (None, ma, None, fa)}
    shapes = {"norm": (d,), "router": (d, e), "w_gate": (e, d, ffe),
              "w_up": (e, d, ffe), "w_down": (e, ffe, d)}
    if cfg.n_shared_experts:
        sh = pad_to(cfg.n_shared_experts * ffe, ctx.tp)
        spec.update({"sh_gate": (None, fa, ma), "sh_up": (None, fa, ma),
                     "sh_down": (None, ma, fa)})
        shapes.update({"sh_gate": (d, sh), "sh_up": (d, sh),
                       "sh_down": (sh, d)})
    return spec, shapes


def mlp_param_specs(cfg: ModelConfig, ctx: ShardCtx, dims: ArchDims):
    """Per-layer SwiGLU (specs, shapes), JAX's ``mlp_param_specs``."""
    fa, ma = _fsdp(ctx), ctx.model_axis
    spec = {"mlp_norm": (None, None), "w_gate": (None, fa, ma),
            "w_up": (None, fa, ma), "w_down": (None, ma, fa)}
    shapes = {"mlp_norm": (cfg.d_model,),
              "w_gate": (cfg.d_model, dims.ff_pad),
              "w_up": (cfg.d_model, dims.ff_pad),
              "w_down": (dims.ff_pad, cfg.d_model)}
    return spec, shapes


def mamba_param_specs(cfg: ModelConfig, ctx: ShardCtx, dims: ArchDims):
    """Per-layer Mamba-2 (specs, shapes), JAX's ``mamba_param_specs``:
    d_inner 2d in heads of 64, its heads over 'model'."""
    fa, ma = _fsdp(ctx), ctx.model_axis
    d, n = cfg.d_model, cfg.ssm_state
    di = 2 * d
    nh = di // 64
    spec = {"norm": (None, None), "w_x": (None, fa, ma),
            "w_z": (None, fa, ma), "w_bc": (None, fa, None),
            "w_dt": (None, None, ma), "conv_x": (None, None, ma),
            "conv_bc": (None, None, None), "dt_bias": (None, ma),
            "a_log": (None, ma), "d_skip": (None, ma),
            "w_out": (None, ma, fa)}
    shapes = {"norm": (d,), "w_x": (d, di), "w_z": (d, di),
              "w_bc": (d, 2 * n), "w_dt": (d, nh), "conv_x": (4, di),
              "conv_bc": (4, 2 * n), "dt_bias": (nh,), "a_log": (nh,),
              "d_skip": (nh,), "w_out": (di, d)}
    return spec, shapes


def mlstm_param_specs(cfg: ModelConfig, ctx: ShardCtx, dims: ArchDims):
    """Per-layer mLSTM (specs, shapes), JAX's ``mlstm_param_specs``:
    q, k, v and the gate z of d_inner 2d, the input and forget gates one
    a head (nh = h_pad), the heads over 'model'."""
    fa, ma = _fsdp(ctx), ctx.model_axis
    d = cfg.d_model
    spec = {"norm": (None, None), "w_q": (None, fa, ma),
            "w_k": (None, fa, ma), "w_v": (None, fa, ma),
            "w_z": (None, fa, ma), "w_if": (None, None, ma),
            "w_out": (None, ma, fa)}
    shapes = {"norm": (d,), "w_q": (d, 2 * d), "w_k": (d, 2 * d),
              "w_v": (d, 2 * d), "w_z": (d, 2 * d),
              "w_if": (d, 2 * dims.h_pad), "w_out": (2 * d, d)}
    return spec, shapes


def slstm_param_specs(cfg: ModelConfig, ctx: ShardCtx, dims: ArchDims):
    """Per-layer sLSTM (specs, shapes), JAX's ``slstm_param_specs``: the
    four gates' inputs (4d), the recurrent ``r`` (nh, hp, hp) with hp =
    d / nh, the heads over 'model'."""
    fa, ma = _fsdp(ctx), ctx.model_axis
    d, nh = cfg.d_model, dims.h_pad
    spec = {"norm": (None, None), "w_in": (None, fa, ma),
            "r": (None, ma, None, None), "w_out": (None, ma, fa)}
    shapes = {"norm": (d,), "w_in": (d, 4 * d), "r": (nh, d // nh, d // nh),
              "w_out": (d, d)}
    return spec, shapes


def cross_param_specs(cfg: ModelConfig, ctx: ShardCtx, dims: ArchDims):
    """The whisper decoder's cross-attention (specs, shapes): JAX's
    attention leaves, each prefixed ``x_``."""
    spec, shapes = attn_param_specs(cfg, ctx, dims)
    return ({f"x_{k}": v for k, v in spec.items()},
            {f"x_{k}": v for k, v in shapes.items()})


def param_specs(cfg: ModelConfig, ctx: ShardCtx = NO_SHARD):
    """(specs, global shapes) of the parameter tree (JAX
    ``param_specs``): ``layers`` of the dense family; ``moe_layers``,
    ``dense_layers`` and ``mtp`` of the MoE family, each stacking an
    attention block (GQA, or MLA) merged with its MoE block or MLP, so a
    layer has one ``norm``; ``encoder`` (attention and MLP over
    ``n_enc_layers``) and ``decoder`` (self-attention, the
    cross-attention's leaves prefixed ``x_``, and the MLP) of the
    encoder-decoder family; ``mamba`` (the mamba2 layers) and
    ``shared_attn`` (one attention and MLP block, not stacked: its specs
    lose the layer entry, as JAX strips it) of the hybrid, whose
    n_layers counts n_layers // attn_every uses of the shared block;
    ``mlstm`` and ``slstm`` (n_layers // slstm_every of them) of the
    xLSTM family."""
    dims = ArchDims.build(cfg, ctx)
    fa, ma = _fsdp(ctx), ctx.model_axis
    specs = {"embed": (ma, fa), "final_norm": (None,), "lm_head": (fa, ma)}
    shapes = {"embed": (dims.v_pad, cfg.d_model),
              "final_norm": (cfg.d_model,),
              "lm_head": (cfg.d_model, dims.v_pad)}

    def add(name, n, *builders):
        """The merged blocks as the stack ``name`` of n layers, or with n
        None as one block (its specs without the layer entry)."""
        sp, sh = {}, {}
        for build in builders:
            bsp, bsh = build(cfg, ctx, dims)
            sp.update(bsp)
            sh.update(bsh)
        if n is None:
            specs[name] = {k: v[1:] for k, v in sp.items()}
            shapes[name] = sh
            return
        specs[name] = sp
        shapes[name] = {k: (n,) + v for k, v in sh.items()}

    if cfg.ssm == "xlstm":
        n_s = _n_slstm(cfg)
        add("mlstm", cfg.n_layers - n_s, mlstm_param_specs)
        if n_s:
            add("slstm", n_s, slstm_param_specs)
        return specs, shapes
    if cfg.ssm:
        n_attn = _n_shared(cfg)
        add("mamba", cfg.n_layers - n_attn, mamba_param_specs)
        if n_attn:
            add("shared_attn", None, attn_param_specs, mlp_param_specs)
        return specs, shapes
    if cfg.enc_dec:
        add("encoder", cfg.n_enc_layers, attn_param_specs, mlp_param_specs)
        add("decoder", cfg.n_layers, attn_param_specs, cross_param_specs,
            mlp_param_specs)
        return specs, shapes
    if not cfg.moe:
        add("layers", cfg.n_layers, attn_param_specs, mlp_param_specs)
        return specs, shapes
    attn = mla_param_specs if cfg.mla else attn_param_specs
    nd = cfg.first_dense_layers
    add("moe_layers", cfg.n_layers - nd, attn, moe_param_specs)
    if nd:
        add("dense_layers", nd, attn, mlp_param_specs)
    if cfg.mtp:
        add("mtp", 1, attn, mlp_param_specs)
    return specs, shapes


def _n_shared(cfg: ModelConfig) -> int:
    """Uses of the hybrid's shared attention block (JAX's n_attn)."""
    return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0


def _n_slstm(cfg: ModelConfig) -> int:
    """sLSTM layers of the xLSTM family (JAX's n_s)."""
    return cfg.n_layers // cfg.slstm_every if cfg.slstm_every else 0


def param_shapes(cfg: ModelConfig, ctx: ShardCtx = NO_SHARD) -> dict:
    """The parameter tree's global (padded) shapes."""
    return param_specs(cfg, ctx)[1]


def _axis_sizes(ctx: ShardCtx) -> dict:
    return {ctx.pod_axis: ctx.pods, ctx.data_axis: ctx.dp,
            ctx.model_axis: ctx.tp}


def local_shape(shape, spec, ctx: ShardCtx) -> tuple:
    """One leaf's shard shape (JAX's local, inside-shard_map shape)."""
    sizes = _axis_sizes(ctx)
    return tuple(n if ax is None else n // sizes[ax]
                 for n, ax in zip(shape, spec))


def local_param_shapes(cfg: ModelConfig, ctx: ShardCtx) -> dict:
    """The parameter tree's shard shapes on every rank of ``ctx``'s
    mesh (the port's twin of what JAX's ``param_specs`` shardings give
    inside shard_map)."""
    specs, shapes = param_specs(cfg, ctx)
    return tree_util.tree_map(lambda sh, sp: local_shape(sh, sp, ctx),
                              shapes, specs)


def spec_leaves(cfg: ModelConfig, ctx: ShardCtx = NO_SHARD) -> list:
    """The specs, one a leaf in sorted-key order."""
    return tree_util.leaves(param_specs(cfg, ctx)[0])


def fsdp_leaves(cfg: ModelConfig, ctx: ShardCtx) -> list:
    """Per leaf (sorted-key order), whether its spec names the data axis:
    its gradient is already reduce-scattered over 'data' by the gather's
    transpose (JAX's ``_fsdp_leaf_tree``)."""
    return [ctx.data_axis in spec for spec in spec_leaves(cfg, ctx)]


def shard_leaf(t: torch.Tensor, spec, ctx: ShardCtx,
               coords: tuple) -> torch.Tensor:
    """The shard of global leaf ``t`` that the rank at mesh coordinates
    ``coords`` = (pod, d, m) holds (a copy)."""
    sizes = _axis_sizes(ctx)
    index = dict(zip((ctx.pod_axis, ctx.data_axis, ctx.model_axis), coords))
    for dim, ax in enumerate(spec):
        if ax is not None and sizes[ax] > 1:
            n = t.shape[dim] // sizes[ax]
            t = t.narrow(dim, index[ax] * n, n)
    return t.clone()


def shard_params(tree: dict, cfg: ModelConfig, ctx: ShardCtx,
                 coords: tuple) -> dict:
    """A tree of global leaves (params, or AdamW moments) as the rank at
    ``coords``' shards."""
    return tree_util.unflatten(tree, [
        shard_leaf(t, sp, ctx, coords) for t, sp in
        zip(tree_util.leaves(tree), spec_leaves(cfg, ctx))])


def assemble_leaf(shards: torch.Tensor, spec, ctx: ShardCtx) -> torch.Tensor:
    """Every rank's shard of one leaf, (pods * dp * tp, *local) in rank
    order, as the global array JAX's ``np.asarray`` gives: the data and
    model shards joined, and of a dimension no axis splits, device 0's
    copy (pod 0; data index 0 / model index 0 where the spec does not
    name the axis)."""
    g = shards.reshape(ctx.pods, ctx.dp, ctx.tp, *shards.shape[1:])[0]
    dd = spec.index(ctx.data_axis) if ctx.data_axis in spec else None
    md = spec.index(ctx.model_axis) if ctx.model_axis in spec else None
    g = g if dd is not None else g[:1]
    g = g if md is not None else g[:, :1]
    rows = [torch.cat(list(r), dim=md) if md is not None else r[0]
            for r in g]
    return torch.cat(rows, dim=dd) if dd is not None else rows[0]


_SSM_INITS = {"a_log": 0.0, "dt_bias": 0.5, "d_skip": 1.0}


def init_leaf(path: tuple, shp: tuple, dt: torch.dtype, randn,
              device=None) -> torch.Tensor:
    """One leaf of the ``init_params`` recipe at ``path`` and shape
    ``shp`` in dtype ``dt``; ``randn(shape)`` draws its f32 normals (on
    ``device``) when the recipe draws."""
    if path[-1] in _SSM_INITS:
        return torch.full(shp, _SSM_INITS[path[-1]], dtype=dt, device=device)
    if len(shp) == 1 or shp[-1] == 1 or path[-1].endswith("norm"):
        return torch.ones(shp, dtype=dt, device=device)
    fan_in = shp[-2] if len(shp) >= 2 else shp[-1]
    return (randn(shp) * (0.02 if fan_in > 8 else 0.5)).to(dt)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                ctx: ShardCtx = NO_SHARD, coords: tuple | None = None) -> dict:
    """Seeded parameters, the JAX ``init_params`` recipe: normal * 0.02
    (0.5 when fan_in <= 8), norms = 1, the mamba2 layers' ``a_log`` 0
    (A = -1), ``dt_bias`` 0.5 and ``d_skip`` 1 (JAX's
    ``_fix_special_inits``), cast to the config dtype, at the
    padded global shapes of ``ctx``; with ``coords`` = (pod, d, m) the
    shards of that rank.  Draws come from one CPU ``torch.Generator``
    in sorted-leaf order, leaf by leaf, so the weights depend on neither
    the device nor the mesh; they are not the numbers ``jax.random``
    draws (carry JAX weights across with ``params_from_jax``)."""
    gen = torch.Generator().manual_seed(seed)
    dt = torch_dtype(cfg)
    specs = spec_leaves(cfg, ctx)
    out: dict = {}
    for (path, shp), spec in zip(
            tree_util.leaves_with_paths(param_shapes(cfg, ctx)), specs):
        w = init_leaf(path, shp, dt, lambda s: torch.randn(
            s, generator=gen, dtype=torch.float32))
        if coords is not None:
            w = shard_leaf(w, spec, ctx, coords)
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


def params_from_jax(tree: dict, cfg: ModelConfig, device="cuda",
                    ctx: ShardCtx = NO_SHARD,
                    coords: tuple | None = None) -> dict:
    """The JAX package's parameter dict (leaves as numpy arrays of
    JAX's padded global shapes for ``ctx``, e.g. ``jax.tree.map(
    np.asarray, params)``) as this package's parameters, bit for bit;
    with ``coords`` = (pod, d, m) the shards of that rank.  Shapes are
    checked against ``param_shapes(cfg, ctx)``."""
    out: dict = {}
    for (path, shp), spec in zip(
            tree_util.leaves_with_paths(param_shapes(cfg, ctx)),
            spec_leaves(cfg, ctx)):
        node = tree
        for k in path:
            node = node[k]
        t = _from_numpy(node)
        if tuple(t.shape) != shp:
            raise ValueError(f"param {'/'.join(path)}: shape "
                             f"{tuple(t.shape)} != {shp}")
        if coords is not None:
            t = shard_leaf(t, spec, ctx, coords)
        tree_util.set_path(out, path, t.to(device))
    return out


def layer_params(params: dict, name: str = "layers") -> list:
    """Each layer's weights of the stack ``name``, views into the stacked
    tensors (one ``unbind`` per leaf, so a backward through them is one
    stack)."""
    stacked = {k: v.unbind(0) for k, v in params[name].items()}
    n = len(next(iter(stacked.values())))
    return [{k: v[i] for k, v in stacked.items()} for i in range(n)]


def _attn_mlp_layer(cfg: ModelConfig, p: dict, x: torch.Tensor, pos,
                    ctx: ShardCtx = NO_SHARD, axes=None, causal: bool = True,
                    cache=None, cache_pos=None):
    """One pre-norm transformer layer (attention, causal unless
    ``causal=False``, + SwiGLU MLP); with ``cache`` ({"k", "v"} (b, kvl,
    S, hd)) a decode step at ``cache_pos`` (``blocks.gqa_decode``, the
    cache written in place).  Returns (x, {"k", "v"}: the sequence's,
    or the cache)."""
    a, kv = _self_attention(cfg, p, x, pos, ctx, axes, cache, cache_pos,
                            causal)
    x = x + a
    x = x + swiglu_mlp(rmsnorm(x, p["mlp_norm"]), p["w_gate"], p["w_up"],
                       p["w_down"], ctx, axes)
    return x, kv


def _self_attention(cfg: ModelConfig, p: dict, x: torch.Tensor, pos, ctx,
                    axes, cache=None, cache_pos=None, causal: bool = True):
    """GQA self-attention over the sequence (``blocks.gqa_attention``),
    or with ``cache`` one decode step at ``cache_pos``
    (``blocks.gqa_decode``): JAX's ``gqa_attention`` branches."""
    if cache is None:
        return blocks.gqa_attention(cfg, p, x, pos, ctx, axes,
                                    causal=causal)
    return blocks.gqa_decode(cfg, p, x, cache_pos, cache, ctx)


def _mla_moe_layer(cfg: ModelConfig, p: dict, x: torch.Tensor, pos,
                   ctx: ShardCtx = NO_SHARD, axes=None,
                   dense_mlp: bool = False, cache=None, cache_pos=None):
    """One layer of the MoE family (JAX's ``_mla_moe_layer``): MLA or
    GQA attention (a decode step at ``cache_pos`` with ``cache``), then
    the MoE block, or with ``dense_mlp`` the SwiGLU MLP.  Returns (x,
    the layer's cache (the sequence's, or ``cache`` written in place),
    aux loss; 0.0 with ``dense_mlp``)."""
    attn = blocks.mla_attention if cfg.mla else _self_attention
    a, kv = attn(cfg, p, x, pos, ctx, axes, cache, cache_pos)
    x = x + a
    if dense_mlp:
        return x + swiglu_mlp(rmsnorm(x, p["mlp_norm"]), p["w_gate"],
                              p["w_up"], p["w_down"], ctx, axes), kv, 0.0
    y, aux = blocks.moe_block(cfg, p, x, ctx, axes)
    return x + y, kv, aux


# ============================== training ==============================

def scan_layers(body, x, layers: list, remat_groups: int = 0):
    """``x = body(x, p)`` over the layers (x a tensor or a tuple of them:
    the carry), with JAX's two-level remat
    (``scan_layers``) when ``remat_groups`` > 0: every layer under
    ``torch.utils.checkpoint`` and, when g = remat_groups satisfies
    JAX's ``g > 1 and n % g == 0 and n // g > 1``, every group of n / g
    layers checkpointed as well, so the live residuals drop from O(L)
    to O(g + L / g).  ``remat_groups`` 0 checkpoints nothing (JAX's
    scan checkpoints each layer always; the port keeps its activations
    unless asked).  A recompute runs its whole region (no early stop),
    so every layer's collectives run as often as its forward: once, and
    once more a checkpoint around it."""
    n, g = len(layers), remat_groups
    if g <= 0:
        for p in layers:
            x = body(x, p)
        return x

    def layer(x, p):
        return checkpoint(body, x, p, use_reentrant=False)

    def group(x, ps):
        for p in ps:
            x = layer(x, p)
        return x

    with set_checkpoint_early_stop(False):
        if g > 1 and n % g == 0 and n // g > 1:
            per = n // g
            for i in range(g):
                x = checkpoint(group, x, layers[i * per:(i + 1) * per],
                               use_reentrant=False)
            return x
        return group(x, layers)


def _encode(cfg: ModelConfig, params: dict, enc_frames: torch.Tensor,
            dtype: torch.dtype, ctx: ShardCtx = NO_SHARD, axes=None):
    """The encoder (JAX's enc-dec branch): its non-causal layers over the
    frames cast to ``dtype`` (positions 0..frames-1, no final norm), each
    checkpointed when ``ctx.remat_groups`` > 0, as JAX's ``ckpt``."""
    e = enc_frames.to(dtype)
    epos = torch.arange(e.shape[1], device=e.device)

    def enc_body(e, p):
        return _attn_mlp_layer(cfg, p, e, epos, ctx, axes, causal=False)[0]

    return scan_layers(enc_body, e, layer_params(params, "encoder"),
                       min(ctx.remat_groups, 1))


def _cross_params(p: dict) -> dict:
    """A decoder layer's cross-attention leaves without their ``x_``."""
    return {k[2:]: v for k, v in p.items() if k.startswith("x_")}


def _dec_layer(cfg: ModelConfig, p: dict, x: torch.Tensor, pos, e, ctx,
               axes, cache=None, cache_pos=None):
    """One decoder layer: causal self-attention and MLP, then the
    cross-attention added to the residual (no MLP after it).  Over the
    sequence, the cross K/V are e @ x_wk, e @ x_wv (frames long,
    non-causal); with ``cache`` ({"self", "cross"}: this layer's (b,
    kvl, S, hd) K/V) a decode step at ``cache_pos``, the self cache
    written in place and the cross cache read whole
    (``blocks.cross_decode``).  Returns (x, self K/V, cross K/V)."""
    x, skv = _attn_mlp_layer(cfg, p, x, pos, ctx, axes,
                             cache=None if cache is None else cache["self"],
                             cache_pos=cache_pos)
    xp = _cross_params(p)
    if cache is not None:
        return (x + blocks.cross_decode(cfg, xp, x, cache["cross"]), skv,
                cache["cross"])
    be, te = e.shape[:2]
    kvl = xp["wk"].shape[-1] // cfg.hd
    k = (e @ xp["wk"]).reshape(be, te, kvl, cfg.hd).transpose(1, 2)
    v = (e @ xp["wv"]).reshape(be, te, kvl, cfg.hd).transpose(1, 2)
    a, _ = blocks.gqa_attention(cfg, xp, x, None, ctx, axes, kv_ext=(k, v),
                                causal=False)
    return x + a, skv, {"k": k, "v": v}


def _enc_dec(cfg: ModelConfig, params: dict, x: torch.Tensor, pos,
             enc_frames: torch.Tensor, ctx: ShardCtx, axes):
    """The encoder-decoder trunk of training (JAX's ``cfg.enc_dec``
    branch): the encoder over the frames (``_encode``), then each decoder
    layer (``_dec_layer``), checkpointed one by one when
    ``ctx.remat_groups`` > 0, as JAX's ``ckpt``."""
    e = _encode(cfg, params, enc_frames, x.dtype, ctx, axes)

    def dec_body(x, p):
        return _dec_layer(cfg, p, x, pos, e, ctx, axes)[0]

    return scan_layers(dec_body, x, layer_params(params, "decoder"),
                       min(ctx.remat_groups, 1))


def _hybrid(cfg: ModelConfig, params: dict, x: torch.Tensor, pos,
            ctx: ShardCtx, axes):
    """The Mamba-2 hybrid's trunk (JAX's ``cfg.ssm == "mamba2"`` branch,
    its grouped forward): for each of the n_attn uses of the shared
    block, per = n_mamba // n_attn mamba layers (x + mamba2_block(x))
    and then ``shared_attn``'s attention and MLP layer; then the
    remaining mamba layers.  The shared block's gradient is the sum
    over its uses.  With ``ctx.remat_groups`` > 0 every mamba layer and
    every group is checkpointed, as JAX's ``ckpt``."""
    remat = min(ctx.remat_groups, 1)

    def mamba_body(x, p):
        return x + blocks.mamba2_block(cfg, p, x)[0]

    def group_body(x, ps):
        x = scan_layers(mamba_body, x, ps, remat)
        return _attn_mlp_layer(cfg, params["shared_attn"], x, pos, ctx,
                               axes)[0]

    layers = layer_params(params, "mamba")
    n_attn = _n_shared(cfg)
    per = len(layers) // n_attn if n_attn else 0
    with set_checkpoint_early_stop(False):
        for i in range(n_attn):
            group = layers[i * per:(i + 1) * per]
            x = (checkpoint(group_body, x, group, use_reentrant=False)
                 if remat else group_body(x, group))
    return scan_layers(mamba_body, x, layers[n_attn * per:], remat)


def _xlstm_groups(params: dict):
    """The xLSTM trunk's order (JAX's ``cfg.ssm == "xlstm"`` branch):
    (groups, tail), each group (per = n_m // n_s mLSTM layers' weights,
    then one sLSTM layer's), the tail the remaining mLSTM layers."""
    mls = layer_params(params, "mlstm")
    sls = layer_params(params, "slstm") if "slstm" in params else []
    per = len(mls) // len(sls) if sls else 0
    groups = [(mls[g * per:(g + 1) * per], p) for g, p in enumerate(sls)]
    return groups, mls[len(sls) * per:]


def _xlstm(cfg: ModelConfig, params: dict, x: torch.Tensor, ctx: ShardCtx):
    """The xLSTM trunk of training: for each of the n_s sLSTM layers,
    per mLSTM layers (x + mlstm_block(x)) and then the sLSTM layer (x +
    slstm_block(x)); then the tail of mLSTM layers (at the published 12
    layers, 3 x (3 mLSTM + 1 sLSTM); at SMOKE m, s, m, s).  With
    ``ctx.remat_groups`` > 0 every mLSTM layer and every group is
    checkpointed, as JAX's ``ckpt``."""
    remat = min(ctx.remat_groups, 1)

    def mlstm_body(x, p):
        return x + blocks.mlstm_block(cfg, p, x)[0]

    def group_body(x, group):
        x = scan_layers(mlstm_body, x, group[0], remat)
        return x + blocks.slstm_block(cfg, group[1], x)[0]

    groups, tail = _xlstm_groups(params)
    with set_checkpoint_early_stop(False):
        for group in groups:
            x = (checkpoint(group_body, x, group, use_reentrant=False)
                 if remat else group_body(x, group))
    return scan_layers(mlstm_body, x, tail, remat)


def forward_lm(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
               ctx: ShardCtx = NO_SHARD, axes=None,
               enc_frames: torch.Tensor | None = None):
    """Training forward on this rank's shards (``axes``: the process
    mesh, None for whole weights).  tokens: (b, t); ``enc_frames``: (b,
    frames, d) the encoder's input (the enc-dec family only).  Returns
    (hidden (b, t, d), aux loss: the MoE layers' summed aux, f32, or 0.0
    for the dense, enc-dec, hybrid and xLSTM families).  The MoE family
    runs its dense layers first, each checkpointed alone when
    ``ctx.remat_groups`` > 0 (JAX checkpoints each), then its MoE layers
    through ``scan_layers`` with the aux carried, as JAX's scan carries
    it."""
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    emb = gather_fsdp(ctx, axes, params["embed"], 1)
    x = embed_lookup(emb, tokens, ctx, axes)
    if cfg.enc_dec:
        if enc_frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder model: its "
                             f"batch needs enc_frames (b, frames, d)")
        return _enc_dec(cfg, params, x, pos, enc_frames, ctx, axes), 0.0
    if cfg.ssm == "xlstm":
        return _xlstm(cfg, params, x, ctx), 0.0
    if cfg.ssm:
        return _hybrid(cfg, params, x, pos, ctx, axes), 0.0
    if not cfg.moe:
        def body(x, p):
            return _attn_mlp_layer(cfg, p, x, pos, ctx, axes)[0]

        x = scan_layers(body, x, layer_params(params), ctx.remat_groups)
        return x, 0.0
    if cfg.first_dense_layers:
        def dense_body(x, p):
            return _mla_moe_layer(cfg, p, x, pos, ctx, axes, True)[0]

        x = scan_layers(dense_body, x, layer_params(params, "dense_layers"),
                        min(ctx.remat_groups, 1))

    def moe_body(carry, p):
        x, aux = carry
        x, _, a = _mla_moe_layer(cfg, p, x, pos, ctx, axes)
        return x, aux + a

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    moe = layer_params(params, "moe_layers")
    if not moe:
        # depth cut to the dense layers: JAX's scan over no layer gives
        # the empty stack zero gradients; autograd needs it in the graph
        aux = aux + sum(t.sum() for t in params["moe_layers"].values())
    return scan_layers(moe_body, (x, aux), moe, ctx.remat_groups)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict,
            ctx: ShardCtx = NO_SHARD, axes=None):
    """Next-token NLL of a (b, t + 1) token batch, vocab-sharded over
    'model', plus the MoE aux loss (weight 0.01) and, with ``cfg.mtp``,
    the multi-token-prediction loss (weight 0.3): the ``mtp`` block on
    the un-normed hidden state predicts the token after next.  The
    enc-dec family's batch also carries ``enc_frames`` (b, frames, d).
    Returns (loss + 0.01 aux, {"nll": the NLL with the MTP term})."""
    tokens = batch["tokens"].long()
    x, aux = forward_lm(cfg, params, tokens[:, :-1], ctx, axes,
                        batch.get("enc_frames"))
    h = rmsnorm(x, params["final_norm"])
    head = gather_fsdp(ctx, axes, params["lm_head"], 0)
    loss = lm_loss(h, head, tokens[:, 1:], ctx, axes)
    if cfg.mtp:
        pos = torch.arange(x.shape[1], device=x.device)
        p1 = {k: v[0] for k, v in params["mtp"].items()}
        x2 = _mla_moe_layer(cfg, p1, x, pos, ctx, axes, True)[0]
        h2 = rmsnorm(x2[:, :-1], params["final_norm"])
        loss = loss + 0.3 * lm_loss(h2, head, tokens[:, 2:], ctx, axes)
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


def _slstm_zero_state(cfg: ModelConfig, batch: int, device) -> dict:
    """The sLSTM layers' zero state (JAX's): h, c, n 0 and m -30, each
    (n_s, b, nh, d / nh) in f32."""
    nh = ArchDims.build(cfg).h_pad
    z = torch.zeros((_n_slstm(cfg), batch, nh, cfg.d_model // nh),
                    dtype=torch.float32, device=device)
    return {"h": z, "c": z, "n": z, "m": z - 30.0}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cuda") -> dict:
    """The decode cache of the contiguous families, JAX's ``init_cache``
    (unsharded), stacked on the layer axis:

    - GQA MoE: {"moe": kv(n_moe)} and, with ``first_dense_layers``,
      {"dense": kv(n_dense)}, kv(n) = {"k", "v": (n, b, kvl, max_seq,
      hd)} in the model dtype;
    - MLA: the same keys, each {"ckv": int8 (n, b, max_seq, kvr),
      "scale": f32 (n, b, max_seq, 1), "krope": (n, b, max_seq, rd)};
    - the Mamba-2 hybrid: {"mamba": {"ssm": (n_mamba, b, nh, 64, N),
      "conv_x": (n_mamba, b, 3, d_inner), "conv_bc": (n_mamba, b, 3,
      2N)} in f32, "attn": kv(n_shared)} (a KV cache for each use of
      the shared block);
    - xLSTM: its recurrent state in f32, {"mlstm": {"c": (n_m, b, nh,
      hp, hp), "n": (n_m, b, nh, hp)}, "slstm": {"h", "c", "n": zeros
      and "m": -30, each (n_s, b, nh, d / nh)}} with hp = 2d / nh,
      whatever ``max_seq`` (its size does not grow with the sequence);
    - enc-dec: {"self": kv(L), "cross": kv(L)}, both ``max_seq`` long
      (JAX's layout: the prefill's cross K/V, frames long, is written at
      offset 0, and the decode attends over all ``max_seq`` columns, so
      only ``max_seq`` equal to the frame count leaves no zero column).
    """
    _check_contiguous(cfg, "init_cache")
    dt = torch_dtype(cfg)
    dims = ArchDims.build(cfg)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def kv(n):
        return {"k": zeros(n, batch, dims.kv_pad, max_seq, cfg.hd, dtype=dt),
                "v": zeros(n, batch, dims.kv_pad, max_seq, cfg.hd, dtype=dt)}

    def mla(n):
        return {"ckv": zeros(n, batch, max_seq, cfg.kv_lora_rank,
                             dtype=torch.int8),
                "scale": zeros(n, batch, max_seq, 1),
                "krope": zeros(n, batch, max_seq, cfg.qk_rope_dim, dtype=dt)}

    if cfg.ssm == "xlstm":
        n_m = cfg.n_layers - _n_slstm(cfg)
        hp = 2 * cfg.d_model // dims.h_pad
        cache = {"mlstm": {"c": zeros(n_m, batch, dims.h_pad, hp, hp),
                           "n": zeros(n_m, batch, dims.h_pad, hp)}}
        if _n_slstm(cfg):
            cache["slstm"] = _slstm_zero_state(cfg, batch, device)
        return cache
    if cfg.ssm:
        n_attn = _n_shared(cfg)
        n_ssm, di = cfg.n_layers - n_attn, 2 * cfg.d_model
        cache = {"mamba": {
            "ssm": zeros(n_ssm, batch, di // 64, 64, cfg.ssm_state),
            "conv_x": zeros(n_ssm, batch, 3, di),
            "conv_bc": zeros(n_ssm, batch, 3, 2 * cfg.ssm_state)}}
        if n_attn:
            cache["attn"] = kv(n_attn)
        return cache
    if cfg.enc_dec:
        return {"self": kv(cfg.n_layers), "cross": kv(cfg.n_layers)}
    layer = mla if cfg.mla else kv
    cache = {"moe": layer(cfg.n_layers - cfg.first_dense_layers)}
    if cfg.first_dense_layers:
        cache["dense"] = layer(cfg.first_dense_layers)
    return cache


def _stack(states: list) -> dict:
    """Per-layer cache dicts stacked on a leading layer axis."""
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


def _layer(cache: dict, i: int) -> dict:
    """Layer i's views of a stacked cache (a decode step writes them)."""
    return {k: v[i] for k, v in cache.items()}


def _xlstm_serve(cfg: ModelConfig, params: dict, x: torch.Tensor,
                 cache: dict | None):
    """x through the xLSTM trunk carrying its state: one decode step from
    ``cache``, or with cache None the prefill, in which each mLSTM scans
    from a zero state and each sLSTM starts from the zero state, as
    JAX's ``prefill_step`` passes it.  Returns (x, the new cache)."""
    groups, tail = _xlstm_groups(params)
    if cache is None:
        cache = {"mlstm": None}
        if groups:
            cache["slstm"] = _slstm_zero_state(cfg, x.shape[0], x.device)
    new = {kind: [] for kind in cache}

    def layer(kind, block, p, x):
        i, states = len(new[kind]), cache[kind]
        y, st = block(cfg, p, x, None if states is None
                      else _layer(states, i))
        new[kind].append(st)
        return x + y

    for group, p_s in groups:
        for p in group:
            x = layer("mlstm", blocks.mlstm_block, p, x)
        x = layer("slstm", blocks.slstm_block, p_s, x)
    for p in tail:
        x = layer("mlstm", blocks.mlstm_block, p, x)
    return x, {kind: _stack(states) for kind, states in new.items()}


def _hybrid_serve(cfg: ModelConfig, params: dict, x: torch.Tensor, pos,
                  cache: dict | None, cache_pos: int | None):
    """x through the hybrid's trunk in JAX's grouped order (per mamba
    layers, then the shared block, n_attn times; then the tail): the
    prefill with cache None, each mamba layer's state and each use's KV
    collected; or one decode step at ``cache_pos``, every state and KV
    cache written in place.  Returns (x, the cache)."""
    layers = layer_params(params, "mamba")
    n_attn = _n_shared(cfg)
    per = len(layers) // n_attn if n_attn else 0
    states, kvs = [], []

    def mamba(x, i):
        st = None if cache is None else _layer(cache["mamba"], i)
        y, new = blocks.mamba2_block(cfg, layers[i], x, st)
        if cache is None:
            states.append(new)
        else:
            for k, v in new.items():
                st[k].copy_(v)
        return x + y

    for g in range(n_attn):
        for i in range(g * per, (g + 1) * per):
            x = mamba(x, i)
        x, kv = _attn_mlp_layer(
            cfg, params["shared_attn"], x, pos, cache=None if cache is None
            else _layer(cache["attn"], g), cache_pos=cache_pos)
        kvs.append(kv)
    for i in range(n_attn * per, len(layers)):
        x = mamba(x, i)
    if cache is not None:
        return x, cache
    out = {"mamba": _stack(states)}
    if kvs:
        out["attn"] = _stack(kvs)
    return x, out


def _moe_serve(cfg: ModelConfig, params: dict, x: torch.Tensor, pos,
               cache: dict | None, cache_pos: int | None):
    """x through the MoE family's layers (the dense ones first): the
    prefill with cache None, each layer's KV or compressed cache
    collected; or one decode step at ``cache_pos`` (each layer's cache
    written in place; the b tokens routed with the capacity rule of b
    tokens).  MTP is not used in serving, as in JAX.  Returns (x, the
    cache)."""
    out = {}
    for kind, name in (("dense", "dense_layers"), ("moe", "moe_layers")):
        if kind == "dense" and not cfg.first_dense_layers:
            continue
        kvs = []
        for i, p in enumerate(layer_params(params, name)):
            x, kv, _ = _mla_moe_layer(
                cfg, p, x, pos, dense_mlp=kind == "dense",
                cache=None if cache is None else _layer(cache[kind], i),
                cache_pos=cache_pos)
            kvs.append(kv)
        if cache is None and kvs:
            out[kind] = _stack(kvs)
    return x, (out if cache is None else cache)


def _enc_dec_serve(cfg: ModelConfig, params: dict, x: torch.Tensor, pos,
                   enc_frames, cache: dict | None, cache_pos: int | None):
    """x through the decoder: the prefill with cache None (the encoder
    over ``enc_frames`` first; each layer's self K/V, t long, and cross
    K/V, frames long, collected), or one decode step at ``cache_pos``
    (the self caches written in place, the cross caches read and
    returned as they are).  Returns (x, the cache)."""
    e = (_encode(cfg, params, enc_frames, x.dtype) if cache is None
         else None)
    skv, ckv = [], []
    for i, p in enumerate(layer_params(params, "decoder")):
        x, s, c = _dec_layer(
            cfg, p, x, pos, e, NO_SHARD, None, cache=None if cache is None
            else {k: _layer(cache[k], i) for k in ("self", "cross")},
            cache_pos=cache_pos)
        skv.append(s)
        ckv.append(c)
    if cache is not None:
        return x, cache
    return x, {"self": _stack(skv), "cross": _stack(ckv)}


def prefill_step(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                 enc_frames: torch.Tensor | None = None):
    """Contiguous serving prefill (JAX's ``prefill_step``) of the MoE,
    enc-dec and ssm families: the forward over the whole prompt batch
    (b, t), with attention on the flash kernel; the enc-dec family also
    takes ``enc_frames`` (b, frames, d), cast to the model dtype (the
    other families ignore it, as JAX's step does).
    Returns (logits (b, V) f32 at the last position, the prefill cache:
    ``init_cache``'s layout with the sequence axis t long, the cross K/V
    frames long, the recurrent states as they are)."""
    _check_contiguous(cfg, "prefill_step")
    if cfg.enc_dec and enc_frames is None:
        raise ValueError(f"prefill_step: {cfg.name} is an encoder-decoder "
                         f"model and needs enc_frames (b, frames, d)")
    x = embed_lookup(params["embed"], tokens)
    if cfg.enc_dec:
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x, cache = _enc_dec_serve(cfg, params, x, pos, enc_frames, None,
                                  None)
    elif cfg.ssm == "xlstm":
        x, cache = _xlstm_serve(cfg, params, x, None)
    else:
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        serve = _hybrid_serve if cfg.ssm else _moe_serve
        x, cache = serve(cfg, params, x, pos, None, None)
    return _logits(params, x[:, -1:]), cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                token: torch.Tensor, pos: int):
    """One contiguous decode step (JAX's ``decode_step``): token (b, 1),
    every row at position ``pos`` -> (logits (b, V) f32, the cache).
    The KV and compressed caches and the hybrid's states are written IN
    PLACE (GQA attention on the paged kernel, the cache one page a row;
    the enc-dec family's cross-attention on the paged kernel over every
    column of its cross cache, which is returned as it is); the xLSTM
    family returns its new state (``pos`` unused, as in JAX: the state
    carries the position)."""
    _check_contiguous(cfg, "decode_step")
    x = embed_lookup(params["embed"], token)
    if cfg.ssm == "xlstm":
        x, cache = _xlstm_serve(cfg, params, x, cache)
    else:
        pos_arr = torch.full((1,), pos, device=token.device)
        if cfg.enc_dec:
            x, cache = _enc_dec_serve(cfg, params, x, pos_arr, None, cache,
                                      pos)
        else:
            serve = _hybrid_serve if cfg.ssm else _moe_serve
            x, cache = serve(cfg, params, x, pos_arr, cache, pos)
    return _logits(params, x), cache
