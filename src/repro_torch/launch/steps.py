"""The training step (counterpart of ``repro.launch.steps.
make_train_step``): data-parallel peers stacked on one card, or one
process a device of a (pod, data, model) mesh, with FSDP, tensor
parallelism and remat groups.

The JAX step runs inside shard_map, one program per device of the
('pod', 'data', 'model') axes.  Without sharding (tp 1, no FSDP) the
N = pods * dp peers are a loop on one device: peer p = pod * dp + d
takes rows [p B/N, (p+1) B/N) of the global batch, as shard_map splits
it over the (pod, data) mesh, and computes its loss and gradients on
them; the gradients go into one (N, total) f32 stack (leaves in
``jax.tree.flatten`` order), which ``collectives.engine.sync_flat``
synchronizes bucket by bucket.  The synced gradients are clipped by
their global norm and applied by AdamW.  The reported loss is the mean
over peers, as ``lax.pmean`` gives.

With ``SyncConfig.overlap`` the peers still run one after another, so a
bucket is complete only once the LAST peer has written its leaves:
per-leaf gradient hooks on the last peer's backward write each leaf
into the stack as the backward produces it and report it to an
``engine.BucketStream``, which launches every bucket whose leaves are
all written (on the card on a side CUDA stream, overlapping the rest of
that backward).  The result is the barrier path's, bit for bit.

Peers as processes (``world``, ``launch.distributed``): the rank at
mesh coordinates (pod, d, m) is model shard m of peer p = pod * dp + d
and takes peer p's rows; its gradient row goes through the backends'
collectives, and with overlap its own backward's hooks feed the stream.
The loss is the mean of the peers' losses gathered in rank order (the
stacked sum, bit for bit; an all-reduce would sum in NCCL's order).

Sharded (``ShardCtx``: tp > 1 or FSDP), JAX's ``_split_sync``: a leaf
whose spec names 'data' (FSDP) already has its gradient reduce-scattered
over 'data' by the transpose of its all-gather (in the leaf's dtype);
it is divided by dp in that dtype and synced over 'pod' only (the
cascade degrades to optinc there), or left as it is with one pod.  The
replicated leaves sync over the data axes, each model rank its own
shard.  The two groups are bucketed apart, with error-feedback
residuals {"rep", "fsdp"} of the local sizes (``_local_leaf_sizes``).
The clip's squared norm is psummed over 'model' only, so each data rank
clips by its own norm, and each rank keeps its own copy of the
replicated leaves, as each JAX device does.  Stacked peers take
``--fsdp`` too (tp 1): the state is then every data index's shards
stacked on a new first dimension (``to_local``), peer (pod, d) runs on
the whole weights its data rank would gather, and the reduce-scatter
is the pod's bf16 sum in data order, which equals NCCL's for dp = 2 (a
sum of two values commutes).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import prng
from ..collectives.bucketizer import make_layout, unbucketize
from ..collectives.engine import BucketStream, SyncConfig, sync_flat
from ..models import lm
from ..models.config import ModelConfig
from ..models.layers import NO_SHARD, ShardCtx
from ..optim.adamw import AdamWConfig, adamw_update, clip_by_global_norm
from ..photonics.encoding import f32_reciprocal
from ..tree import leaves, tree_map, unflatten


def _local_leaf_sizes(cfg: ModelConfig, ctx: ShardCtx = NO_SHARD):
    """(sizes, masks): per-leaf local (one rank's shard) element counts
    and the FSDP mask, in sorted-leaf order (JAX's
    ``_local_leaf_sizes``)."""
    return ([math.prod(s) for s in leaves(lm.local_param_shapes(cfg, ctx))],
            lm.fsdp_leaves(cfg, ctx))


def init_sync_state(cfg: ModelConfig, peers: int, sync: SyncConfig,
                    device="cuda", ctx: ShardCtx = NO_SHARD) -> dict:
    """Zero error-feedback residuals, {"rep": (peers, rep size)} f32 and,
    under FSDP, {"fsdp": (peers, FSDP size)} (the sizes of one rank's
    shards; ``peers`` rows: the stacked peers, or 1 for a process), or
    {} when feedback is off.  (The JAX state always has the "fsdp"
    group, empty without FSDP.)"""
    if not sync.error_feedback:
        return {}
    sizes, masks = _local_leaf_sizes(cfg, ctx)
    out = {"rep": sum(s for s, m in zip(sizes, masks) if not m)}
    if ctx.fsdp:
        out["fsdp"] = sum(s for s, m in zip(sizes, masks) if m)
    return {k: torch.zeros((peers, n), dtype=torch.float32, device=device)
            for k, n in out.items()}


def grad_readiness(global_indices, n_leaves: int) -> tuple:
    """Per-leaf gradient emission ranks for a leaf group (lower = that
    gradient leaves the backward earlier): the backward runs the network
    back to front, so leaf i of the forward-ordered tree is ready at
    rank n_leaves - 1 - i (``bucketizer.launch_order``'s model)."""
    return tuple(n_leaves - 1 - i for i in global_indices)


def _grads_from_hooks(loss, train, row: torch.Tensor, leaf_ready):
    """The backward of ``loss`` with a hook on every leaf that writes its
    gradient into ``row`` (the leaves concatenated) as soon as the
    backward produces it and then calls ``leaf_ready(i)``."""
    handles, off = [], 0
    for i, p in enumerate(train):
        def hook(g, i=i, off=off):
            row[off:off + g.numel()] = g.reshape(-1)
            leaf_ready(i)
        handles.append(p.register_hook(hook))
        off += p.numel()
    try:
        torch.autograd.grad(loss, train)
    finally:
        for h in handles:
            h.remove()


def peer_grad_stack(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                    peers: int, total: int, leaf_ready=None,
                    out: torch.Tensor | None = None,
                    ctx: ShardCtx = NO_SHARD,
                    enc_frames: torch.Tensor | None = None):
    """Each peer's loss and gradient on its rows of the global batch:
    peer p takes rows [p B/N, (p+1) B/N), as shard_map splits them, of
    the tokens and of ``enc_frames`` (B, frames, d), the enc-dec
    family's encoder input, when given.
    Returns (losses (peers,) f32, gradients (peers, total) f32, leaves in
    sorted-key order), the gradients in ``out`` when given.  With
    ``leaf_ready`` the last peer's leaves are written from gradient hooks
    during its backward, each reported by ``leaf_ready(leaf index)``."""
    if tokens.shape[0] % peers:
        raise ValueError(f"global batch {tokens.shape[0]} is not "
                         f"divisible by {peers} peers")
    per = tokens.shape[0] // peers
    train = [p.detach().requires_grad_() for p in leaves(params)]
    tparams = unflatten(params, train)
    flat = out if out is not None else torch.empty(
        (peers, total), dtype=torch.float32, device=tokens.device)
    losses = []
    for i in range(peers):
        loss, _ = lm.loss_fn(cfg, tparams,
                             _rows(tokens, enc_frames, i * per, per), ctx)
        if leaf_ready is not None and i == peers - 1:
            _grads_from_hooks(loss, train, flat[i], leaf_ready)
        else:
            off = 0
            for g in torch.autograd.grad(loss, train):
                flat[i, off:off + g.numel()] = g.reshape(-1)
                off += g.numel()
        losses.append(loss.detach())
    return torch.stack(losses), flat


def _rows(tokens, enc_frames, start: int, n: int) -> dict:
    """The batch of rows [start, start + n): its tokens and, for the
    enc-dec family, its encoder frames."""
    batch = {"tokens": tokens[start:start + n]}
    if enc_frames is not None:
        batch["enc_frames"] = enc_frames[start:start + n]
    return batch


def make_train_step(cfg: ModelConfig, peers: int, sync: SyncConfig,
                    opt: AdamWConfig, device="cuda", pods: int = 1,
                    world=None, ctx: ShardCtx | None = None):
    """Returns ``step(params, opt_state, sync_state, tokens, key=None,
    enc_frames=None) -> (params, opt_state, sync_state, metrics)`` over
    ``peers`` = pods * dp peers; tokens: (B, t + 1) on ``device`` with B
    a multiple of ``peers``; ``enc_frames``: (B, frames, d), the enc-dec
    family's encoder input (JAX's batch carries it beside the tokens,
    split over the peers as they are); ``key``: the step's sync key
    (``prng``; the PhotonicsConfig
    noise and Table-II injection draw from it); metrics: {"loss",
    "grad_norm"}.  With ``sync.overlap`` each call leaves its
    ``BucketStream`` in ``step.last_stream`` (launch order, ``early``).
    ``world``: this process is one device of the mesh (its sync state
    its residual rows, tokens the global batch).  ``ctx``: the mesh's
    ShardCtx (default: ``peers`` / ``pods`` data peers, unsharded);
    sharded, params and opt_state are this rank's shards, or for stacked
    peers the stacked shards of ``to_local``."""
    if ctx is None:
        ctx = ShardCtx(dp=peers // pods, pods=pods)
    if cfg.enc_dec and ctx.fsdp:
        raise ValueError(
            f"{cfg.name} with --fsdp: the reference cannot run it either "
            f"(JAX's cross-attention projects the encoder output with the "
            f"un-gathered FSDP shard of x_wk/x_wv; its dry run lists "
            f"whisper-tiny in NO_FSDP)")
    if cfg.enc_dec and ctx.tp > 1:
        raise NotImplementedError(
            f"{cfg.name} with tensor parallelism (tp {ctx.tp}): the "
            f"enc-dec family is not ported at tp > 1 yet")
    if cfg.ssm and ctx.sharded:
        raise NotImplementedError(
            f"{cfg.name} with "
            + ("--fsdp" if ctx.fsdp else f"tensor parallelism (tp {ctx.tp})")
            + ": the ssm family (mamba2, xLSTM) is not ported sharded yet "
            f"(JAX runs it with its heads, the SSD's or the mLSTM's and "
            f"sLSTM's, over 'model' and its weights over 'data')")
    if ctx.sharded:
        return _sharded_train_step(cfg, sync, opt, ctx, world)
    shapes = leaves(lm.param_shapes(cfg))
    layout = make_layout([(s, lm.torch_dtype(cfg)) for s in shapes],
                         sync.bucket_bytes)
    local = peers if world is None else 1

    def grads_and_sync(params, tokens, residual, key, enc_frames):
        if world is not None:
            per = tokens.shape[0] // peers
            batch = _rows(tokens, enc_frames, world.rank * per, per)
            tokens, enc_frames = batch["tokens"], batch.get("enc_frames")
        if not sync.overlap:
            losses, flat = peer_grad_stack(cfg, params, tokens, local,
                                           layout.total, ctx=ctx,
                                           enc_frames=enc_frames)
            return losses, flat, *sync_flat(flat, layout.bounds, sync,
                                            residual, key, pods, world)
        flat = torch.empty((local, layout.total), dtype=torch.float32,
                           device=tokens.device)
        stream = BucketStream(layout, sync, flat, residual, key, pods, world)
        step.last_stream = stream
        losses, _ = peer_grad_stack(cfg, params, tokens, local, layout.total,
                                    stream.leaf_ready, flat, ctx, enc_frames)
        return losses, flat, *stream.finish()

    def step(params, opt_state, sync_state, tokens, key=None,
             enc_frames=None):
        if tokens.shape[0] % peers:
            raise ValueError(f"global batch {tokens.shape[0]} is not "
                             f"divisible by {peers} peers")
        if enc_frames is not None:
            enc_frames = enc_frames.to(device)
        losses, flat, synced, residual = grads_and_sync(
            params, tokens.to(device), sync_state.get("rep"), key,
            enc_frames)
        if world is not None:
            losses = world.gather_rows(losses)
        if sync.error_feedback:
            sync_state = {"rep": residual if residual is not None
                          else torch.zeros_like(flat)}
        grads = unflatten(params, unbucketize([synced], layout))
        grads, gnorm = clip_by_global_norm(grads, opt.clip_norm)
        params, opt_state = adamw_update(opt, params, grads, opt_state)
        return params, opt_state, sync_state, {"loss": losses.sum() / peers,
                                               "grad_norm": gnorm}

    step.last_stream = None
    return step


# ------------------------------------------------------- sharded steps
def to_local(tree: dict, cfg: ModelConfig, ctx: ShardCtx, world=None):
    """A tree of global leaves (params, or a moment) as the step's state:
    itself unsharded, this rank's shards (``world``), or for stacked
    peers under FSDP the shards of every data index stacked on a new
    first dimension, (dp, *local) a leaf (the state of every rank of that
    data index)."""
    if not ctx.sharded:
        return tree
    if world is not None:
        return lm.shard_params(tree, cfg, ctx, world.coords)
    return unflatten(tree, [
        torch.stack([lm.shard_leaf(t, sp, ctx, (0, d, 0))
                     for d in range(ctx.dp)])
        for t, sp in zip(leaves(tree), lm.spec_leaves(cfg, ctx))])


def to_global(state: dict, cfg: ModelConfig, ctx: ShardCtx, world=None):
    """The inverse of ``to_local``: the global leaves JAX's ``np.asarray``
    gives, shards joined and of a replicated leaf device 0's copy.  With
    ``world`` collective: every rank sends its shards to rank 0, which
    assembles each leaf on its host before the next and gets the tree;
    the other ranks get None."""
    if not ctx.sharded:
        return state
    specs = lm.spec_leaves(cfg, ctx)
    if world is None:
        one = dataclasses.replace(ctx, pods=1)
        return unflatten(state, [lm.assemble_leaf(t, sp, one)
                                 for t, sp in zip(leaves(state), specs)])
    root = world.rank == 0
    out = []
    for t, sp in zip(leaves(state), specs):
        if any(ax is not None and world.sizes[ax] > 1 for ax in sp):
            g = world.gather_to_root(t)
            out.append(None if g is None else lm.assemble_leaf(g, sp, ctx))
        else:
            out.append(t.to("cpu", copy=True) if root else None)
    return unflatten(state, out) if root else None


def opt_to_local(opt_state: dict, cfg, ctx, world=None) -> dict:
    """A global AdamW state as the step's (``to_local`` of its moments)."""
    if not ctx.sharded:
        return opt_state
    return {"m": to_local(opt_state["m"], cfg, ctx, world),
            "v": to_local(opt_state["v"], cfg, ctx, world),
            "step": opt_state["step"]}


def opt_to_global(opt_state: dict, cfg, ctx, world=None):
    """The inverse of ``opt_to_local`` (collective as ``to_global``:
    None on the ranks other than 0)."""
    if not ctx.sharded:
        return opt_state
    m = to_global(opt_state["m"], cfg, ctx, world)
    v = to_global(opt_state["v"], cfg, ctx, world)
    return None if m is None else {"m": m, "v": v, "step": opt_state["step"]}


def _flat_rows(grads) -> torch.Tensor:
    """Per-leaf gradients (one row each) as a (1, total) f32 row."""
    if not grads:
        return torch.zeros((1, 0), dtype=torch.float32)
    return torch.cat([g.reshape(1, -1).float() for g in grads], dim=1)


def _sharded_train_step(cfg: ModelConfig, sync: SyncConfig,
                        opt: AdamWConfig, ctx: ShardCtx, world=None):
    """The step of a sharded mesh (module docstring): ``world`` the
    process mesh, else stacked peers under FSDP (tp 1)."""
    if world is None and ctx.tp > 1:
        raise ValueError("tensor parallelism runs across processes only")
    if sync.overlap:
        raise ValueError("--overlap does not run with --fsdp or tp > 1")
    dt = lm.torch_dtype(cfg)
    shapes = leaves(lm.local_param_shapes(cfg, ctx))
    masks = lm.fsdp_leaves(cfg, ctx)
    specs = lm.spec_leaves(cfg, ctx)
    rep_idx = [i for i, m in enumerate(masks) if not m]
    fs_idx = [i for i, m in enumerate(masks) if m]
    rep_layout = make_layout([(shapes[i], dt) for i in rep_idx],
                             sync.bucket_bytes)
    fs_layout = make_layout([(shapes[i], dt) for i in fs_idx],
                            sync.bucket_bytes)
    rep_cfg = dataclasses.replace(sync, axes=ctx.dp_axes)
    fs_cfg = dataclasses.replace(
        sync, axes=(ctx.pod_axis,),
        mode="optinc" if sync.mode == "cascade" else sync.mode)
    ef = sync.error_feedback
    peers = ctx.pods * ctx.dp
    inv_dp = f32_reciprocal(ctx.dp)
    clip_axes = (ctx.model_axis,)

    def split_sync(rep_rows, fs_rows, sync_state, key, fs_rows_of):
        """JAX's ``_split_sync`` over (rows, size) stacks: the replicated
        group over the data axes; the FSDP group (``fs_rows_of``: (d,
        the rows of data index d over the pods) pairs; its residuals
        ``sync_state["fsdp"][d]``) over 'pod'.  Returns the synced
        replicated vector, the synced FSDP vector of each data index and
        the new residual rows."""
        # JAX splits the key in two; the replicated group keeps the step
        # key here, as the unsharded step syncs all leaves with it
        k_fs = None if key is None else prng.fold_in(key, 1)
        rep, rep_res = sync_flat(rep_rows, rep_layout.bounds, rep_cfg,
                                 sync_state.get("rep"), key, ctx.pods, world)
        new = {}
        if ef:
            new["rep"] = (rep_res if rep_res is not None
                          else torch.zeros_like(rep_rows))
        fs, fs_res = [], []
        for d, rows in fs_rows_of(fs_rows):
            if ctx.pods > 1 and fs_idx:
                res = sync_state.get("fsdp")
                out, r = sync_flat(rows, fs_layout.bounds, fs_cfg,
                                   None if res is None else res[d],
                                   k_fs, 1, world)
            else:
                out, r = rows[0], None
            fs.append(out)
            fs_res.append(r if r is not None else torch.zeros_like(rows))
        if ef and ctx.fsdp:
            new["fsdp"] = _interleave(fs_res)
        return rep, fs, new

    def apply(params, opt_state, grads):
        grads, gnorm = clip_by_global_norm(unflatten(params, grads),
                                           opt.clip_norm, clip_axes, world)
        params, opt_state = adamw_update(opt, params, grads, opt_state)
        return params, opt_state, gnorm

    def sync_grads(grads, sync_state, key=None):
        """This rank's local gradients (leaf order) through JAX's
        ``_split_sync``: (the synced leaves, the new residual rows)."""
        rep_rows = _flat_rows([grads[i] for i in rep_idx])
        fs_rows = _flat_rows([grads[i] * inv_dp for i in fs_idx])
        res = dict(sync_state)
        if "fsdp" in res:
            res["fsdp"] = [res["fsdp"]]
        rep, fs, new = split_sync(rep_rows.to(world.device),
                                  fs_rows.to(world.device), res, key,
                                  lambda rows: [(0, rows)])
        return _joined(rep, fs[0]), new

    def _joined(rep, fs):
        out = [None] * len(shapes)
        for i, g in zip(rep_idx, unbucketize([rep], rep_layout)):
            out[i] = g
        for i, g in zip(fs_idx, unbucketize([fs], fs_layout)):
            out[i] = g
        return out

    def process_step(params, opt_state, sync_state, tokens, key=None):
        pod, d, _ = world.coords
        per = tokens.shape[0] // peers
        p = pod * ctx.dp + d
        train = [t.detach().requires_grad_() for t in leaves(params)]
        loss, _ = lm.loss_fn(cfg, unflatten(params, train),
                             {"tokens": tokens[p * per:(p + 1) * per]},
                             ctx, world)
        grads, new = sync_grads(torch.autograd.grad(loss, train),
                                sync_state, key)
        params, opt_state, gnorm = apply(params, opt_state, grads)
        losses = world.gather_rows(loss.detach().reshape(1))[::ctx.tp]
        return params, opt_state, new, {"loss": losses.sum() / peers,
                                        "grad_norm": gnorm}

    process_step.sync_grads = sync_grads

    def stacked_step(params, opt_state, sync_state, tokens, key=None):
        per = tokens.shape[0] // peers
        ls = leaves(params)
        # the weights data rank d gathers: the FSDP leaves whole
        joined = {i: torch.cat(list(ls[i]), dim=specs[i].index(ctx.data_axis))
                  for i in fs_idx}
        whole = [[joined[i] if masks[i] else t[d] for i, t in enumerate(ls)]
                 for d in range(ctx.dp)]
        losses, pgrads = [], []
        for p in range(peers):
            train = [t.detach().requires_grad_() for t in whole[p % ctx.dp]]
            loss, _ = lm.loss_fn(cfg, unflatten(params, train),
                                 {"tokens": tokens[p * per:(p + 1) * per]},
                                 ctx)
            pgrads.append(torch.autograd.grad(loss, train))
            losses.append(loss.detach())
        rep_rows = torch.cat([_flat_rows([g[i] for i in rep_idx])
                              for g in pgrads]).to(tokens.device)
        # the reduce-scatter: each pod's sum over its data peers in the
        # leaf's dtype, in data order, then / dp, shard d to data rank d
        fs_rows = []
        for pod in range(ctx.pods):
            sums = []
            for i in fs_idx:
                acc = pgrads[pod * ctx.dp][i]
                for d in range(1, ctx.dp):
                    acc = acc + pgrads[pod * ctx.dp + d][i]
                sums.append(acc * inv_dp)
            for d in range(ctx.dp):
                fs_rows.append(_flat_rows([
                    lm.shard_leaf(g, specs[i], ctx, (0, d, 0))
                    for g, i in zip(sums, fs_idx)]))
        fs_rows = torch.cat(fs_rows).to(tokens.device)
        res = dict(sync_state)
        if "fsdp" in res:
            res["fsdp"] = [res["fsdp"][d::ctx.dp] for d in range(ctx.dp)]
        rep, fs, new = split_sync(
            rep_rows, fs_rows, res, key,
            lambda rows: [(d, rows[d::ctx.dp]) for d in range(ctx.dp)])
        # each data index's update on its own slice of the state (AdamW
        # decays matrices only, so it never sees the stacked leaves)
        outs = [apply(_slice(params, d),
                      {"m": _slice(opt_state["m"], d),
                       "v": _slice(opt_state["v"], d),
                       "step": opt_state["step"]}, _joined(rep, fs[d]))
                for d in range(ctx.dp)]
        params = _stack([p for p, _, _ in outs])
        opt_state = {"m": _stack([o["m"] for _, o, _ in outs]),
                     "v": _stack([o["v"] for _, o, _ in outs]),
                     "step": outs[0][1]["step"]}
        return params, opt_state, new, {
            "loss": torch.stack(losses).sum() / peers, "grad_norm": outs[0][2]}

    return process_step if world is not None else stacked_step


def _interleave(rows_of_d: list) -> torch.Tensor:
    """Per data index d its (pods, size) rows -> (pods * dp, size) rows in
    peer order p = pod * dp + d."""
    dp = len(rows_of_d)
    return torch.stack(rows_of_d, dim=1).reshape(
        rows_of_d[0].shape[0] * dp, -1)


def _slice(tree: dict, d: int) -> dict:
    """Data index d's tree of a stacked state (views)."""
    return tree_map(lambda t: t[d], tree)


def _stack(trees: list) -> dict:
    """Per data index trees -> one tree of stacked leaves."""
    return tree_map(lambda *ts: torch.stack(ts), *trees)
