"""The MoE family of the port on the CPU, held against the JAX package on
the same numpy-seeded inputs (weights carried across with
``params_from_jax``): phi35_moe_42b (GQA attention, 4 routed experts
top-2 at its SMOKE widths) and deepseek_v3_671b (MLA, a shared expert
and 8 routed experts top-2, a first dense layer and the MTP block), in
f32.

What is held:

* ``moe_block`` (output, aux loss and gradients), the MLA training
  branch and ``loss_fn`` with its gradients against JAX's at tp 1;
* three ``--sync optinc`` trainer steps against JAX's
  ``make_train_step``;
* the hazards: a MoE layer's one ``norm`` leaf, whose gradient sums its
  attention's and its MoE block's uses; ``lax.top_k``'s order among
  equal values (the expert-side top-C ties on every zero gate); the
  capacity in Python floats; the aux loss's gradient through the mean
  gates only;
* gloo worlds of (data, model) = (1, 2) and (2, 2) with FSDP: each
  rank's loss and local gradients against the JAX reference's per-device
  ones (one module-scoped JAX subprocess on 4 host devices), the
  reference's ``check_vma=False`` factor (every model-sharded leaf, the
  router and the routed experts included, gets tp times the tp-1
  gradient), and two trainer steps at (2, 2) + FSDP against JAX's and
  the port's stacked dp-2 run;
* the CLI trains both SMOKE configs as stacked peers.
"""
import dataclasses
import io
import json
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from repro import compat  # noqa: F401  (jax API shims)
from repro import configs as jconfigs
from repro.api import MeshSpec
from repro.collectives import SyncConfig as JaxSyncConfig
from repro.data import pipeline as jdata
from repro.launch import steps as jsteps
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from test_torch_processes import _env, _free_port, _wait
from repro_torch import api as tapi
from repro_torch.launch import train
from repro_torch.models import blocks
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ShardCtx
from repro_torch.tree import leaves, leaves_with_paths, set_path, unflatten

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["phi35_moe_42b", "deepseek_v3_671b"]
# test_torch_train's: the f32 loss (O(5)) of a few layers, each gradient
# leaf relative to its largest entry, and trainer losses over steps
LOSS_TOL = 2e-5
GRAD_RTOL = 1e-4
TRAIN_TOL = 2e-4
# test_torch_sharding's per-rank gradients against JAX's per-device ones
SHARD_GRAD_RTOL = 1e-5
SPAWN_TIMEOUT_S = 300
SEED = 5
BATCH, SEQ = 4, 32
# (dp, tp, fsdp) of the process meshes (one pod)
MESHES = {"1x2": (1, 2, False), "2x2_fsdp": (2, 2, True)}
TRAIN_MESH = "2x2_fsdp"
TRAIN_STEPS = 2
SYNC_KW = dict(mode="optinc", bits=8, block=128, error_feedback=True,
               bucket_bytes=1 << 16)
LR = 1e-3


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def cfg_pair(arch: str):
    """(JAX config, port config) of the arch's SMOKE config in f32."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype="float32")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def np_params(cfg, seed: int, ctx: ShardCtx = ShardCtx()) -> dict:
    """numpy params at JAX's padded global shapes: normal * 0.02, the
    router * 0.5 (routing that is not near uniform), norms 1."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, shp in leaves_with_paths(tlm.param_shapes(cfg, ctx)):
        if path[-1].endswith("norm"):
            a = np.ones(shp, np.float32)
        else:
            a = rng.standard_normal(shp).astype(np.float32) * (
                0.5 if path[-1] == "router" else 0.02)
        set_path(out, path, a)
    return out


def to_torch(tree) -> dict:
    return unflatten(tree, [torch.from_numpy(np.array(a))
                            for a in leaves(tree)])


def layer0(tree: dict, stack: str) -> dict:
    return {k: v[0] for k, v in tree[stack].items()}


def jax_tp1(fn):
    """fn in a shard_map over a 1-device (data, model) mesh, jitted: the
    JAX blocks need the 'model' axis.  Returns (call, ctx)."""
    mesh = MeshSpec().build()
    sm = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P(), out_specs=P(),
                               check_vma=False))

    def call(*args):
        with jax.set_mesh(mesh):
            return sm(*args)
    return call, jsteps.make_ctx(mesh)


def assert_rel(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                               err_msg=what)


# ----------------------------------------------------------- the blocks
def _block_pair(arch, which):
    """(JAX config, port config, the block's layer-0 params, x, a
    cotangent), numpy: ``which`` = "moe" (moe_block's leaves of a MoE
    layer) or "mla" (mla_attention's of deepseek's dense layer)."""
    jcfg, cfg = cfg_pair(arch)
    stack = "moe_layers" if which == "moe" else "dense_layers"
    specs = tlm.moe_param_specs if which == "moe" else tlm.mla_param_specs
    keys = specs(cfg, ShardCtx(), tlm.ArchDims.build(cfg))[1]
    p = {k: v for k, v in layer0(np_params(cfg, SEED), stack).items()
         if k in keys}
    rng = np.random.default_rng(SEED + 1)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, p, x, w


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_jax(arch):
    """moe_block's output, aux loss, and the gradients of sum(out * w) +
    aux with respect to every leaf and x, against JAX's at tp 1 (48
    tokens: every expert gets fewer than its capacity, so the
    expert-side top-C ties on the zero gates)."""
    jcfg, cfg, p, x, w = _block_pair(arch, "moe")

    def jf(p, x, w):
        def f(p, x):
            out, aux = jblocks.moe_block(ctx, jcfg, p, x)
            return jnp.sum(out * w) + aux, (out, aux)
        (_, (out, aux)), g = jax.value_and_grad(f, argnums=(0, 1),
                                                has_aux=True)(p, x)
        return out, aux, g
    call, ctx = jax_tp1(jf)
    jout, jaux, (jgp, jgx) = call(p, jnp.asarray(x), jnp.asarray(w))

    tp = {k: v.requires_grad_() for k, v in to_torch(p).items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = blocks.moe_block(cfg, tp, tx)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum() + aux,
                                [tx, *tp.values()])
    assert_rel(out.detach().numpy(), jout, SHARD_GRAD_RTOL, "out")
    assert abs(aux.item() - float(jaux)) <= LOSS_TOL
    assert_rel(grads[0].numpy(), jgx, GRAD_RTOL, "dx")
    for (k, _), g in zip(tp.items(), grads[1:]):
        assert_rel(g.numpy(), jgp[k], GRAD_RTOL, k)


def test_mla_training_branch_matches_jax():
    """deepseek_v3 SMOKE's MLA block (QK head dim 16 + 8 rope dims, V 16)
    through the flash autograd function's plain route: output and the
    gradients of sum(out * w) against JAX's training branch, and the
    compressed cache it also returns (which prefill collects) against
    JAX's: the scales and the rope keys within SHARD_GRAD_RTOL, the int8
    codes equal but where the two quotients straddle a rounding edge."""
    jcfg, cfg, p, x, w = _block_pair("deepseek_v3_671b", "mla")
    pos = np.arange(x.shape[1])

    def jf(p, x, w):
        f = lambda p, x: jnp.sum(jblocks.mla_attention(
            ctx, jcfg, p, x, jnp.asarray(pos))[0] * w)
        return (jblocks.mla_attention(ctx, jcfg, p, x, jnp.asarray(pos)),
                jax.grad(f, argnums=(0, 1))(p, x))
    call, ctx = jax_tp1(jf)
    (jout, jcache), (jgp, jgx) = call(p, jnp.asarray(x), jnp.asarray(w))

    tp = {k: v.requires_grad_() for k, v in to_torch(p).items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, cache = blocks.mla_attention(cfg, tp, tx, torch.from_numpy(pos))
    assert sorted(cache) == sorted(jcache)
    for k in ("scale", "krope"):
        assert_rel(cache[k].detach().numpy(), jcache[k], SHARD_GRAD_RTOL, k)
    codes = cache["ckv"].numpy()
    assert codes.dtype == np.int8
    assert (codes != np.asarray(jcache["ckv"])).mean() < 1e-3
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                [tx, *tp.values()])
    assert_rel(out.detach().numpy(), jout, SHARD_GRAD_RTOL, "out")
    assert_rel(grads[0].numpy(), jgx, GRAD_RTOL, "dx")
    for (k, _), g in zip(tp.items(), grads[1:]):
        assert_rel(g.numpy(), jgp[k], GRAD_RTOL, k)


# -------------------------------------------------------- the hazards
@pytest.mark.parametrize("case", ["zeros", "planted", "all_equal"])
def test_top_k_orders_ties_as_lax_top_k(case):
    """blocks.top_k gives lax.top_k's values and indices, the lower index
    first among equal values: the expert-side top-C over (El, T) gates
    with zeros wherever an expert was not chosen, planted equal gates,
    and a row of one value."""
    rng = np.random.default_rng(7)
    x = rng.random((4, 40)).astype(np.float32)
    if case == "zeros":
        x[rng.random(x.shape) < 0.7] = 0.0
    elif case == "planted":
        x = np.round(x * 4) / 4               # five distinct values
    else:
        x[:] = 0.25
    for k in (1, 5, 31, 40):
        want_v, want_i = lax.top_k(jnp.asarray(x), k)
        got_v, got_i = blocks.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_moe_block_with_tied_router_logits_matches_jax():
    """Zero router columns for experts 2 and 3 give every token two
    exactly equal gates: the router's top-2 and the experts' top-C both
    break the ties by the lower index, as JAX does, so the output and
    the gradients are JAX's."""
    jcfg, cfg, p, x, w = _block_pair("phi35_moe_42b", "moe")
    p["router"][:, 2:] = 0.0
    gates = torch.softmax(torch.from_numpy(blocks.rmsnorm(
        torch.from_numpy(x), torch.from_numpy(p["norm"])).numpy().reshape(
        -1, cfg.d_model) @ p["router"]), -1)
    assert torch.equal(gates[:, 2], gates[:, 3])

    def jf(p, x, w):
        def f(p, x):
            out, aux = jblocks.moe_block(ctx, jcfg, p, x)
            return jnp.sum(out * w) + aux, out
        (_, out), g = jax.value_and_grad(f, has_aux=True)(p, x)
        return out, g
    call, ctx = jax_tp1(jf)
    jout, jg = call(p, jnp.asarray(x), jnp.asarray(w))
    tp = {k: v.requires_grad_() for k, v in to_torch(p).items()}
    out, aux = blocks.moe_block(cfg, tp, torch.from_numpy(x))
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum() + aux,
                                list(tp.values()))
    assert_rel(out.detach().numpy(), jout, SHARD_GRAD_RTOL, "out")
    for (k, _), g in zip(tp.items(), grads):
        assert_rel(g.numpy(), jg[k], GRAD_RTOL, k)


@pytest.mark.parametrize("arch,n_tok,want", [
    ("phi35_moe_42b", 4096, 641), ("phi35_moe_42b", 48, 31),
    ("deepseek_v3_671b", 48, 16), ("deepseek_v3_671b", 20, 7),
    ("deepseek_v3_671b", 1, 1)])
def test_capacity_is_jaxs_python_float_arithmetic(arch, n_tok, want):
    """cap = min(int(T k / E cf) + 1, T), left to right in Python floats
    (phi35 at its published widths: 16 experts top-2, 641 tokens of a
    4096-token sequence)."""
    cfg = (tapi.RunSpec(arch=arch).model_config() if n_tok == 4096
           else cfg_pair(arch)[1])
    cap = int(n_tok * cfg.top_k / cfg.n_experts * cfg.capacity_factor) + 1
    assert blocks.capacity(cfg, n_tok) == min(cap, n_tok) == want


def test_aux_loss_gradient_is_jaxs_and_flows_through_the_gates_only():
    """The switch aux loss E sum(mean(gates) mean(full > 0)): its gradient
    alone against JAX's; the routed experts get none; and mean(full > 0)
    carries none (holding it constant leaves the router's gradient as
    it is)."""
    jcfg, cfg, p, x, _ = _block_pair("deepseek_v3_671b", "moe")

    def jf(p, x):
        return jax.grad(lambda p: jblocks.moe_block(ctx, jcfg, p, x)[1])(p)
    call, ctx = jax_tp1(jf)
    jg = call(p, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in to_torch(p).items()}
    tx = torch.from_numpy(x)
    _, aux = blocks.moe_block(cfg, tp, tx)
    grads = dict(zip(tp, torch.autograd.grad(aux, list(tp.values()),
                                             allow_unused=True)))
    for k in ("w_gate", "w_up", "w_down", "sh_gate", "sh_up", "sh_down"):
        assert grads[k] is None or not grads[k].any(), k
        assert not np.abs(np.asarray(jg[k])).max(), k
    for k in ("router", "norm"):
        assert_rel(grads[k].numpy(), jg[k], GRAD_RTOL, k)
    # mean(full > 0) held as a constant: the same router gradient
    h = blocks.rmsnorm(tx, tp["norm"]).reshape(-1, cfg.d_model)
    logits = (h @ tp["router"]).float()
    gates = torch.softmax(logits, -1)
    _, top_e = blocks.top_k(gates, cfg.top_k)
    ce = torch.zeros_like(gates).scatter(1, top_e, 1.0).mean(0)
    const = cfg.n_experts * (gates.mean(0) * ce).sum()
    g2 = torch.autograd.grad(const, tp["router"])[0]
    torch.testing.assert_close(g2, grads["router"], rtol=0, atol=1e-6)


def test_a_moe_layer_has_one_norm_whose_gradient_sums_both_uses():
    """JAX merges the attention and MoE specs of a layer, so the layer
    has ONE norm leaf used by both blocks: the port keeps one leaf, and
    its gradient is the sum of the gradients of two copies, one given to
    each block; the whole loss's gradient of it is JAX's."""
    jcfg, cfg = cfg_pair("phi35_moe_42b")
    shapes = tlm.param_shapes(cfg)
    _, jshapes = jlm.param_specs(jcfg, jsteps.make_ctx(MeshSpec().build()))
    assert shapes == jshapes
    assert [k for k in shapes["moe_layers"] if k.endswith("norm")] == [
        "norm"]
    p = to_torch(layer0(np_params(cfg, SEED), "moe_layers"))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model)).astype(
        np.float32))
    pos = torch.arange(16)

    def layer(p_attn, p_moe):
        a, _ = blocks.gqa_attention(cfg, p_attn, x, pos)
        y, aux = blocks.moe_block(cfg, p_moe, x + a)
        return ((x + a + y) * w).sum() + aux

    one = p["norm"].clone().requires_grad_()
    g = torch.autograd.grad(layer({**p, "norm": one}, {**p, "norm": one}),
                            one)[0]
    na, nm = (p["norm"].clone().requires_grad_() for _ in range(2))
    ga, gm = torch.autograd.grad(layer({**p, "norm": na},
                                       {**p, "norm": nm}), (na, nm))
    assert ga.abs().max() > 0 and gm.abs().max() > 0
    torch.testing.assert_close(g, ga + gm, rtol=0, atol=1e-5)
    # the whole loss's gradient of the leaf, against JAX's
    jp = np_params(cfg, SEED)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (2, 17))
    want = _jax_loss_and_grads(jcfg, jp, tokens)[1]["moe_layers"]["norm"]
    tparams = tlm.params_from_jax(jp, cfg, device="cpu")
    train_ = [t.requires_grad_() for t in leaves(tparams)]
    loss, _ = tlm.loss_fn(cfg, unflatten(tparams, train_),
                          {"tokens": torch.from_numpy(tokens)})
    got = dict(zip([p for p, _ in leaves_with_paths(tparams)],
                   torch.autograd.grad(loss, train_)))[("moe_layers", "norm")]
    assert_rel(got.numpy(), want, GRAD_RTOL, "moe_layers/norm")


# --------------------------------------------------- the loss, training
def _jax_loss_and_grads(jcfg, params, tokens):
    mesh = MeshSpec().build()
    ctx = jsteps.make_ctx(mesh)
    specs = jlm.flat_specs(jcfg, ctx)

    def f(p, t):
        return jax.value_and_grad(lambda p: jlm.loss_fn(
            jcfg, ctx, p, {"tokens": t}), has_aux=True)(p)
    fn = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(specs, P()),
                               out_specs=((P(), {"nll": P()}), specs),
                               check_vma=False))
    with jax.set_mesh(mesh):
        (loss, aux), grads = fn(jax.tree.map(jnp.asarray, params),
                                jnp.asarray(tokens, jnp.int32))
    return (float(loss), float(aux["nll"])), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("arch,n_layers", [("phi35_moe_42b", None),
                                           ("deepseek_v3_671b", None),
                                           ("deepseek_v3_671b", 1)])
def test_loss_and_gradients_match_jax(arch, n_layers):
    """loss_fn (the NLL, the MTP term for deepseek, 0.01 aux) and the
    gradient of every leaf against JAX's loss_fn, from JAX's own seeded
    init_params; deepseek's depth also cut to its dense layer, where the
    MoE stack has no layer (zero-size leaves, zero gradients)."""
    jcfg, cfg = cfg_pair(arch)
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    jparams = jax.tree.map(np.asarray, jlm.init_params(
        jcfg, jsteps.make_ctx(MeshSpec().build()), jax.random.PRNGKey(2)))
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (3, 41))
    (jloss, jnll), jgrads = _jax_loss_and_grads(jcfg, jparams, tokens)
    params = tlm.params_from_jax(jparams, cfg, device="cpu")
    train_ = [t.requires_grad_() for t in leaves(params)]
    loss, aux = tlm.loss_fn(cfg, unflatten(params, train_),
                            {"tokens": torch.from_numpy(tokens)})
    grads = torch.autograd.grad(loss, train_)
    assert abs(loss.item() - jloss) <= LOSS_TOL
    assert abs(aux["nll"].item() - jnll) <= LOSS_TOL
    # the aux term is there, but for a model with no MoE layer
    assert (loss.item() != aux["nll"].item()) == (n_layers is None)
    for (path, _), g in zip(leaves_with_paths(params), grads):
        want = jgrads
        for k in path:
            want = want[k]
        assert g.shape == want.shape, path
        if not want.size:                   # an empty MoE stack
            continue
        assert np.abs(want).max() > 0, path
        assert_rel(g.numpy(), want, GRAD_RTOL, str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_matches_jax_make_train_step(arch):
    """Three --sync optinc --bits 8 steps of the port's trainer at --mesh
    1x1 against JAX's make_train_step on a 1-device mesh, the same
    weights and tokens, error feedback on."""
    jcfg, cfg = cfg_pair(arch)
    jparams = jlm.init_params(jcfg, jsteps.make_ctx(MeshSpec().build()),
                              jax.random.PRNGKey(0))
    argv = ["--device", "cpu", "--arch", arch, "--smoke-config", "--sync",
            "optinc", "--mesh", "1x1", "--steps", "3", "--lr", "1e-3",
            "--global-batch", "4", "--seq-len", "32", "--bucket-mb", "0.0625",
            "--block", "128", "--error-feedback"]
    recs = train.run(train.parse_args(argv), cfg=cfg, out=io.StringIO(),
                     params=tlm.params_from_jax(
                         jax.tree.map(np.asarray, jparams), cfg,
                         device="cpu"))
    mesh = MeshSpec().build()
    sync = JaxSyncConfig(mode="optinc", axes=("data",), bits=8, block=128,
                         error_feedback=True, bucket_bytes=2 ** 16)
    opt = jadamw.AdamWConfig(lr=1e-3)
    fn = jax.jit(jsteps.make_train_step(jcfg, mesh, sync, opt)[0])
    params, ostate = jparams, jadamw.adamw_init(opt, jparams)
    sstate = jsteps.init_sync_state(jcfg, mesh, sync)
    data = jdata.SyntheticLM(jdata.DataConfig(vocab=jcfg.vocab, seq_len=32,
                                              global_batch=4, seed=0))
    want = []
    with jax.set_mesh(mesh):
        for step in range(3):
            params, ostate, sstate, metrics = fn(
                params, ostate, sstate,
                {"tokens": jnp.asarray(data.batch(step))},
                jax.random.PRNGKey(step))
            want.append(float(metrics["loss"]))
    got = [r["loss"] for r in recs]
    np.testing.assert_allclose(got, want, rtol=0, atol=TRAIN_TOL)
    assert got[-1] < got[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_the_smoke_config_as_stacked_peers(arch, capsys):
    """python -m repro_torch.launch.train --arch <moe> --smoke-config
    --sync optinc --mesh 2x1 --device cpu: finite losses that fall."""
    assert train.main(["--device", "cpu", "--arch", arch, "--smoke-config",
                       "--sync", "optinc", "--mesh", "2x1", "--steps", "6",
                       "--global-batch", "4", "--seq-len", "32", "--lr",
                       "3e-3"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    losses = [r["loss"] for r in recs]
    assert [r["step"] for r in recs] == list(range(6))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


# ---------------------------------------------- processes (gloo ranks)
JAX_SCRIPT = textwrap.dedent('''
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import compat  # noqa: F401
    from repro import configs
    from repro.api import MeshSpec
    from repro.collectives import SyncConfig
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.launch import steps as js
    from repro.models import lm
    from repro.optim import AdamWConfig, adamw_init

    inp = dict(np.load(sys.argv[1]))
    spec = json.loads(sys.argv[3])
    out = {}

    def tree(prefix):
        t = {}
        for k, v in inp.items():
            if k.startswith(prefix):
                node = t
                parts = k[len(prefix):].split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = jnp.asarray(v)
        return t

    def put(mesh, specs, t):
        return jax.tree.map(lambda a, s: jax.device_put(
            a, NamedSharding(mesh, s)), t, specs,
            is_leaf=lambda x: isinstance(x, P))

    for arch in spec["archs"]:
        cfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32")
        for name, (dp, tp, fsdp) in spec["meshes"].items():
            ms = MeshSpec(dp=dp, tp=tp, fsdp=fsdp)
            mesh, ctx = ms.build(), ms.ctx()
            specs = lm.flat_specs(cfg, ctx)
            dev = jax.tree.map(lambda _: P(tuple(mesh.axis_names)), specs,
                               is_leaf=lambda x: isinstance(x, P))

            def f(p, t):
                (loss, _), g = jax.value_and_grad(
                    lambda p: lm.loss_fn(cfg, ctx, p, {"tokens": t}),
                    has_aux=True)(p)
                return loss[None], jax.tree.map(lambda x: x[None], g)
            fn = jax.jit(jax.shard_map(
                f, mesh=mesh, in_specs=(specs, P(ctx.dp_axes, None)),
                out_specs=(P(tuple(mesh.axis_names)), dev),
                check_vma=False))
            loss, grads = fn(put(mesh, specs, tree(f"{arch}/params/")),
                             jnp.asarray(inp[f"{arch}/tokens"]))
            out[f"{arch}/{name}/loss"] = np.asarray(loss)
            for path, a in jax.tree_util.tree_leaves_with_path(grads):
                key = "/".join(p.key for p in path)
                out[f"{arch}/{name}/grads/{key}"] = np.asarray(a)
            if name != spec["train_mesh"]:
                continue
            scfg = SyncConfig(axes=("data",), **spec["sync_kw"])
            opt = AdamWConfig(lr=spec["lr"])
            step = jax.jit(js.make_train_step(cfg, mesh, scfg, opt,
                                              fsdp=fsdp)[0])
            params = put(mesh, specs, tree(f"{arch}/params/"))
            ostate = put(mesh, js.opt_specs(specs), adamw_init(opt, params))
            sstate = put(mesh, js.sync_state_specs(mesh, scfg),
                         js.init_sync_state(cfg, mesh, scfg, fsdp=fsdp))
            data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=spec["seq"],
                                          global_batch=spec["batch"],
                                          seed=spec["seed"]))
            for i in range(spec["steps"]):
                params, ostate, sstate, m = step(
                    params, ostate, sstate,
                    {"tokens": jnp.asarray(data.batch(i))},
                    jax.random.PRNGKey(i))
                out[f"{arch}/train/loss{i}"] = np.asarray(m["loss"])
    np.savez(sys.argv[2], **out)
''')

RANK_MAIN = textwrap.dedent('''
    import dataclasses, datetime, json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from repro_torch import api
    from repro_torch.configs import get_smoke
    from repro_torch.launch import distributed
    from repro_torch.models import lm
    from repro_torch.models.layers import ShardCtx
    from repro_torch.tree import leaves, leaves_with_paths, unflatten

    spec = json.loads(sys.argv[1])
    inp = dict(np.load(spec["inputs"]))
    dp, tp, fsdp = spec["mesh"]
    world = distributed.init(1, dp, tp, "cpu",
                             datetime.timedelta(seconds=240))
    _, d, m = world.coords
    out = {}

    def tree(prefix):
        t = {}
        for k, v in inp.items():
            if k.startswith(prefix):
                node = t
                parts = k[len(prefix):].split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = v
        return t

    for arch in spec["archs"]:
        cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
        ctx = ShardCtx(tp=tp, dp=dp, fsdp=fsdp)
        params = lm.params_from_jax(tree(f"{arch}/params/"), cfg, "cpu",
                                    ctx, world.coords)
        tokens = torch.from_numpy(inp[f"{arch}/tokens"])
        per = tokens.shape[0] // dp
        train = [t.requires_grad_() for t in leaves(params)]
        loss, _ = lm.loss_fn(cfg, unflatten(params, train),
                             {"tokens": tokens[d * per:(d + 1) * per]},
                             ctx, world)
        grads = torch.autograd.grad(loss, train)
        out[f"{arch}/loss"] = loss.detach().numpy()
        for (path, _), g in zip(leaves_with_paths(params), grads):
            out[f"{arch}/grads/" + "/".join(path)] = g.numpy()
        if not spec.get("train"):
            continue
        s = api.RunSpec.from_json_dict({**spec["train"], "arch": arch})
        g = tree(f"{arch}/params/")
        sess = api.TrainSession(s, callbacks=[], device="cpu", cfg=cfg,
                                params=unflatten(g, [torch.from_numpy(a)
                                                     for a in leaves(g)]))
        sess.run()
        out[f"{arch}/train/losses"] = np.array(
            [sess.losses[i] for i in range(s.steps)])
    np.savez(os.path.join(spec["out"], f"rank{world.rank}.npz"), **out)
    distributed.shutdown()
    distributed.exit_rank(0)
''')


def _train_spec(dp, tp, fsdp) -> dict:
    return dict(smoke=True, steps=TRAIN_STEPS, optim=dict(lr=LR),
                data=dict(vocab=0, seq_len=SEQ, global_batch=BATCH,
                          seed=SEED),
                sync=SYNC_KW, mesh=dict(dp=dp, tp=tp, fsdp=fsdp))


def _spawn(spec: dict, n: int) -> list:
    port = _free_port()
    procs = []
    for r in range(n):
        env = _env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(n), RANK=str(r), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(n))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_MAIN, json.dumps(spec)], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, start_new_session=True))
    return procs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX reference (4 host devices, one subprocess) and the port's
    gloo worlds of each mesh, spawned together."""
    d = tmp_path_factory.mktemp("moe")
    inp = {}
    for arch in ARCHS:
        cfg = cfg_pair(arch)[1]
        for path, a in leaves_with_paths(np_params(cfg, SEED)):
            inp[f"{arch}/params/" + "/".join(path)] = a
        inp[f"{arch}/tokens"] = np.random.default_rng(SEED).integers(
            0, cfg.vocab, (BATCH, SEQ + 1)).astype(np.int32)
    np.savez(d / "in.npz", **inp)
    jspec = {"archs": ARCHS, "meshes": MESHES, "train_mesh": TRAIN_MESH,
             "sync_kw": SYNC_KW, "lr": LR, "seq": SEQ, "batch": BATCH,
             "seed": SEED, "steps": TRAIN_STEPS}
    env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env.pop("OMP_NUM_THREADS")
    procs = {"jax": [subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(d / "in.npz"),
         str(d / "jax_out.npz"), json.dumps(jspec)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)]}
    for name, (dp, tp, fsdp) in MESHES.items():
        (d / name).mkdir()
        procs[name] = _spawn({
            "inputs": str(d / "in.npz"), "out": str(d / name),
            "mesh": (dp, tp, fsdp), "archs": ARCHS,
            "train": (_train_spec(dp, tp, fsdp) if name == TRAIN_MESH
                      else None)}, dp * tp)
    res = _wait(procs, time.time() + SPAWN_TIMEOUT_S)
    for name, group in res.items():
        for rc, log in group:
            assert rc == 0, f"{name}: {log[-4000:]}"
    ranks = {name: [dict(np.load(d / name / f"rank{r}.npz"))
                    for r in range(dp * tp)]
             for name, (dp, tp, fsdp) in MESHES.items()}
    return dict(inp=inp, jax=dict(np.load(d / "jax_out.npz")), ranks=ranks)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_gradients_match_jax_per_device(runs, arch, mesh):
    """Each rank's loss and local gradients (the experts sharded on their
    expert axis over 'model', FSDP shards reduce-scattered over 'data')
    against the JAX reference's device of the same mesh coordinates."""
    jout = runs["jax"]
    for r, rank in enumerate(runs["ranks"][mesh]):
        assert abs(float(rank[f"{arch}/loss"])
                   - float(jout[f"{arch}/{mesh}/loss"][r])) <= LOSS_TOL
        keys = [k for k in rank if k.startswith(f"{arch}/grads/")]
        assert len(keys) == len(leaves(tlm.param_shapes(cfg_pair(arch)[1])))
        for k in keys:
            want = jout[k.replace(f"{arch}/grads/",
                                  f"{arch}/{mesh}/grads/")][r]
            assert rank[k].shape == want.shape, k
            assert_rel(rank[k], want, SHARD_GRAD_RTOL, f"rank {r} {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_model_sharded_gradients_are_tp_times_the_tp1_ones(runs, arch):
    """The reference's check_vma=False transposes, pinned at tp 2: every
    model-sharded leaf (router, routed experts, shared expert, attention,
    vocabulary) has 2x the tp-1 gradient's shard on each model rank;
    the router's logits are all-gathered over 'model', and the gather's
    reduce-scatter transpose sums the two ranks' equal cotangents."""
    _, cfg = cfg_pair(arch)
    params = tlm.params_from_jax(_tree(runs["inp"], f"{arch}/params/"),
                                 cfg, device="cpu")
    train_ = [t.requires_grad_() for t in leaves(params)]
    loss, _ = tlm.loss_fn(cfg, unflatten(params, train_), {
        "tokens": torch.from_numpy(runs["inp"][f"{arch}/tokens"])})
    one = torch.autograd.grad(loss, train_)
    ctx = ShardCtx(tp=2)
    names = set()
    for (path, _), g1, sp in zip(leaves_with_paths(params), one,
                                 tlm.spec_leaves(cfg, ctx)):
        if "model" not in sp:
            continue
        names.add(path[-1])
        for m, rank in enumerate(runs["ranks"]["1x2"]):
            want = 2 * tlm.shard_leaf(g1, sp, ctx, (0, 0, m))
            assert_rel(rank[f"{arch}/grads/" + "/".join(path)],
                       want.numpy(), SHARD_GRAD_RTOL, str(path))
    assert {"router", "w_gate", "w_up", "w_down"} <= names


def _tree(flat: dict, prefix: str) -> dict:
    out = {}
    for k, v in flat.items():
        if k.startswith(prefix):
            set_path(out, tuple(k[len(prefix):].split("/")), v)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_tp_trainer_matches_jax_and_the_stacked_run(runs, arch):
    """Two --sync optinc --bits 8 --error-feedback steps on the (2, 2) +
    FSDP gloo world: every rank reports JAX's make_train_step losses on
    that mesh, and step 0's loss is the stacked dp-2 (tp 1) run's."""
    jout = runs["jax"]
    want = [float(jout[f"{arch}/train/loss{i}"])
            for i in range(TRAIN_STEPS)]
    for rank in runs["ranks"][TRAIN_MESH]:
        np.testing.assert_allclose(rank[f"{arch}/train/losses"], want,
                                   rtol=0, atol=TRAIN_TOL)
    _, cfg = cfg_pair(arch)
    g = _tree(runs["inp"], f"{arch}/params/")
    spec = tapi.RunSpec.from_json_dict({**_train_spec(2, 1, False),
                                        "arch": arch, "steps": 1})
    sess = tapi.TrainSession(spec, callbacks=[], device="cpu", cfg=cfg,
                             params=to_torch(g))
    sess.run()
    assert abs(sess.losses[0] - runs["ranks"][TRAIN_MESH][0][
        f"{arch}/train/losses"][0]) <= LOSS_TOL


# ------------------------------------------------- specs and the steps
@pytest.mark.parametrize("pods,dp,tp,fsdp", [(1, 1, 1, False),
                                             (1, 1, 2, False),
                                             (1, 2, 2, True),
                                             (2, 2, 1, True)])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_local_sizes_and_readiness_are_jaxs(arch, pods, dp, tp, fsdp):
    """The MoE trees' specs (the experts on 'model', FSDP on the axes
    JAX's specs name), padded global shapes, sorted leaf order, local
    leaf sizes, FSDP masks and the overlap's readiness ranks are JAX's."""
    from repro.models.layers import ShardCtx as JCtx
    jcfg, cfg = cfg_pair(arch)
    jctx = JCtx(tp=tp, dp=dp, pods=pods, fsdp=fsdp)
    ctx = ShardCtx(tp=tp, dp=dp, pods=pods, fsdp=fsdp)
    jspecs, jshapes = jlm.param_specs(jcfg, jctx)
    specs, shapes = tlm.param_specs(cfg, ctx)
    assert shapes == jshapes
    want = jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(x, P))
    assert [tuple(s) for s in leaves(specs)] == [tuple(s) for s in want]
    assert [p for p, _ in leaves_with_paths(shapes)] == [
        tuple(k.key for k in path) for path, _ in
        jax.tree_util.tree_flatten_with_path(
            jshapes, is_leaf=lambda x: isinstance(x, tuple))[0]]
    from repro_torch.launch import steps as tsteps
    sizes, masks = tsteps._local_leaf_sizes(cfg, ctx)

    class Mesh:
        axis_names = ("pod", "data", "model")
        devices = np.empty((pods, dp, tp))
    assert (sizes, masks) == jsteps._local_leaf_sizes(jcfg, jctx, Mesh)
    rep = [i for i, m in enumerate(masks) if not m]
    assert tsteps.grad_readiness(rep, len(masks)) == jsteps.grad_readiness(
        rep, len(masks))


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_fsdp_run_matches_the_unsharded_run(arch):
    """--fsdp with 2 stacked data peers (the state every data index's
    shards; the FSDP leaves' gradients summed in data order and halved)
    against the unsharded 2-peer run of the same weights and tokens,
    --sync psum, two steps: the losses within the trainer tolerance."""
    _, cfg = cfg_pair(arch)
    g = np_params(cfg, SEED)
    losses = []
    for fsdp in (False, True):
        spec = tapi.RunSpec.from_json_dict({
            **_train_spec(2, 1, fsdp), "arch": arch,
            "sync": dict(mode="psum", bucket_bytes=1 << 16)})
        sess = tapi.TrainSession(spec, callbacks=[], device="cpu", cfg=cfg,
                                 params=to_torch(g))
        sess.run()
        losses.append([sess.losses[i] for i in range(TRAIN_STEPS)])
    np.testing.assert_allclose(losses[1], losses[0], rtol=0, atol=TRAIN_TOL)
    assert losses[1][1] != losses[1][0]
