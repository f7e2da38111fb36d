"""``layers.lm_loss``'s sequence chunks, held against the JAX package's
chunked ``lm_loss`` on the CPU.

At t > 1024 JAX pads the sequence to a multiple of 1024 with a 0/1 mask
and scans the chunks under ``jax.checkpoint``: each chunk's masked mean
NLL times its token count is added to an f32 accumulator (XLA compiles
``acc + mean * count`` into one FMA), and the total is divided by the
count.  The port takes each chunk under ``torch.utils.checkpoint`` and
sums in that order and form.

What is held:

* that XLA contracts the scan's accumulation into an FMA (the form the
  port writes, ``layers.fma_round_once``), on a jitted scan of JAX's
  body, and that form against ``kernels.ref.fma_f32`` where the f64 sum
  falls on an f32 midpoint;
* ``lm_loss`` and its gradients (x and the head) against JAX's, jitted,
  at t 2500 (a ragged last chunk), 2048 (two whole chunks) and 1024 (one
  chunk, unchanged), at tp 1;
* the same at tp 2 with the head's vocabulary sharded over 'model': JAX
  on 2 host devices (per-device values of a shard_map, one module-scoped
  subprocess) against a 2-rank gloo world of the port;
* ``loss_fn`` of deepseek_v3_671b's SMOKE config (f32; its MTP term
  calls ``lm_loss`` a second time) at seq 2049 (the NLL over 2049
  tokens, the MTP's over 2048) and every gradient leaf against JAX's
  jitted ``loss_fn``.
"""
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

from repro.models import layers as jlayers
from test_torch_moe import _jax_loss_and_grads, cfg_pair
from test_torch_processes import _env, _free_port, _wait
from test_torch_zamba import assert_rel, jax_tp1
from repro_torch.kernels.ref import fma_f32
from repro_torch.models import layers
from repro_torch.models import lm as tlm
from repro_torch.models.layers import ShardCtx, fma_round_once
from repro_torch.tree import leaves, leaves_with_paths, unflatten

ROOT = Path(__file__).resolve().parents[1]
SEED = 71
B, D, V = 2, 32, 96
SEQS = (2500, 2048, 1024)
TP = 2
SPAWN_TIMEOUT_S = 240
# the loss (O(5)): f32 sums of 5000 NLL terms and of each row's 96
# exponentials in other orders; each gradient relative to its largest
# entry: the same softmax, reordered
LOSS_TOL = 1e-5
GRAD_RTOL = 1e-5
# loss_fn of the deepseek SMOKE model (test_torch_moe's limits)
MODEL_LOSS_TOL = 2e-5
MODEL_GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def inputs(t: int, seed: int = SEED):
    """x (B, t, D), head (D, V), targets (B, t): logits of O(1)."""
    rng = np.random.default_rng(seed + t)
    x = rng.standard_normal((B, t, D)).astype(np.float32)
    head = (rng.standard_normal((D, V)) * 0.3).astype(np.float32)
    return x, head, rng.integers(0, V, (B, t)).astype(np.int32)


def test_xla_accumulates_chunk_losses_with_an_fma():
    """JAX's scan body ``acc + mean * count`` jitted on the CPU: its
    totals are a * b + c rounded once, not the rounded product added,
    and the final quotient is a true division (not a product with the
    reciprocal).  The two forms differ on some of these 400 trials."""
    rng = np.random.default_rng(SEED)
    means = rng.uniform(1, 10, (400, 3)).astype(np.float32)
    counts = rng.integers(1, 2049, (400, 3)).astype(np.float32)

    def body(acc, ins):
        m, c = ins
        return (acc[0] + m * c, acc[1] + c), None

    @jax.jit
    def scan(m, c):
        (tot, cnt), _ = lax.scan(body, (0.0, 0.0), (m, c))
        return tot, tot / jnp.maximum(cnt, 1.0)

    got = [scan(means[i], counts[i]) for i in range(len(means))]
    tot = np.array([float(a) for a, _ in got], np.float32)
    loss = np.array([float(b) for _, b in got], np.float32)
    m, c = torch.from_numpy(means), torch.from_numpy(counts)
    fused = plain = torch.zeros(len(means))
    for k in range(3):
        fused = fma_round_once(m[:, k], c[:, k], fused)
        plain = plain + m[:, k] * c[:, k]
    np.testing.assert_array_equal(fused.numpy(), tot)
    assert (plain != fused).any()
    np.testing.assert_array_equal((fused / c.sum(1)).numpy(), loss)


def test_fma_round_once_matches_the_reference_fma():
    """``fma_round_once`` (branch-free, as ``lm_loss`` sums its chunks on
    the card) equals ``kernels.ref.fma_f32`` on random f32 triples and
    where the f64 sum falls on an f32 midpoint that the exact sum misses
    (there the f64 sum rounded to f32 is one spacing off)."""
    g = torch.Generator().manual_seed(SEED)
    n = 100_000
    a, b, c = (torch.randn(n, generator=g) for _ in range(3))
    b = b * torch.exp2(torch.randint(-30, 30, (n,), generator=g).float())
    for cc in (c, -(a * b)):
        torch.testing.assert_close(fma_round_once(a, b, cc),
                                   fma_f32(a, b, cc), rtol=0, atol=0)
    u = 2.0 ** -23
    a = torch.tensor([1 + u, -(1 + u), 1 + u])
    b = torch.tensor([2 ** -24 * (1 - u), 2 ** -24 * (1 - u),
                      -2 ** -24 * (1 - u)])
    c = torch.tensor([1 + u, -(1 + u), 1 + 3 * u])
    want = torch.tensor([1 + u, -(1 + u), 1 + 3 * u])
    naive = (a.double() * b.double() + c.double()).float()
    assert (naive != want).all()
    for got in (fma_round_once(a, b, c), fma_f32(a, b, c)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def port_loss_and_grads(x, head, tg, ctx=ShardCtx(), axes=None):
    xt = torch.from_numpy(x).requires_grad_()
    ht = torch.from_numpy(head).requires_grad_()
    loss = layers.lm_loss(xt, ht, torch.from_numpy(tg), ctx, axes)
    return (loss,) + torch.autograd.grad(loss, (xt, ht))


@pytest.mark.parametrize("t", SEQS)
def test_lm_loss_and_gradients_match_jax(t):
    """At tp 1: the port's loss within LOSS_TOL and its gradients
    within GRAD_RTOL of JAX's jitted lm_loss and value_and_grad."""
    x, head, tg = inputs(t)

    def f(x, head, tg):
        return jax.value_and_grad(lambda x, h: jlayers.lm_loss(
            ctx, x, h, tg), argnums=(0, 1))(x, head)
    call, ctx = jax_tp1(f)
    jloss, (jgx, jgh) = call(jnp.asarray(x), jnp.asarray(head),
                             jnp.asarray(tg))
    loss, gx, gh = port_loss_and_grads(x, head, tg)
    assert abs(loss.item() - float(jloss)) <= LOSS_TOL
    assert_rel(gx.numpy(), np.asarray(jgx), GRAD_RTOL, "dx")
    assert_rel(gh.numpy(), np.asarray(jgh), GRAD_RTOL, "dhead")


def test_short_sequences_keep_one_chunk():
    """At t <= 1024 lm_loss is the one-chunk mean, bit for bit; above it
    the chunked sum, which differs in the last bits from that mean."""
    x, head, tg = inputs(1024)
    args = [torch.from_numpy(a) for a in (x, head, tg)]
    assert torch.equal(layers.lm_loss(*args),
                       layers._chunk_nll(*args, None, ShardCtx(), None))
    x, head, tg = inputs(2500)
    args = [torch.from_numpy(a) for a in (x, head, tg)]
    one = layers.lm_loss(*args, chunk=10 ** 9)
    assert abs(layers.lm_loss(*args).item() - one.item()) <= LOSS_TOL


# ----------------------------------------------------------- tp 2
JAX_SCRIPT = textwrap.dedent('''
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro import compat  # noqa: F401
    from repro.api import MeshSpec
    from repro.launch import steps
    from repro.models import layers

    inp, out_path, tp = sys.argv[1], sys.argv[2], int(sys.argv[3])
    data = dict(np.load(inp))
    mesh = MeshSpec(tp=tp).build()
    ctx = steps.make_ctx(mesh)

    def f(x, head, tg):
        loss, (gx, gh) = jax.value_and_grad(lambda x, h: layers.lm_loss(
            ctx, x, h, tg), argnums=(0, 1))(x, head)
        return loss[None], gx[None], gh[None]
    fn = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P(), P(None, "model"), P()),
        out_specs=(P("model"),) * 3, check_vma=False))
    out = {}
    with jax.set_mesh(mesh):
        for t in json.loads(sys.argv[4]):
            loss, gx, gh = fn(*(jnp.asarray(data[f"{k}{t}"])
                                for k in ("x", "head", "tg")))
            out[f"loss{t}"], out[f"gx{t}"] = np.asarray(loss), np.asarray(gx)
            out[f"gh{t}"] = np.asarray(gh)
    np.savez(out_path, **out)
''')

RANK_MAIN = textwrap.dedent('''
    import datetime, json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch import distributed
    from repro_torch.models import layers
    from repro_torch.models.layers import ShardCtx, fma_round_once

    spec = json.loads(sys.argv[1])
    data = dict(np.load(spec["inputs"]))
    world = distributed.init(1, 1, spec["tp"], "cpu",
                             datetime.timedelta(seconds=200))
    m = world.coords[2]
    out = {}
    for t in spec["seqs"]:
        x = torch.from_numpy(data[f"x{t}"]).requires_grad_()
        head = torch.from_numpy(data[f"head{t}"])
        vl = head.shape[1] // spec["tp"]
        hs = head[:, m * vl:(m + 1) * vl].clone().requires_grad_()
        loss = layers.lm_loss(x, hs, torch.from_numpy(data[f"tg{t}"]),
                              ShardCtx(tp=spec["tp"]), world)
        gx, gh = torch.autograd.grad(loss, (x, hs))
        out[f"loss{t}"], out[f"gx{t}"] = loss.detach().numpy(), gx.numpy()
        out[f"gh{t}"] = gh.numpy()
    np.savez(os.path.join(spec["out"], f"rank{world.rank}.npz"), **out)
    distributed.shutdown()
    distributed.exit_rank(0)
''')


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """JAX's per-device lm_loss values on a (1, TP) mesh and the port's
    TP-rank gloo world on the same inputs, spawned together."""
    d = tmp_path_factory.mktemp("lm_loss")
    inp = {}
    for t in SEQS[:2]:
        for k, a in zip(("x", "head", "tg"), inputs(t, SEED + 1)):
            inp[f"{k}{t}"] = a
    np.savez(d / "in.npz", **inp)
    env = _env(XLA_FLAGS=f"--xla_force_host_platform_device_count={TP}")
    env.pop("OMP_NUM_THREADS")
    procs = {"jax": [subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(d / "in.npz"),
         str(d / "jax.npz"), str(TP), json.dumps(SEQS[:2])], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)]}
    port = _free_port()
    spec = {"inputs": str(d / "in.npz"), "out": str(d), "tp": TP,
            "seqs": SEQS[:2]}
    procs["gloo"] = [subprocess.Popen(
        [sys.executable, "-c", RANK_MAIN, json.dumps(spec)], cwd=ROOT,
        env=_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 WORLD_SIZE=str(TP), RANK=str(r), LOCAL_RANK=str(r),
                 LOCAL_WORLD_SIZE=str(TP)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True) for r in range(TP)]
    res = _wait(procs, time.time() + SPAWN_TIMEOUT_S)
    for name, group in res.items():
        for rc, log in group:
            assert rc == 0, f"{name}: {log[-4000:]}"
    return (dict(np.load(d / "jax.npz")),
            [dict(np.load(d / f"rank{r}.npz")) for r in range(TP)])


@pytest.mark.parametrize("t", SEQS[:2])
def test_lm_loss_at_tp2_matches_jax_per_device(tp_runs, t):
    """Each rank's loss and gradients (x's, and its head shard's)
    against JAX's device of the same 'model' index: the pmax, the psums
    of the exponentials' sums and the target logits inside each chunk,
    and their check_vma=False transposes in the backward."""
    jax_out, ranks = tp_runs
    for m, rank in enumerate(ranks):
        assert abs(float(rank[f"loss{t}"]) - float(jax_out[f"loss{t}"][m])
                   ) <= LOSS_TOL
        assert_rel(rank[f"gx{t}"], jax_out[f"gx{t}"][m], GRAD_RTOL, "dx")
        assert_rel(rank[f"gh{t}"], jax_out[f"gh{t}"][m], GRAD_RTOL, "dhead")


# -------------------------------------------------------- loss_fn
def test_loss_fn_at_seq_2049_matches_jax():
    """deepseek_v3 SMOKE in f32, one row of 2050 tokens: the NLL over
    2049 positions (three chunks, the last one token) plus 0.3 times the
    MTP's over 2048 (two whole chunks) and 0.01 aux, and every gradient
    leaf, against JAX's jitted loss_fn and value_and_grad."""
    jcfg, cfg = cfg_pair("deepseek_v3_671b")
    jparams = {}
    rng = np.random.default_rng(SEED + 2)
    for path, shp in leaves_with_paths(tlm.param_shapes(cfg)):
        node = jparams
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = (np.ones(shp, np.float32) if path[-1].endswith(
            "norm") else (rng.standard_normal(shp) * 0.05).astype(np.float32))
    tokens = rng.integers(0, cfg.vocab, (1, 2050))
    (jloss, jnll), jgrads = _jax_loss_and_grads(jcfg, jparams, tokens)
    params = tlm.params_from_jax(jparams, cfg, device="cpu")
    train = [t.requires_grad_() for t in leaves(params)]
    loss, aux = tlm.loss_fn(cfg, unflatten(params, train),
                            {"tokens": torch.from_numpy(tokens)})
    grads = torch.autograd.grad(loss, train)
    assert abs(loss.item() - jloss) <= MODEL_LOSS_TOL
    assert abs(aux["nll"].item() - jnll) <= MODEL_LOSS_TOL
    for (path, _), g in zip(leaves_with_paths(params), grads):
        want = jgrads
        for k in path:
            want = want[k]
        assert_rel(g.numpy(), want, MODEL_GRAD_RTOL, "/".join(path))
