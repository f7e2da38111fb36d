"""ServeSession's contiguous serving path for the encoder-decoder family
(whisper_tiny), held against the JAX package on the CPU at its SMOKE
widths in f32 (2 encoder and 2 decoder layers, d 64, 2 heads of 32, 32
frames), with the same numpy-seeded weights (``params_from_jax``),
prompts and ``enc_frames``.  One module-scoped JAX oracle (its
ServeSession and a jitted ``gqa_attention``) computes every reference.

What is held:

* the prefill (the encoder over the frames; each decoder layer's causal
  self-attention, MLP and cross-attention over e @ x_wk, e @ x_wv): the
  logits, the self cache (8 long) and the cross cache (32 long) against
  JAX's ServeSession.prefill;
* one ``decode_step`` from the prefill's cache seeded into a 32-long
  one: the logits, the self cache written at the position and the cross
  cache returned as it is;
* ``generate``'s tokens at ``max_seq`` 32 (the frame count: no zero
  column) and 64 (the decode's cross-attention weighs 32 zero columns,
  as the reference's does, and the tokens are JAX's there too), and the
  raise at ``max_seq`` 12 in both packages (the cross cache is longer
  than the decode cache);
* ``blocks.cross_decode`` (the paged kernel's plain version over the
  cross cache as b pages of S positions, every row at length S) against
  JAX's ``gqa_attention(kv_ext=...)`` at t 1, over a cache whose last
  columns are zero, with and without qk-norm;
* the session's refusals of a missing ``enc_frames`` and of
  ``enc_frames`` given to a family without an encoder.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import compat  # noqa: F401  (jax API shims)
from repro.models import blocks as jblocks
from test_torch_serve_families import cfg_pair, np_params
from test_torch_zamba import assert_rel, jax_tp1, to_torch
from repro_torch import api as tapi
from repro_torch.api import build
from repro_torch.models import blocks
from repro_torch.models import lm as tlm
from repro_torch.tree import leaves_with_paths

ARCH = "whisper_tiny"
SEED = 53
# logits relative to their largest entry, and every cache leaf relative
# to its own: f32 sums reordered between XLA and torch (the decode's
# cross-attention: JAX's blocked online softmax, the port's gather math)
LOGIT_RTOL = 1e-4
STATE_RTOL = 1e-5
# generate's tokens are held up to the first position whose
# teacher-forced top-2 margin is thinner than this (phase 5's rule)
LOGIT_TOL = 1e-3
B, T, NEW = 2, 8, 4          # prompts, prompt length, new tokens
MAX_SEQS = (32, 64)          # the frame count, and twice it


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def inputs(cfg):
    """(weights, prompts (B, T), enc_frames (B, frames, d)) from SEED."""
    rng = np.random.default_rng(SEED + 1)
    prompts = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    frames = rng.standard_normal((B, cfg.enc_frames, cfg.d_model)).astype(
        np.float32)
    return np_params(cfg, SEED), prompts, frames


@pytest.fixture(scope="module")
def oracle():
    """JAX's ServeSession on the f32 SMOKE config and the weights of
    ``inputs``: the prefill, one decode step from the prefill's cache
    seeded into a 32-long one, generate at MAX_SEQS, and whether
    generate at max_seq 12 raises."""
    jcfg, cfg = cfg_pair(ARCH)
    p, prompts, frames = inputs(cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(japi.RunSpec, "model_config", lambda self: jcfg)
        sess = japi.ServeSession(japi.RunSpec(arch=ARCH, smoke=True),
                                 params=jax.tree.map(jnp.asarray, p))
        fr = jnp.asarray(frames)
        logits, pre = sess.prefill(prompts, enc_frames=fr)
        out = {"prefill": (np.asarray(logits),
                           jax.tree.map(np.asarray, pre))}
        cache = sess._seed(sess.new_cache(B, MAX_SEQS[0]), pre)
        tok = jnp.argmax(logits[:, :jcfg.vocab], -1)[:, None]
        logits, cache = sess.decode(cache, tok, T)
        out["decode"] = (np.asarray(tok), np.asarray(logits),
                         jax.tree.map(np.asarray, cache))
        out["generate"] = {s: np.asarray(sess.generate(
            prompts, NEW, max_seq=s, enc_frames=fr)) for s in MAX_SEQS}
        try:
            sess.generate(prompts, NEW, max_seq=12, enc_frames=fr)
            out["raises_at_12"] = None
        except TypeError as e:            # dynamic_update_slice's shapes
            out["raises_at_12"] = e
    return out


def session(cfg):
    p, prompts, frames = inputs(cfg)
    sess = tapi.ServeSession(tapi.RunSpec(arch=ARCH, smoke=True),
                             tlm.params_from_jax(p, cfg, "cpu"),
                             device="cpu", cfg=cfg)
    return sess, prompts, frames


def assert_cache(got: dict, want: dict, what: str):
    paths = [path for path, _ in leaves_with_paths(got)]
    assert paths == [("cross", "k"), ("cross", "v"), ("self", "k"),
                     ("self", "v")], paths
    for path, t in leaves_with_paths(got):
        ref = want[path[0]][path[1]]
        assert tuple(t.shape) == ref.shape, (what, path)
        assert_rel(t.numpy(), ref, STATE_RTOL, f"{what} {'/'.join(path)}")


def test_prefill_matches_jax(oracle):
    """The prefill's logits and both caches: self (L, b, kvl, 8, hd),
    cross (L, b, kvl, 32, hd), the encoder's frames long."""
    _, cfg = cfg_pair(ARCH)
    sess, prompts, frames = session(cfg)
    logits, pre = sess.prefill(prompts, enc_frames=frames)
    jlogits, jpre = oracle["prefill"]
    assert logits.shape == (B, cfg.vocab)
    assert_rel(logits.numpy(), jlogits, LOGIT_RTOL, "logits")
    kvl, hd = cfg.n_kv_heads, cfg.hd
    assert pre["self"]["k"].shape == (cfg.n_layers, B, kvl, T, hd)
    assert pre["cross"]["k"].shape == (cfg.n_layers, B, kvl,
                                       cfg.enc_frames, hd)
    assert_cache(pre, jpre, "prefill")


def test_decode_step_matches_jax(oracle):
    """One decode step at position 8 from the prefill's cache seeded
    into a 32-long one (``init_cache``: self and cross, each (L, b, kvl,
    32, hd)): the logits, the self cache written in place at 8, the
    cross cache returned as it is."""
    _, cfg = cfg_pair(ARCH)
    sess, prompts, frames = session(cfg)
    tok, jlogits, jcache = oracle["decode"]
    _, pre = sess.prefill(prompts, enc_frames=frames)
    cache = build.seed_cache(sess.new_cache(B, MAX_SEQS[0]), pre)
    cross = cache["cross"]["k"].clone()
    logits, new = sess.decode(cache, tok, T)
    assert new["self"]["k"] is cache["self"]["k"]       # written in place
    assert torch.equal(new["cross"]["k"], cross)
    assert_rel(logits.numpy(), jlogits, LOGIT_RTOL, "decode logits")
    assert_cache(new, jcache, "decode")
    assert not new["self"]["k"][:, :, :, T + 1:].any()


def forced_margins(sess, prompts, frames, forced, max_seq) -> np.ndarray:
    """The port's top-2 margins of the prefill and each decode step over
    a ``max_seq`` cache, feeding ``forced`` (B, NEW) tokens."""
    with torch.inference_mode():
        logits, pre = sess.prefill(prompts, enc_frames=frames)
        cache = build.seed_cache(sess.new_cache(B, max_seq), pre)
        out = [logits]
        for j in range(NEW - 1):
            logits, cache = sess.decode(cache, forced[:, j:j + 1], T + j)
            out.append(logits)
    top2 = torch.stack(out, 1).topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).numpy()


@pytest.mark.parametrize("max_seq", MAX_SEQS)
def test_generate_matches_jax_session(oracle, max_seq):
    """generate at max_seq 32 (the frame count) and 64 (32 zero columns
    in the cross cache, weighed by the decode as JAX weighs them): JAX's
    tokens, up to the first position whose teacher-forced top-2 margin
    is thinner than 2 LOGIT_TOL (none at these weights); the tokens of
    the two lengths differ, in both packages."""
    _, cfg = cfg_pair(ARCH)
    sess, prompts, frames = session(cfg)
    want = oracle["generate"][max_seq]
    got = sess.generate(prompts, NEW, max_seq=max_seq, enc_frames=frames)
    assert got.shape == (B, NEW)
    margin = forced_margins(sess, prompts, frames, want, max_seq)
    compared = 0
    for i in range(B):
        thin = np.nonzero(margin[i] < 2 * LOGIT_TOL)[0]
        upto = int(thin[0]) if thin.size else NEW
        np.testing.assert_array_equal(got[i, :upto].numpy(), want[i, :upto])
        compared += upto
    assert compared == B * NEW, compared
    other = oracle["generate"][[s for s in MAX_SEQS if s != max_seq][0]]
    assert not np.array_equal(want, other)


def test_generate_raises_where_jax_raises(oracle):
    """At max_seq 12 (>= 8 + 4, < 32 frames) JAX's seeding of the cross
    cache raises (a TypeError from dynamic_update_slice); the port's
    seed_cache raises naming the cross cache's need."""
    assert oracle["raises_at_12"] is not None
    _, cfg = cfg_pair(ARCH)
    sess, prompts, frames = session(cfg)
    with pytest.raises(ValueError, match="cross.*max_seq >= the encoder's "
                                         "frame count"):
        sess.generate(prompts, NEW, max_seq=12, enc_frames=frames)


@pytest.mark.parametrize("qk_norm", [False, True], ids=["plain", "qk_norm"])
def test_cross_decode_matches_jax_kv_ext(qk_norm):
    """blocks.cross_decode against the kv_ext branch of JAX's
    gqa_attention at t 1 (``blocked_attention(causal=False)``) over a
    (3, kvl, 24, hd) cache whose last 8 columns are zero: both attend to
    every column, the zero ones included."""
    jcfg, cfg = cfg_pair(ARCH)
    jcfg = dataclasses.replace(jcfg, qk_norm=qk_norm)
    cfg = dataclasses.replace(cfg, qk_norm=qk_norm)
    p = {k[2:]: v[0] for k, v in np_params(cfg, SEED + 2)["decoder"].items()
         if k.startswith("x_")}
    rng = np.random.default_rng(SEED + 3)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    kc, vc = (rng.standard_normal((3, cfg.n_kv_heads, 24, cfg.hd)).astype(
        np.float32) for _ in range(2))
    kc[:, :, 16:] = vc[:, :, 16:] = 0.0

    def jf(p, x, kc, vc):
        return jblocks.gqa_attention(ctx, jcfg, p, x, None, kv_ext=(kc, vc),
                                     causal=False)[0]
    call, ctx = jax_tp1(jf)
    want = np.asarray(call(*jax.tree.map(jnp.asarray, (p, x, kc, vc))))
    with torch.inference_mode():
        got = blocks.cross_decode(cfg, to_torch(p), torch.from_numpy(x),
                                  {"k": torch.from_numpy(kc),
                                   "v": torch.from_numpy(vc)})
    assert got.shape == (3, 1, cfg.d_model)
    assert_rel(got.numpy(), want, LOGIT_RTOL, "cross_decode")


def test_enc_frames_are_refused_by_name():
    """A whisper prefill or generate without enc_frames, and enc_frames
    given to a family without an encoder, raise naming enc_frames."""
    _, cfg = cfg_pair(ARCH)
    sess, prompts, frames = session(cfg)
    for call in (lambda: sess.prefill(prompts),
                 lambda: sess.generate(prompts, NEW)):
        with pytest.raises(ValueError, match="needs enc_frames"):
            call()
    _, zcfg = cfg_pair("zamba2_7b")
    zamba = tapi.ServeSession(tapi.RunSpec(arch="zamba2_7b", smoke=True),
                              device="cpu", cfg=zcfg)
    with pytest.raises(ValueError, match="enc_frames given to"):
        zamba.generate(prompts, NEW, enc_frames=frames)
