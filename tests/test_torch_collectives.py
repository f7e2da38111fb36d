"""repro_torch.photonics.encoding and repro_torch.collectives on the CPU,
held against the JAX package on the same numpy-seeded inputs.

Everything here is integer math or f32 arithmetic in the JAX order, so
the encoding functions, the pam4 plain versions and the optinc sync are
held bit for bit; the psum sync sums floats over peers in an order the
two frameworks may choose differently, so it is held to 1 ulp of the
per-element magnitude.

The 2- and 4-peer JAX references need a JAX process with several host
devices.  They come from ONE subprocess per module (started with
``XLA_FLAGS`` in its environment, never set in this process), which
writes its results to an ``.npz`` the tests read.
"""
import dataclasses
import functools
import json
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.collectives import SyncConfig as JaxSyncConfig
from repro.collectives import backends as jbackends
from repro.collectives import bucketizer as jbucketizer
from repro.kernels import pam4 as jpam4
from repro.photonics import PhotonicsConfig as JaxPhotonicsConfig
from repro.photonics import encoding as jenc
from repro.photonics import onn as jonn
from repro.photonics import pipeline as jpipe
from repro.photonics import runtime as jruntime
from repro.photonics.module import ONNModule as JaxONNModule
from repro_torch.collectives import backends, bucketizer, engine, registry
from repro_torch.kernels import pam4, ref
from repro_torch.photonics import PhotonicsConfig
from repro_torch.photonics import encoding as tenc
from repro_torch.photonics import onn as tonn
from repro_torch.photonics import runtime
from repro_torch.photonics.module import ONNModule

BITS = (2, 4, 8)


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(a):
    return torch.from_numpy(np.array(a))


def _grad(rng, shape, bits, block, scale=None):
    """Random f32 values with exact ties (g / s * levels on a .5 for the
    block scale s), an all-zero block and a ragged tail."""
    g = rng.normal(size=shape).astype(np.float32)
    flat = g.reshape(-1)
    levels = 2 ** (bits - 1) - 1
    flat[:block] = 0.0                                  # a zero block
    s = np.abs(flat[block:2 * block]).max()
    k = np.arange(1, 9, dtype=np.float32)
    flat[block:block + 8] = ((k - 0.5) / levels * s).astype(np.float32)
    return g


# ------------------------------------------------------------ encoding
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("block", [0, 16])
def test_encoding_matches_jax_bit_for_bit(bits, block):
    rng = np.random.default_rng(bits * 10 + block)
    g = _grad(rng, (7, 13), bits, max(block, 16))       # 91: ragged blocks
    spec = tenc.QuantSpec(bits=bits, block=block)
    jspec = jenc.QuantSpec(bits=bits, block=block)
    assert (spec.levels, spec.offset) == (jspec.levels, jspec.offset)
    assert tenc.num_symbols(bits) == jenc.num_symbols(bits)
    scale = tenc.compute_scale(_t(g), spec)
    np.testing.assert_array_equal(
        scale.numpy(), np.asarray(jenc.compute_scale(jnp.asarray(g), jspec)))
    u, s = tenc.quantize(_t(g), spec)
    ju, js = jenc.quantize(jnp.asarray(g), jspec)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tenc.dequantize(u, s, spec).numpy(),
        np.asarray(jenc.dequantize(ju, js, jspec)))
    stack = rng.integers(0, 2 ** bits - 1, size=(4, 50)).astype(np.int32)
    stack[:, :4] = [[0, 0, 1, 1], [1, 0, 1, 1], [0, 1, 0, 1], [1, 1, 0, 0]]
    np.testing.assert_array_equal(                      # ties: 2/4, 3/4...
        tenc.qmean(_t(stack)).numpy(), np.asarray(jenc.qmean(stack)))


# --------------------------------------------------- pam4 plain versions
def _encode_case(bits, peers=3, nb=16, block=128, tail=40, seed=0):
    rng = np.random.default_rng(seed + bits)
    m = nb * block - tail
    g = np.stack([_grad(rng, (m,), bits, block) for _ in range(peers)])
    padded = np.pad(g, ((0, 0), (0, nb * block - m)))
    scale = np.maximum(np.abs(padded.reshape(peers, nb, block)).max(-1),
                       np.float32(1.1754944e-38)).max(0)
    return g, scale.astype(np.float32), m, block


@pytest.mark.parametrize("bits", BITS)
def test_pam4_plain_versions_match_the_jax_pallas_kernels(bits):
    """The Pallas kernels (interpret mode) have no zero-block guard, so
    this case has no zero block; the next test covers it."""
    g, scale, m, block = _encode_case(bits)
    g[:, :block] = 1.0
    scale[0] = 1.0
    nb = scale.shape[0]
    padded = np.pad(g, ((0, 0), (0, nb * block - m)))
    u = ref.pam4_quantize_encode_ref(_t(g), _t(scale), bits, block).numpy()
    for p in range(g.shape[0]):
        want = jpam4.pam4_quantize_encode(
            jnp.asarray(padded[p].reshape(nb, block)), jnp.asarray(scale),
            bits, interpret=True)
        np.testing.assert_array_equal(u[p], np.asarray(want))
    total = u.sum(0, dtype=np.int32)
    total[0, :12] = np.arange(12) * 3 + 1               # ties at n = 2 below
    for n in (1, 2, 3):
        got = ref.pam4_decode_dequantize_ref(_t(total.reshape(1, -1)),
                                             _t(scale), bits, n, m).numpy()
        want = jpam4.pam4_decode_dequantize(
            jnp.asarray(total), jnp.asarray(scale), bits, n, interpret=True)
        np.testing.assert_array_equal(got[0],
                                      np.asarray(want).reshape(-1)[:m])


@pytest.mark.parametrize("bits", BITS)
def test_pam4_plain_versions_match_the_backend_encode_and_decode(bits):
    """Against backends._encode (zero-block guard included) and the
    Q(mean) + _decode of _quantized_sync, per peer."""
    g, scale, m, block = _encode_case(bits)
    g[:, :block] = 0.0                                  # zero on every peer
    scale[0] = np.float32(1.1754944e-38)
    cfg = JaxSyncConfig(bits=bits, block=block)
    u = ref.pam4_quantize_encode_ref(_t(g), _t(scale), bits, block)
    assert torch.all(u[:, 0] == 2 ** (bits - 1) - 1)
    for p in range(g.shape[0]):
        ju, jq, jsafe, jspec = jbackends._encode(jnp.asarray(g[p]),
                                                 jnp.asarray(scale), cfg)
        np.testing.assert_array_equal(u[p].numpy(), np.asarray(ju))
        local = ref.pam4_decode_dequantize_ref(u[p].reshape(1, -1),
                                               _t(scale), bits, 1, m)
        np.testing.assert_array_equal(
            local[0].numpy(), np.asarray(_jax_qmean_decode(
                ju.reshape(-1), jsafe, bits, 1, m)))
        err = ref.pam4_decode_dequantize_ref(u[p].reshape(1, -1), _t(scale),
                                             bits, 1, m, _t(g[p:p + 1]))
        np.testing.assert_array_equal(err[0].numpy(), np.asarray(
            _jax_local_error(jnp.asarray(g[p]), jq, jsafe, bits, m)))
    for n in (2, 3):
        total = u[:n].sum(0, dtype=torch.int32).reshape(1, -1)
        got = ref.pam4_decode_dequantize_ref(total, _t(scale), bits, n, m)
        np.testing.assert_array_equal(
            got[0].numpy(), np.asarray(_jax_qmean_decode(
                jnp.asarray(total.numpy()), jsafe, bits, n, m)))


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _jax_qmean_decode(total, safe, bits, n, m):
    """``_quantized_sync``'s Q(mean) and ``_decode`` as the training step
    compiles them (XLA turns the constant divisions into reciprocal
    products, so they are held jitted, as they run)."""
    spec = jenc.QuantSpec(bits=bits, block=safe.shape[0])
    u_avg = jnp.round(total.astype(jnp.float32) / n).astype(jnp.int32)
    return jbackends._decode(u_avg.reshape(safe.shape[0], -1) - spec.levels,
                             safe, spec, m)


@functools.partial(jax.jit, static_argnums=(3, 4))
def _jax_local_error(flat, q, safe, bits, m):
    """``flat - _decode(q, ...)``, the error-feedback term of
    ``_quantized_sync``, jitted (XLA fuses it into one multiply-add)."""
    spec = jenc.QuantSpec(bits=bits, block=safe.shape[0])
    return flat - jbackends._decode(q, safe, spec, m)


def test_pam4_wrappers_route_cpu_to_plain_and_reject_bad_input():
    g, scale, m, block = _encode_case(8, peers=2, nb=4)
    before = (pam4.pam4_quantize_encode.launches,
              pam4.pam4_decode_dequantize.launches)
    u = pam4.pam4_quantize_encode(_t(g), _t(scale), 8, block)
    assert torch.equal(u, ref.pam4_quantize_encode_ref(_t(g), _t(scale), 8,
                                                       block))
    tot = u.sum(0, dtype=torch.int32).reshape(1, -1)
    assert torch.equal(pam4.pam4_decode_dequantize(tot, _t(scale), 8, 2, m),
                       ref.pam4_decode_dequantize_ref(tot, _t(scale), 8, 2,
                                                      m))
    assert (pam4.pam4_quantize_encode.launches,
            pam4.pam4_decode_dequantize.launches) == before
    assert not any(pam4.pam4_decode_dequantize.forms.values())
    with pytest.raises(TypeError, match="float32"):
        pam4.pam4_quantize_encode(_t(g).double(), _t(scale), 8, block)
    with pytest.raises(ValueError, match="scales for"):
        pam4.pam4_quantize_encode(_t(g), _t(scale[:2]), 8, block)
    with pytest.raises(ValueError, match="CPU or one CUDA"):
        pam4.pam4_quantize_encode(_t(g).to("meta"), _t(scale), 8, block)
    with pytest.raises(TypeError, match="int32"):
        pam4.pam4_decode_dequantize(tot.long(), _t(scale), 8, 2, m)
    with pytest.raises(ValueError, match="whole number"):
        pam4.pam4_decode_dequantize(tot[:, :-1], _t(scale), 8, 2, m)


_A = 0x7f0000000000                        # an allocation starts on 512 B


@pytest.mark.parametrize("rows,ld,block,ptr,form", [
    (4, 1 << 20, 2048, 0x7f0000000000, "aligned"),   # a contiguous bucket
    (4, 43_456_896, 2048, 0x7f0000000000 + 4 * (1 << 20), "aligned"),
    (4, 80_919, 2048, 0x7f0000000004, "shifted"),    # one float off
    (4, 81_918, 2048, 0x7f0000000000, "shifted"),    # stride 2 mod 4
    (1, 81_918, 2048, 0x7f0000000000, "aligned"),    # one row: no stride
    (1, 81_918, 2048, 0x7f0000000008, "shifted"),
    (4, 60_000, 1000, 0x7f0000000000, "aligned"),    # block 1000 = 4 x 250
    (4, 59_993, 1000, 0x7f0000000000, "shifted"),
    (4, 59_940, 999, 0x7f0000000000, "scalar"),      # block not 4 k
    (4, 4096, 2, 0x7f0000000000, "scalar"),
    (4, 4096, 1, 0x7f0000000004, "scalar"),
    (3, 4096, 4, 0x7f0000000000, "aligned"),
])
def test_pam4_encode_form_by_alignment_stride_and_block(rows, ld, block,
                                                        ptr, form):
    assert pam4.encode_form(rows, ld, block, ptr) == form


def test_pam4_encode_takes_the_aligned_form_on_every_bucket_of_the_step():
    """paper_llama's 4-peer gradient stack in 4 MiB buckets of block 2048:
    every bucket view (and its contiguous error-feedback sum) starts on
    16 bytes with a row stride a multiple of 4, so all 42 encodes take
    the aligned vector form, and so do the 42 decodes in both forms."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.tree import leaves
    cfg = configs.get("paper_llama")
    layout = bucketizer.make_layout([
        (s, torch.float32) for s in leaves(lm.param_shapes(cfg))])
    assert layout.n_buckets == 42
    base = _A
    forms = {pam4.encode_form(4, layout.total, 2048, base + 4 * s)
             for s, _ in layout.bounds}
    forms |= {pam4.encode_form(4, e - s, 2048, base)
              for s, e in layout.bounds}
    assert forms == {"aligned"}
    # decode: the Q(mean) sums (one row) and the error-feedback codes (4
    # rows, the base the contiguous bucket plus residual the trainer
    # passes, or the bucket view itself), every array a fresh allocation
    qmean = {pam4.decode_form(1, e - s, 0, 2048, None, base, base)
             for s, e in layout.bounds}
    ef = {pam4.decode_form(4, e - s, e - s, 2048, base, base, base)
          for s, e in layout.bounds}
    ef |= {pam4.decode_form(4, e - s, layout.total, 2048, base + 4 * s, base,
                            base)
           for s, e in layout.bounds}
    assert qmean == ef == {"aligned"}


@pytest.mark.parametrize("rows,m,ld,block,base,out,total,form", [
    (1, 1 << 20, 0, 2048, None, _A, _A, "aligned"),     # Q(mean), a bucket
    (1, 465_280, 0, 2048, None, _A, _A, "aligned"),     # the last bucket
    (1, 74_775, 0, 2048, None, _A, _A, "aligned"),      # one row, m % 4 3
    (4, 74_775, 0, 2048, None, _A, _A, "scalar"),       # rows off 16 bytes
    (4, 1 << 20, 43_456_896, 2048, _A + 4 * (1 << 20), _A, _A, "aligned"),
    (4, 80_920, 80_920, 2048, _A, _A, _A, "aligned"),   # base contiguous
    (4, 80_920, 80_920, 2048, _A + 4, _A, _A, "scalar"),    # a float off
    (4, 80_920, 80_922, 2048, _A, _A, _A, "scalar"),    # stride 2 mod 4
    (1, 74_775, 74_775, 2048, _A + 8, _A, _A, "scalar"),
    (1, 74_775, 74_777, 2048, _A, _A, _A, "aligned"),   # one row: no stride
    (4, 74_775, 74_775, 2048, _A, _A, _A, "scalar"),
    (4, 59_992, 0, 1000, None, _A, _A, "aligned"),      # block 1000 = 4 x 250
    (4, 59_992, 59_994, 1000, _A, _A, _A, "scalar"),
    (4, 59_940, 0, 999, None, _A, _A, "scalar"),        # block not 4 k
    (1, 59_940, 59_940, 999, _A + 4, _A, _A, "scalar"),
    (1, 1 << 20, 0, 2048, None, _A, _A + 4, "scalar"),  # sums off 16 bytes
    (1, 1 << 20, 0, 2048, None, _A + 8, _A, "scalar"),  # output off
])
def test_pam4_decode_form_by_alignment_stride_and_block(rows, m, ld, block,
                                                        base, out, total,
                                                        form):
    assert pam4.decode_form(rows, m, ld, block, base, out, total) == form


@pytest.mark.parametrize("view", ["offset", "ld"])
@pytest.mark.parametrize("bits", BITS)
def test_pam4_decode_of_a_base_view_matches_the_jax_local_error(bits, view):
    """The error-feedback decode through the wrapper (its plain version on
    the CPU) of a base one float past 16 bytes, or with a row stride 2 mod
    4 (the views that take the scalar form on the card), bit for bit
    against ``_quantized_sync``'s local term, per peer."""
    g, scale, m, block = _encode_case(bits)
    peers = g.shape[0]
    if view == "offset":
        base = torch.empty(peers * m + 1)[1:].view(peers, m)
    else:
        base = torch.empty(peers, m + 2)[:, :m]
    base.copy_(_t(g))
    assert pam4.decode_form(peers, m, base.stride(0), block,
                            base.data_ptr(), _A, _A) == "scalar"
    u = pam4.pam4_quantize_encode(base, _t(scale), bits, block)
    err = pam4.pam4_decode_dequantize(u.reshape(peers, -1), _t(scale), bits,
                                      1, m, base)
    cfg = JaxSyncConfig(bits=bits, block=block)
    for p in range(peers):
        _, jq, jsafe, _ = jbackends._encode(jnp.asarray(g[p]),
                                            jnp.asarray(scale), cfg)
        np.testing.assert_array_equal(err[p].numpy(), np.asarray(
            _jax_local_error(jnp.asarray(g[p]), jq, jsafe, bits, m)))


# ----------------------------------------------------------- bucketizer
def _tree(peers, rng, dtype=np.float32):
    return {"a": rng.normal(size=(peers, 3, 700)).astype(dtype),
            "b": rng.normal(size=(peers, 1500)).astype(dtype),
            "c": {"d": rng.normal(size=(peers, 40, 10)).astype(dtype)}}


@pytest.mark.parametrize("bucket_bytes", [4096, 3000, 1 << 20])
def test_bucketizer_matches_jax(bucket_bytes):
    rng = np.random.default_rng(0)
    tree = _tree(2, rng)
    jleaves = [tree["a"][0], tree["b"][0], tree["c"]["d"][0]]
    jl = jbucketizer.make_layout(jleaves, bucket_bytes)
    stacks = [_t(x) for x in (tree["a"], tree["b"], tree["c"]["d"])]
    tl = bucketizer.make_layout([x[0] for x in stacks], bucket_bytes)
    assert (tl.shapes, tl.sizes, tl.total, tl.bucket_elems, tl.bounds) == \
        (jl.shapes, jl.sizes, jl.total, jl.bucket_elems, jl.bounds)
    assert tl.n_buckets == jl.n_buckets == bucketizer.expected_buckets(
        4 * tl.total, bucket_bytes) == jbucketizer.expected_buckets(
        4 * jl.total, bucket_bytes)
    assert bucketizer.make_layout([(x.shape[1:], x.dtype) for x in stacks],
                                  bucket_bytes) == tl
    for p in range(2):
        buckets = bucketizer.bucketize([x[p] for x in stacks], tl)
        want = jbucketizer.bucketize([x[p] for x in (
            tree["a"], tree["b"], tree["c"]["d"])], jl)
        for got, w in zip(buckets, want):
            np.testing.assert_array_equal(got.numpy(), np.asarray(w))
        back = bucketizer.unbucketize(buckets, tl)
        for got, leaf in zip(back, stacks):
            assert torch.equal(got, leaf[p])
    bf = [x[0].bfloat16() for x in stacks]
    lay = bucketizer.make_layout(bf, bucket_bytes)
    back = bucketizer.unbucketize(bucketizer.bucketize(bf, lay), lay)
    assert all(torch.equal(a, b) for a, b in zip(back, bf))
    with pytest.raises(ValueError, match="positive"):
        bucketizer.make_layout(stacks, 0)


def test_registry_and_config_reject_what_is_not_ported():
    """The registry lists JAX's four backends, and SyncConfig takes each
    of them, streaming overlap and every Table-II row (since the
    ring/cascade slice); it still rejects what JAX cannot run."""
    assert registry.available_backends() == ("cascade", "optinc", "psum",
                                             "ring")
    with pytest.raises(ValueError, match="already registered"):
        registry.register_backend("optinc", backends.OptincBackend())
    with pytest.raises(TypeError, match="time_on_wire"):
        registry.register_backend("x", type("B", (), {
            "sync": lambda *a: None, "bytes_on_wire": lambda *a: 0})())
    with pytest.raises(ValueError, match="unknown sync mode"):
        engine.SyncConfig(mode="nope")
    for kw in (dict(mode="ring"), dict(mode="cascade"),
               dict(overlap=True), dict(error_layers=(3, 4, 5, 6)),
               dict(mode="cascade", axes=("pod", "data"), bits=2,
                    photonics=PhotonicsConfig(fidelity="mesh"))):
        sc = engine.SyncConfig(**kw)
        assert all(getattr(sc, k) == v for k, v in kw.items())
    with pytest.raises(ValueError, match="not a row of Table II"):
        engine.SyncConfig(error_layers=(3, 4))
    # block-sparse residual checkpoints are taken since the checkpoint
    # slice, and the JAX mesh axes are kept for the spec's JSON
    sc = engine.SyncConfig(sparse_residuals=True, error_feedback=True)
    assert sc.sparse_residuals and sc.axes == ("data",)
    # the mesh fidelity, its executor, its row tile and (since the
    # PhaseNoise slice) its noise stds are taken
    for ph in (PhotonicsConfig(fidelity="mesh"),
               PhotonicsConfig(fidelity="mesh", mesh_backend="pallas"),
               PhotonicsConfig(fidelity="mesh", blk_b=64),
               PhotonicsConfig(fidelity="mesh", theta_drift_std=0.01),
               PhotonicsConfig(fidelity="mesh", shot_noise_std=0.01)):
        assert engine.SyncConfig(photonics=ph).photonics == ph
    for knob in ("theta_drift_std", "shot_noise_std"):
        with pytest.raises(ValueError, match="only apply to --fidelity mesh"):
            engine.SyncConfig(photonics=PhotonicsConfig(
                fidelity="onn", **{knob: 0.01}))
    for mode in ("psum", "ring"):
        with pytest.raises(ValueError, match="photonic-backend knob"):
            engine.SyncConfig(mode=mode,
                              photonics=PhotonicsConfig(fidelity="onn"))
    with pytest.raises(TypeError, match="PhotonicsConfig"):
        engine.SyncConfig(photonics="onn")
    assert engine.SyncConfig().photonics == PhotonicsConfig()
    assert engine.SyncConfig(
        photonics=PhotonicsConfig(fidelity="onn")).photonics.fidelity == "onn"


@pytest.mark.parametrize("name", ["psum", "optinc"])
def test_wire_models_match_jax(name):
    port, jax_b = registry.get_backend(name), jbackends.OptincBackend() \
        if name == "optinc" else jbackends.PsumBackend()
    for nbytes in (1e3, 8.7e7):
        for n in (2, 4, 16):
            assert port.bytes_on_wire(nbytes, n, 8) == \
                jax_b.bytes_on_wire(nbytes, n, 8)
            for overlap in (False, True):
                assert port.time_on_wire(nbytes, n, 8, overlap) == \
                    jax_b.time_on_wire(nbytes, n, 8, overlap)


# ------------------------------------------------- sync vs JAX shard_map
# (mode, bits, error_feedback) with 4 KiB buckets of 128-element blocks:
# 4000 elements are 3 full buckets and a ragged tail of 928 (7 blocks and
# a 32-element block); columns 1280..1407 (one block) are zero on every
# peer; bits 2 makes Q(mean) ties common
CASES = {"psum": ("psum", 8, False), "optinc8": ("optinc", 8, False),
         "optinc8_ef": ("optinc", 8, True), "optinc2_ef": ("optinc", 2, True)}
# optinc at fidelity 'onn': (bits, error_feedback).  Bits 2 resolves the
# exact identity ONN in both packages; at bits 8 both runtimes get the
# same seeded ONN of the default structure through put_module.
ONN_CASES = {"onn2": (2, False), "onn2_ef": (2, True), "onn8": (8, False),
             "onn8_ef": (8, True)}
ONN8_STRUCTURE = (4, 64, 128, 256, 128, 64, 4)
# optinc at fidelity 'mesh': (bits, error_feedback, mesh_backend).  Bits
# 2 resolves the exact identity ONN (zero rotations); at bits 8 both
# runtimes get the same seeded approx ONN of MESH8_STRUCTURE (every layer
# Sigma_a U_a: meshes of 4 and 32 wires, 5 to 61 layers deep)
MESH_CASES = {"mesh2_xla": (2, True, "xla"), "mesh2_pallas": (2, False, "pallas"),
              "mesh8_xla": (8, False, "xla"),
              "mesh8_pallas": (8, True, "pallas")}
MESH8_STRUCTURE = (4, 32, 64, 32, 4)
MESH8_APPROX = (1, 2, 3, 4)
PEERS = (1, 2, 4)
MESH_PEERS = (2, 4)      # an ONN averages peers; one peer adds no case
SYNC_KW = dict(block=128, bucket_bytes=4096)
# bits 8 at fidelity 'onn': an element is compared bit for bit unless one
# of its four analog ONN outputs on the JAX side lies within this of a
# PAM4 decision threshold (0.5, 1.5, 2.5), where f32 sums taken in
# another order may round to the other symbol
ONN_MARGIN = 1e-4

JAX_SYNC_SCRIPT = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.collectives import SyncConfig, sync_gradients
    from repro.launch.mesh import make_mesh
    from repro.photonics import PhotonicsConfig, runtime
    from repro.photonics.module import ONNModule

    from repro.photonics.onn import ONNConfig

    inp = np.load(sys.argv[1])
    cases = json.loads(sys.argv[3])
    out = {}
    onn = [{"w": inp[f"onn_w{i}"], "b": inp[f"onn_b{i}"]}
           for i in range(6)]
    mesh_onn = [{"w": inp[f"mesh_w{i}"], "b": inp[f"mesh_b{i}"]}
                for i in range(4)]
    for n in (1, 2, 4):
        ph = PhotonicsConfig(fidelity="onn")
        runtime.put_module(ph, 8, n, ONNModule.from_params(
            runtime.onn_config(ph, 8, n), onn))
        runtime.put_module(PhotonicsConfig(fidelity="mesh"), 8, n,
                           ONNModule.from_params(ONNConfig(
                               structure=tuple(inp["mesh_structure"]),
                               approx_layers=tuple(inp["mesh_approx"]),
                               bits=8, n_servers=n, k_inputs=4), mesh_onn))
        mesh = make_mesh((n,), ("data",))
        for name, (mode, bits, ef, fidelity, backend, peers) in cases.items():
            if n not in peers:
                continue
            cfg = SyncConfig(mode=mode, axes=("data",), bits=bits,
                             error_feedback=ef, block=128, bucket_bytes=4096,
                             photonics=PhotonicsConfig(
                                 fidelity=fidelity, mesh_backend=backend))

            def f(a, b, d, res):
                tree = {"a": a[0], "b": b[0], "c": {"d": d[0]}}
                s, r = sync_gradients(tree, cfg, None, res[0] if ef else None)
                r = res[0] * 0 if r is None else r
                return s["a"][None], s["b"][None], s["c"]["d"][None], r[None]

            fn = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P("data"),
                                       out_specs=P("data"), check_vma=False))
            res = jnp.zeros((n, 4000), jnp.float32)
            for step in (1, 2):
                args = [jnp.asarray(inp[f"{k}{step}"][:n]) for k in "abd"]
                a, b, d, res = fn(*args, res)
                key = f"{name}/{n}/{step}"
                out[key + "/synced"] = np.concatenate(
                    [np.asarray(x).reshape(n, -1) for x in (a, b, d)], 1)
                out[key + "/residual"] = np.asarray(res)
    np.savez(sys.argv[2], **out)
    print("OK")
""")


def _onn8_params():
    """A seeded bits-8 ONN of the default structure (He-normal weights,
    small random biases), as numpy."""
    rng = np.random.default_rng(11)
    out = []
    for i in range(len(ONN8_STRUCTURE) - 1):
        n, m = ONN8_STRUCTURE[i], ONN8_STRUCTURE[i + 1]
        out.append({"w": (rng.normal(size=(m, n)) * (2.0 / n) ** 0.5
                          ).astype(np.float32),
                    "b": (rng.normal(size=(m,)) * 0.3).astype(np.float32)})
    return out


@functools.lru_cache(maxsize=None)
def _mesh8_params():
    """A seeded bits-8 ONN of MESH8_STRUCTURE (He-normal weights, small
    random biases) projected onto Sigma_a U_a with JAX's
    ``project_approx``, as numpy."""
    rng = np.random.default_rng(12)
    raw = []
    for n, m in zip(MESH8_STRUCTURE[:-1], MESH8_STRUCTURE[1:]):
        raw.append({"w": (rng.normal(size=(m, n)) * (2.0 / n) ** 0.5
                          ).astype(np.float32),
                    "b": (rng.normal(size=(m,)) * 0.3).astype(np.float32)})
    cfg = jonn.ONNConfig(structure=MESH8_STRUCTURE,
                         approx_layers=MESH8_APPROX, bits=8, n_servers=1,
                         k_inputs=4)
    return [{k: np.asarray(l[k], np.float32) for k in ("w", "b")}
            for l in jonn.project_approx(raw, cfg)]


def _mesh8_module(peers, module_cls, cfg_cls):
    return module_cls.from_params(
        cfg_cls(structure=MESH8_STRUCTURE, approx_layers=MESH8_APPROX,
                bits=8, n_servers=peers, k_inputs=4), _mesh8_params())


def _sync_inputs():
    rng = np.random.default_rng(7)
    out = {}
    for i, layer in enumerate(_onn8_params()):
        out[f"onn_w{i}"], out[f"onn_b{i}"] = layer["w"], layer["b"]
    for i, layer in enumerate(_mesh8_params()):
        out[f"mesh_w{i}"], out[f"mesh_b{i}"] = layer["w"], layer["b"]
    out["mesh_structure"] = np.array(MESH8_STRUCTURE)
    out["mesh_approx"] = np.array(MESH8_APPROX)
    for step in (1, 2):
        flat = rng.normal(size=(4, 4000)).astype(np.float32)
        flat[:, 1280:1408] = 0.0
        flat[:, :3] = [[1.0, 0.5, -0.5]] * 4         # exact ties at bits 2
        out[f"a{step}"] = flat[:, :2100].reshape(4, 3, 700)
        out[f"b{step}"] = flat[:, 2100:3600]
        out[f"d{step}"] = flat[:, 3600:].reshape(4, 40, 10)
    return out


@pytest.fixture(scope="module")
def jax_sync(tmp_path_factory):
    """The JAX sync_gradients under shard_map at 1, 2 and 4 devices, two
    steps each, from one subprocess with four host devices."""
    from conftest import subprocess_env
    d = tmp_path_factory.mktemp("jax_sync")
    inputs = _sync_inputs()
    np.savez(d / "in.npz", **inputs)
    cases = {k: v + ("behavioral", "xla", PEERS) for k, v in CASES.items()}
    cases.update({k: ("optinc", bits, ef, "onn", "xla", PEERS)
                  for k, (bits, ef) in ONN_CASES.items()})
    cases.update({k: ("optinc", bits, ef, "mesh", backend, MESH_PEERS)
                  for k, (bits, ef, backend) in MESH_CASES.items()})
    r = subprocess.run(
        [sys.executable, "-c", JAX_SYNC_SCRIPT, str(d / "in.npz"),
         str(d / "out.npz"), json.dumps(cases)],
        capture_output=True, text=True, timeout=600,
        env=subprocess_env(
            XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    assert r.returncode == 0, r.stderr[-3000:]
    return inputs, dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("peers", PEERS)
@pytest.mark.parametrize("case", list(CASES))
def test_sync_gradients_matches_jax_shard_map(jax_sync, case, peers):
    inputs, ref_out = jax_sync
    mode, bits, ef = CASES[case]
    cfg = engine.SyncConfig(mode=mode, bits=bits, error_feedback=ef,
                            **SYNC_KW)
    res = torch.zeros((peers, 4000)) if ef else None
    for step in (1, 2):
        grads = {"a": _t(inputs[f"a{step}"][:peers]),
                 "b": _t(inputs[f"b{step}"][:peers]),
                 "c": {"d": _t(inputs[f"d{step}"][:peers])}}
        synced, res = engine.sync_gradients(grads, cfg, res)
        got = torch.cat([synced["a"].reshape(-1), synced["b"],
                         synced["c"]["d"].reshape(-1)]).numpy()
        key = f"{case}/{peers}/{step}"
        want = ref_out[key + "/synced"]
        # every JAX device holds the same average
        assert (want == want[0]).all()
        if mode == "optinc":
            np.testing.assert_array_equal(got, want[0])
        else:
            flat = np.concatenate([inputs[f"{k}{step}"][:peers].reshape(
                peers, -1) for k in "abd"], 1)
            ulp = np.spacing(np.abs(flat).sum(0) / peers).astype(np.float32)
            assert (np.abs(got - want[0]) <= ulp).all()
        if ef and mode == "optinc":
            np.testing.assert_array_equal(res.numpy(),
                                          ref_out[key + "/residual"])
            assert res.abs().max() > 0
        else:
            assert res is None
        assert np.all(got[1280:1408] == 0.0)        # the zero block


@functools.lru_cache(maxsize=None)
def _jax_onn_analog(peers, fidelity="onn", backend="xla"):
    """JAX's analog ONN outputs for one bucket of ``peers`` rows at bits
    8: the optinc photonic path up to and including MeshApply (shared
    scale, encode, Encode, Preprocess, the ONN), jitted, with a vmap
    over a named axis standing in for the peers' mesh axis.  Fidelity
    'onn' runs the dense ONN of ``_onn8_params``, 'mesh' the meshes of
    ``_mesh8_params`` on ``backend``."""
    ph = JaxPhotonicsConfig(fidelity=fidelity, mesh_backend=backend)
    if fidelity == "mesh":
        from repro.photonics.onn import ONNConfig as JaxONNConfig
        module = _mesh8_module(peers, JaxONNModule, JaxONNConfig)
    else:
        module = JaxONNModule.from_params(jruntime.onn_config(ph, 8, peers),
                                          _onn8_params())
    cfg = JaxSyncConfig(mode="optinc", axes=("data",), bits=8, block=128,
                        photonics=ph)
    stages = jpipe.level_pipeline(module, 8, ("data",), fidelity=fidelity,
                                  mesh_backend=backend).stages[:3]

    def f(x):
        u = jbackends._encode(x, jbackends._shared_scale(x, cfg), cfg)[0]
        return jpipe.SyncPipeline(stages).run(u.reshape(-1)).data

    return jax.jit(jax.vmap(f, axis_name="data"))


def _near_threshold(flat, peers, fidelity="onn", backend="xla"):
    """Elements (total,) whose JAX analog ONN outputs at bits 8 lie within
    ONN_MARGIN of a PAM4 decision threshold."""
    layout = bucketizer.make_layout([torch.empty(flat.shape[1])],
                                    SYNC_KW["bucket_bytes"])
    near = np.zeros(flat.shape[1], bool)
    analog = _jax_onn_analog(peers, fidelity, backend)
    for s, e in layout.bounds:
        y = np.asarray(analog(jnp.asarray(flat[:, s:e])))[0]
        d = np.abs(y[..., None] - np.array([0.5, 1.5, 2.5], np.float32))
        near[s:e] = (d <= ONN_MARGIN).any((-1, -2))[:e - s]
    return near


def _check_photonic_sync(jax_sync, key_case, peers, ph, bits, ef, module,
                         capsys):
    """optinc at a photonic fidelity (``ph``, its bits-8 ONN ``module``
    installed in the port's runtime) against the JAX sync_gradients under
    shard_map, two steps.  Bits 2 (the exact identity ONN): output and
    residuals bit for bit, and equal to the port's behavioral sync.
    Bits 8 (the same seeded ONN in both runtimes): residuals bit for
    bit, the output bit for bit away from the decision thresholds."""
    inputs, ref_out = jax_sync
    runtime.put_module(ph, 8, peers, module)
    cfg = engine.SyncConfig(mode="optinc", bits=bits, error_feedback=ef,
                            photonics=ph, **SYNC_KW)
    behavioral = dataclasses.replace(cfg, photonics=PhotonicsConfig())
    res = torch.zeros((peers, 4000)) if ef else None
    for step in (1, 2):
        grads = {"a": _t(inputs[f"a{step}"][:peers]),
                 "b": _t(inputs[f"b{step}"][:peers]),
                 "c": {"d": _t(inputs[f"d{step}"][:peers])}}
        flat = torch.cat([grads["a"].reshape(peers, -1), grads["b"],
                          grads["c"]["d"].reshape(peers, -1)], 1)
        if ef:
            flat = flat + res
        synced, new_res = engine.sync_gradients(grads, cfg, res)
        got = torch.cat([synced["a"].reshape(-1), synced["b"],
                         synced["c"]["d"].reshape(-1)]).numpy()
        key = f"{key_case}/{peers}/{step}"
        want = ref_out[key + "/synced"]
        assert (want == want[0]).all()
        if bits == 2:
            np.testing.assert_array_equal(got, want[0])
            beh, beh_res = engine.sync_gradients(grads, behavioral, res)
            np.testing.assert_array_equal(got, torch.cat([
                beh["a"].reshape(-1), beh["b"],
                beh["c"]["d"].reshape(-1)]).numpy())
            if ef:
                assert torch.equal(new_res, beh_res)
        else:
            near = _near_threshold(flat.numpy(), peers, ph.fidelity,
                                   ph.mesh_backend)
            with capsys.disabled():
                print(f"\n{key}: {near.sum()} of {near.size} elements within "
                      f"{ONN_MARGIN} of a decision threshold (not compared)")
            assert near.sum() <= 0.01 * near.size
            np.testing.assert_array_equal(got[~near], want[0][~near])
            assert len(np.unique(got)) > 20      # the ONN is not degenerate
        if ef:
            np.testing.assert_array_equal(new_res.numpy(),
                                          ref_out[key + "/residual"])
        else:
            assert new_res is None
        if bits == 2:                     # an exact ONN keeps the zero block
            assert np.all(got[1280:1408] == 0.0)
        res = new_res


@pytest.mark.parametrize("peers", PEERS)
@pytest.mark.parametrize("case", list(ONN_CASES))
def test_onn_sync_matches_jax_shard_map(jax_sync, case, peers, monkeypatch,
                                        capsys):
    """optinc at fidelity 'onn' against the JAX sync_gradients under
    shard_map (``_check_photonic_sync``), the dense ONN of
    ``_onn8_params`` at bits 8."""
    bits, ef = ONN_CASES[case]
    ph = PhotonicsConfig(fidelity="onn")
    monkeypatch.setattr(runtime, "_CACHE", {})
    _check_photonic_sync(jax_sync, case, peers, ph, bits, ef,
                         ONNModule.from_params(runtime.onn_config(ph, 8, peers),
                                               _onn8_params()), capsys)


@pytest.mark.parametrize("peers", MESH_PEERS)
@pytest.mark.parametrize("case", list(MESH_CASES))
def test_mesh_sync_matches_jax_shard_map(jax_sync, case, peers, monkeypatch,
                                         capsys):
    """optinc at fidelity 'mesh' on either executor against the JAX
    sync_gradients under shard_map on the same executor
    (``_check_photonic_sync``): every mesh through the plain mesh_scan,
    the approx ONN of ``_mesh8_params`` at bits 8."""
    bits, ef, backend = MESH_CASES[case]
    ph = PhotonicsConfig(fidelity="mesh", mesh_backend=backend)
    monkeypatch.setattr(runtime, "_CACHE", {})
    _check_photonic_sync(jax_sync, case, peers, ph, bits, ef,
                         _mesh8_module(peers, ONNModule, tonn.ONNConfig),
                         capsys)
