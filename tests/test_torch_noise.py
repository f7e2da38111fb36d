"""The PhaseNoise model and the per-step sync key of the port on the CPU
(``repro_torch.prng``, ``photonics.pipeline.PhaseNoise``, the noise
branches of ``photonics.mesh`` and the keyed optinc sync), held against
the JAX package where the arithmetic is shared.

The port's keys are not threefry keys, so its draws are not JAX's: the
drift's arithmetic is held against JAX's on JAX's own gaussian, and the
rest is held to the properties JAX's tests pin (tests/test_pipeline.py):
std 0 is the noise-free path bit for bit, the same key gives the same
numbers and another key others, a drifted mesh stays a rotation, and a
noisy config without a key raises.  Nothing here builds or launches CUDA.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.photonics.pipeline import PhaseNoise as JaxPhaseNoise
from repro_torch import prng
from repro_torch.collectives import backends, engine
from repro_torch.kernels import mesh_scan as tk
from repro_torch.photonics import (PhotonicsConfig, mesh, mzi, onn, pipeline,
                                   runtime)
from repro_torch.photonics.module import ONNModule
from repro_torch.photonics.pipeline import PhaseNoise

# the drifted coefficients, port vs jitted JAX on the same gaussians: one
# cos and one sin of each libm and a few products (a few ulp of 1)
PERTURB_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _orthogonal(m, seed):
    return np.linalg.qr(np.random.default_rng(seed).normal(size=(m, m)))[0]


def _partial_mesh(m, seed):
    """A compiled mesh whose rotations touch only the first m/2 wires."""
    q = np.eye(m)
    q[:m // 2, :m // 2] = _orthogonal(m // 2, seed)
    return mesh.MZIMesh.compile(mzi.givens_decompose(q))


def _stack(m, blocks, seed):
    return mesh._stack_meshes([mesh.MZIMesh.compile(mzi.givens_decompose(
        _orthogonal(m, seed + b))) for b in range(blocks)])


def _x(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


# -------------------------------------------------------------- the keys
def test_key_tree_is_fixed_and_its_branches_distinct():
    base = prng.PRNGKey(8)
    assert base == prng.PRNGKey(8) != prng.PRNGKey(9)
    assert all(0 <= k < 2 ** 64 for k in (base, prng.fold_in(base, 3)))
    children = ([prng.fold_in(base, i) for i in range(64)]
                + prng.split(base, 64) + [base])
    assert len(set(children)) == len(children)
    assert prng.split(base, 3) == prng.split(base, 5)[:3]
    seeds = prng.bits32(base, 4)
    assert all(0 <= s < 2 ** 32 for s in seeds) and len(set(seeds)) == 4
    a = prng.normal(base, (3, 5))
    assert a.dtype == torch.float32 and a.shape == (3, 5)
    assert torch.equal(a, prng.normal(base, (3, 5)))
    assert not torch.equal(a, prng.normal(prng.fold_in(base, 0), (3, 5)))


# -------------------------------------------------------------- perturb
@pytest.mark.parametrize("m,blocks", [(16, 1), (64, 1), (8, 3)])
def test_perturb_is_jax_arithmetic_on_jax_gaussians(m, blocks):
    """The port's drift of the (B, L, m) stacks on the gaussians JAX's
    ``PhaseNoise.perturb`` draws (jitted) gives JAX's coefficients within
    PERTURB_ATOL; the layers stay rotations and untouched wires exactly
    what they were."""
    stacked = mesh._stack_meshes([_partial_mesh(m, m + b)
                                  for b in range(blocks)])
    perm, ca, sa = (np.asarray(getattr(stacked, k)) for k in
                    ("perm", "ca", "sa"))
    key = jax.random.PRNGKey(m + blocks)
    jnoise = JaxPhaseNoise(theta_drift_std=0.05)
    want_ca, want_sa = (np.asarray(v) for v in jax.jit(jnoise.perturb)(
        key, jnp.asarray(perm), jnp.asarray(ca), jnp.asarray(sa)))
    g = np.array(jax.random.normal(key, perm.shape, jnp.float32))
    got_ca, got_sa = (v.numpy() for v in PhaseNoise(0.05).perturb_with(
        torch.from_numpy(g), stacked.perm, stacked.ca, stacked.sa))
    np.testing.assert_allclose(got_ca, want_ca, rtol=0, atol=PERTURB_ATOL)
    np.testing.assert_allclose(got_sa, want_sa, rtol=0, atol=PERTURB_ATOL)
    np.testing.assert_allclose(got_ca ** 2 + got_sa ** 2, 1.0, atol=1e-6)
    alone = perm == np.arange(perm.shape[-1])
    np.testing.assert_array_equal(got_ca[alone], ca[alone])
    np.testing.assert_array_equal(got_sa[alone], sa[alone])
    assert np.abs(got_ca - ca).max() > 1e-4
    # the two wires of a rotation (sa = -sin on the lower, +sin on the
    # upper wire) turn by the same angle
    up = np.where(np.arange(perm.shape[-1]) < perm, -1.0, 1.0)
    turn = np.arctan2(up * got_sa, got_ca) - np.arctan2(up * sa, ca)
    pair = np.take_along_axis(turn, perm.astype(np.int64), -1)
    np.testing.assert_allclose(np.sin(turn - pair), 0.0, atol=1e-5)


def test_drift_and_shot_off_without_std_or_key():
    st = _partial_mesh(16, 0)
    for noise, key in ((PhaseNoise(0.0, 0.01), 5), (PhaseNoise(0.1), None)):
        ca, sa = noise.perturb(key, st.perm, st.ca, st.sa)
        assert ca is st.ca and sa is st.sa
    y = _x((4, 16), 0)
    assert PhaseNoise(0.1, 0.0).shot(5, y) is y
    assert PhaseNoise(0.0, 0.1).shot(None, y) is y
    assert not PhaseNoise().enabled and PhaseNoise(0.0, 0.1).enabled
    assert PhaseNoise.from_config(PhotonicsConfig(fidelity="mesh")) is None
    assert PhaseNoise.from_config(PhotonicsConfig(
        fidelity="mesh", theta_drift_std=0.02)) == PhaseNoise(0.02, 0.0)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_std0_is_the_noise_free_path_bit_for_bit(backend):
    """A zero PhaseNoise with a key is the noise-free executor bit for
    bit, for one mesh, a stacked mesh, and a whole mesh ONN."""
    zero = PhaseNoise(0.0, 0.0)
    emu, x = _partial_mesh(16, 1), _x((9, 16), 1)
    assert torch.equal(emu.apply(x, backend=backend),
                       emu.apply(x, backend=backend, noise=zero, key=3))
    st, xb = _stack(8, 3, 2), _x((9, 3, 8), 2)
    assert torch.equal(
        mesh._apply_stacked(st, xb, True, backend),
        mesh._apply_stacked(st, xb, True, backend, noise=zero, key=3))
    module = _approx_module(0)
    a = _x((33, 4), 3).abs() * 3
    assert torch.equal(module.apply_mesh(a, backend),
                       module.apply_mesh(a, backend, noise=zero, key=3))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_noise_is_a_function_of_the_key(backend):
    """The same key gives the same output, another key another; the
    drifted mesh is still orthogonal (phase error, not loss); shot noise
    alone moves the output too."""
    emu = mesh.MZIMesh.compile(mzi.givens_decompose(_orthogonal(16, 4)))
    x = _x((6, 16), 4)
    noise = PhaseNoise(theta_drift_std=0.05)
    clean = emu.apply(x, backend=backend)
    y = emu.apply(x, backend=backend, noise=noise, key=42)
    assert torch.equal(y, emu.apply(x, backend=backend, noise=noise, key=42))
    assert (y - clean).abs().max() > 1e-4
    assert not torch.equal(y, emu.apply(x, backend=backend, noise=noise,
                                        key=43))
    mat = emu.apply(torch.eye(16), backend=backend, noise=noise, key=42).T
    np.testing.assert_allclose((mat @ mat.T).numpy(), np.eye(16), atol=1e-5)
    shot = emu.apply(x, backend=backend, noise=PhaseNoise(0.0, 0.01), key=42)
    assert 0 < (shot - clean).abs().max() < 0.1


def test_each_executor_draws_its_model_from_the_key_tree():
    """'pallas' launches the kernel's in-kernel drift with uint32 seeds
    from the theta key, and adds shot noise over the whole output from
    the shot key; 'xla' gives each block its own key (as JAX's vmap
    does), drifts its stacks in tensor ops and launches without drift."""
    noise = PhaseNoise(0.05, 0.01)
    st, x, key = _stack(8, 3, 5), _x((7, 8), 5), 77
    post = _x((3, 8), 6)
    k_theta, k_shot = prng.split(key)
    seeds = torch.tensor(prng.bits32(k_theta, 3))
    y = tk.mesh_scan_blocks(st.signs, st.perm, st.ca, st.sa, x,
                            post_scale=post, theta_std=0.05, seeds=seeds)
    want = noise.shot(k_shot, y)
    got = mesh._apply_stacked(st, x, False, "pallas", post, noise, key)
    assert torch.equal(got, want)
    one = mesh.MZIMesh(8, 1, st.signs[0], st.perm[0], st.ca[0], st.sa[0])
    ys = []
    for b, kb in enumerate(prng.split(key, 3)):
        kt, ks = prng.split(kb)
        ca, sa = noise.perturb(kt, st.perm[b], st.ca[b], st.sa[b])
        ys.append(noise.shot(ks, tk.mesh_scan(
            st.signs[b], st.perm[b], ca, sa, x, post_scale=post[b])))
    assert torch.equal(mesh._apply_stacked(st, x, False, "xla", post, noise,
                                           key), torch.stack(ys, dim=-2))
    k_theta, k_shot = prng.split(9)
    want = noise.shot(k_shot, tk.mesh_scan(
        one.signs, one.perm, one.ca, one.sa, x, theta_std=0.05,
        seed=torch.tensor(prng.bits32(k_theta, 1))))
    assert torch.equal(one.apply(x, backend="pallas", noise=noise, key=9),
                       want)


def test_meshes_without_rotations_take_only_the_shot_noise(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a mesh without rotations launched the kernel")

    monkeypatch.setattr(mesh, "mesh_scan", refuse)
    monkeypatch.setattr(mesh, "mesh_scan_blocks", refuse)
    module = ONNModule.exact_identity(bits=2, n_servers=4)
    a = torch.arange(13, dtype=torch.float32)[:, None] / 4
    for backend in ("xla", "pallas"):
        clean = module.apply_mesh(a, backend)
        assert torch.equal(module.apply_mesh(
            a, backend, noise=PhaseNoise(0.3), key=1), clean)
        noisy = module.apply_mesh(a, backend, noise=PhaseNoise(0.0, 0.01),
                                  key=1)
        assert 0 < (noisy - clean).abs().max() < 0.1


@pytest.mark.parametrize("std", [0.01, 0.2])
def test_shot_noise_statistics(std):
    n = 200_000
    y = torch.zeros(n)
    a = PhaseNoise(0.0, std).shot(11, y)
    b = PhaseNoise(0.0, std).shot(12, y)
    for z in (a, b):
        assert abs(z.mean().item()) < 5 * std / n ** 0.5
        assert abs(z.std().item() / std - 1) < 0.01
    corr = np.corrcoef(a.numpy(), b.numpy())[0, 1]
    assert abs(corr) < 5 / n ** 0.5
    assert torch.equal(a, PhaseNoise(0.0, std).shot(11, y))


# ------------------------------------------------------------- the sync
def _approx_module(seed, peers=4):
    """A seeded bits-8 ONN 4-8-4, both layers projected onto Sigma_a U_a
    (a tall and a wide stack of two 4-wire meshes)."""
    cfg = onn.ONNConfig(structure=(4, 8, 4), approx_layers=(1, 2), bits=8,
                        n_servers=peers, k_inputs=4)
    return ONNModule.from_params(cfg, onn.project_approx(
        ONNModule.init(cfg, seed).params, cfg))


def _sync_cfg(bits, **noise):
    return engine.SyncConfig(mode="optinc", bits=bits, block=64,
                             bucket_bytes=256 * 4,
                             photonics=PhotonicsConfig(fidelity="mesh",
                                                       **noise))


@pytest.fixture
def installed(monkeypatch):
    monkeypatch.setattr(runtime, "_CACHE", {})
    runtime.put_module(PhotonicsConfig(fidelity="mesh"), 8, 4,
                       _approx_module(1))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_noisy_sync_follows_the_jax_key_tree(backend, installed):
    """sync_flat splits the step key into one key a bucket; the backend
    folds 1 off it for the noise; the pipeline folds the stage index, the
    mesh ONN the layer index.  The same step key gives the same synced
    gradients, another step's key others; std 0 with a key is the
    noise-free sync bit for bit."""
    flat = _x((4, 700), 7)
    bounds = [(0, 256), (256, 512), (512, 700)]
    cfg = _sync_cfg(8, theta_drift_std=0.05, shot_noise_std=0.01,
                    mesh_backend=backend)
    step = prng.fold_in(prng.PRNGKey(1), 3)
    got, _ = engine.sync_flat(flat, bounds, cfg, key=step)
    again, _ = engine.sync_flat(flat, bounds, cfg, key=step)
    assert torch.equal(got, again)
    other, _ = engine.sync_flat(flat, bounds, cfg,
                                key=prng.fold_in(prng.PRNGKey(1), 4))
    assert not torch.equal(got, other)
    clean_cfg = dataclasses.replace(cfg, photonics=dataclasses.replace(
        cfg.photonics, theta_drift_std=0.0, shot_noise_std=0.0))
    clean, _ = engine.sync_flat(flat, bounds, clean_cfg)
    assert torch.equal(clean, engine.sync_flat(flat, bounds, clean_cfg,
                                               key=step)[0])
    assert not torch.equal(got, clean)
    # by hand: bucket b's key, the noise key, the pipeline's stages
    module = runtime.get_module(cfg.photonics, 8, 4)
    noise = PhaseNoise.from_config(cfg.photonics)
    for (s, e), kb in zip(bounds, prng.split(step, len(bounds))):
        x = flat[:, s:e]
        scale = backends._shared_scale(x, cfg)
        u = backends._encode(x, scale, cfg)
        pipe = pipeline.level_pipeline(module, 8, fidelity="mesh",
                                       mesh_backend=backend, noise=noise)
        u_avg = pipe.run(u.reshape(4, -1), key=prng.fold_in(kb, 1)).data
        want, _ = backends._finish(u_avg, 1, u, x, scale, cfg)
        assert torch.equal(got[s:e], want)


def test_noise_without_a_step_key_raises(installed):
    """A noisy config without a key would train noise-free in silence."""
    cfg = _sync_cfg(8, theta_drift_std=0.1)
    with pytest.raises(ValueError, match="per-step sync key"):
        backends.OptincBackend().sync(_x((4, 64), 8), cfg, None)
    with pytest.raises(ValueError, match="per-step sync key"):
        engine.sync_flat(_x((4, 64), 8), [(0, 64)], cfg)
    with pytest.raises(ValueError, match="only apply to --fidelity mesh"):
        engine.SyncConfig(photonics=PhotonicsConfig(fidelity="onn",
                                                    shot_noise_std=0.1))


def test_bits2_noise_is_shot_noise_on_the_exact_identity(monkeypatch):
    """At bits 2 the exact identity has no rotation: drift alone leaves
    the sync equal to behavioral, shot noise moves decisions near the
    ties of the 4-peer average."""
    monkeypatch.setattr(runtime, "_CACHE", {})
    flat = _x((4, 512), 9)
    bounds = [(0, 256), (256, 512)]
    beh, _ = engine.sync_flat(flat, bounds, engine.SyncConfig(
        mode="optinc", bits=2, block=64))
    drift, _ = engine.sync_flat(flat, bounds, _sync_cfg(
        2, theta_drift_std=0.5), key=1)
    assert torch.equal(drift, beh)
    shot, _ = engine.sync_flat(flat, bounds, _sync_cfg(
        2, shot_noise_std=0.2), key=1)
    assert not torch.equal(shot, beh)
