"""The port's MZI-mesh path on the CPU (``repro_torch.photonics.mzi``,
``approx``, ``mesh``, the ``mesh`` fidelity of ``ONNModule`` and the
plain version of the ``mesh_scan`` kernel), held against the JAX package
on the same numpy-seeded inputs.

Givens programming is numpy in both packages and is held bit for bit.
The plain kernel computes each rotation layer as ``fma(ca, y, sa *
y[perm])``, the form XLA compiles the JAX scan into, so the noise-free
mesh is held bit for bit against the JAX executor (jitted, as the sync
runs it) and the Pallas kernel in interpret mode.  The theta drift goes
through libm (log, cos, sin), whose ulps differ between the frameworks:
its hash words are held bit for bit and its outputs to a tolerance.
Nothing here builds or launches CUDA.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import mesh_scan as jk
from repro.photonics import encoding as jenc
from repro.photonics import mesh as jmesh
from repro.photonics import mzi as jmzi
from repro.photonics import onn as jonn
from repro.photonics.module import ONNModule as JaxONNModule
from repro_torch.kernels import mesh_scan as tk
from repro_torch.kernels import ref
from repro_torch.photonics import encoding, mesh, mzi, onn
from repro_torch.photonics.module import ONNModule

# the theta drift, plain vs the Pallas kernel: the same hash words and
# Box-Muller, but log/cos/sin of two libms, a few ulp per normal, through
# up to 125 layers; relative to the largest output
THETA_RTOL = 1e-5
# one normal of the drift field, plain vs JAX: log, sqrt and cos of two
# libms, relative to the normal (each within 1-2 ulp)
NORMAL_RTOL = 1e-6
# the f64 mesh ONN against the numpy f64 oracle (the JAX package's bar)
ORACLE_TOL = 1e-6
# the f32 mesh ONN against JAX's where XLA compiles the glue around the
# meshes in another form (see test_mesh_onn_matches_jax_f32), relative to
# the largest output: a few f32 roundings
GLUE_RTOL = 1e-6
# project_approx, torch.linalg.svd vs jnp.linalg.svd in f32
PROJECT_TOL = 1e-5


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(a):
    return torch.from_numpy(np.array(a))


def _orthogonal(m, seed):
    rng = np.random.default_rng(seed)
    return np.linalg.qr(rng.normal(size=(m, m)))[0]


def _port_cfg(jcfg):
    return onn.ONNConfig(structure=jcfg.structure,
                         approx_layers=jcfg.approx_layers, bits=jcfg.bits,
                         n_servers=jcfg.n_servers, k_inputs=jcfg.k_inputs)


# ------------------------------------------------------- Givens programs
@pytest.mark.parametrize("m", [2, 5, 16, 64])
def test_givens_programs_and_compiled_meshes_match_jax(m):
    q = _orthogonal(m, m)
    prog, jprog = mzi.givens_decompose(q), jmzi.givens_decompose(q)
    assert prog.rotations == jprog.rotations
    np.testing.assert_array_equal(prog.signs, jprog.signs)
    np.testing.assert_array_equal(mzi.reconstruct(prog),
                                  jmzi.reconstruct(jprog))
    emu, jemu = mesh.MZIMesh.compile(prog), jmesh.MZIMesh.compile(jprog)
    assert (emu.dim, emu.n_rot, emu.depth, emu.num_rotations) == (
        jemu.dim, jemu.n_rot, jemu.depth, jemu.num_rotations)
    for name in ("signs", "perm", "ca", "sa"):
        got, want = getattr(emu, name), np.asarray(getattr(jemu, name))
        assert str(got.dtype).split(".")[-1] == str(want.dtype), name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    # the executor rebuilds the matrix: f64 within 1e-12 of the numpy
    # oracle, f32 that of JAX's executor (bit for bit from two layers on;
    # the 2-wire mesh has one, see test_mesh_onn_matches_jax_f32)
    np.testing.assert_allclose(
        mesh.reconstruct(prog, torch.float64).numpy(), q, rtol=0, atol=1e-12)
    got, want = mesh.reconstruct(prog).numpy(), np.asarray(
        jmesh.reconstruct(jprog))
    if emu.depth > 1:
        np.testing.assert_array_equal(got, want)
    assert np.abs(got - want).max() <= 1e-6
    # a shallower program (a rotation in the first two planes only) pads
    # to the deepest with identity layers, as JAX stacks it
    few = np.eye(m)
    few[:2, :2] = [[0.6, -0.8], [0.8, 0.6]]
    progs = [prog, mzi.givens_decompose(few)]
    jprogs = [jprog, jmzi.givens_decompose(few)]
    st = mesh._stack_meshes([mesh.MZIMesh.compile(p) for p in progs])
    jst = jmesh._stack_meshes([jmesh.MZIMesh.compile(p) for p in jprogs])
    assert (st.dim, st.n_rot) == (jst.dim, jst.n_rot)
    for name in ("signs", "perm", "ca", "sa"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)


# ------------------------------------------ the plain kernel, noise-free
@functools.lru_cache(maxsize=None)
def _stack(m, blocks):
    """B random same-width JAX programs stacked, built once per module."""
    return jmesh._stack_meshes([
        jmesh.MZIMesh.compile(jmzi.givens_decompose(_orthogonal(m, 97 * m + b)))
        for b in range(blocks)])


def _port_stack(jst):
    return [_t(getattr(jst, k)) for k in ("signs", "perm", "ca", "sa")]


@functools.lru_cache(maxsize=None)
def _jax_xla(m, blocks, x_blocked, transpose, with_post):
    """The JAX xla executor over a stack, jitted: ``_apply_stacked``
    forward; the transpose (which ``_apply_stacked`` does not take) as
    ``MZIMesh.apply(transpose=True)`` per block, as its vmap runs it."""
    st = _stack(m, blocks)

    def f(x, post):
        if not transpose:
            return jmesh._apply_stacked(st, x, x_blocked, backend="xla",
                                        post_scale=post)
        outs = []
        for b in range(blocks):
            one = jmesh.MZIMesh(m, 1, st.signs[b], st.perm[b], st.ca[b],
                                st.sa[b])
            outs.append(one.apply(x[..., b, :] if x_blocked else x,
                                  transpose=True,
                                  post_scale=None if post is None
                                  else post[b]))
        return jnp.stack(outs, -2)

    if with_post:
        return jax.jit(f)
    return jax.jit(lambda x: f(x, None))


# (m, B, x_blocked, transpose, post_scale, rows): every m and B of the
# list, shared and blocked x, both transposes, with and without the
# epilogue, rows ragged against the 8-row tile
KERNEL_CASES = [(4, 3, False, False, True, 37), (4, 1, False, True, False, 9),
                (12, 3, True, True, False, 21), (12, 4, True, False, True, 5),
                (16, 4, False, True, True, 20), (16, 1, False, False, False, 3),
                (64, 1, False, False, True, 13), (64, 4, True, True, True, 11)]


@pytest.mark.parametrize("case", KERNEL_CASES,
                         ids=lambda c: "m{}-B{}-{}-{}-{}-r{}".format(
                             c[0], c[1], "blocked" if c[2] else "shared",
                             "T" if c[3] else "F",
                             "post" if c[4] else "nopost", c[5]))
def test_plain_kernel_is_the_jax_kernel_and_executor_bit_for_bit(case):
    m, blocks, x_blocked, transpose, with_post, rows = case
    st = _stack(m, blocks)
    rng = np.random.default_rng(m + blocks + rows)
    x = rng.normal(size=(rows, blocks, m) if x_blocked
                   else (rows, m)).astype(np.float32)
    post = (rng.normal(size=(blocks, m)).astype(np.float32)
            if with_post else None)
    got = tk.mesh_scan_blocks(*_port_stack(st), _t(x),
                              x_block_axis=x_blocked, transpose=transpose,
                              post_scale=None if post is None else _t(post),
                              blk_b=8).numpy()
    pallas = np.asarray(jk.mesh_scan_blocks(
        st.signs, st.perm, st.ca, st.sa, jnp.asarray(x),
        x_block_axis=x_blocked, transpose=transpose, post_scale=post,
        interpret=True, blk_b=8))
    xla_fn = _jax_xla(m, blocks, x_blocked, transpose, with_post)
    xla = np.asarray(xla_fn(jnp.asarray(x), post) if with_post
                     else xla_fn(jnp.asarray(x)))
    assert got.shape == pallas.shape == xla.shape == (rows, blocks, m)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)


def test_plain_kernel_m256_is_the_jax_executor_bit_for_bit():
    """The widest mesh of the main path (m = 256, L = 509), 16 rows, both
    directions, against the jitted xla executor (the interpret-mode
    Pallas kernel is slow at this depth)."""
    st = _stack(256, 1)
    assert st.perm.shape[1] == 509
    x = np.random.default_rng(256).normal(size=(16, 256)).astype(np.float32)
    emu = jmesh.MZIMesh(256, 1, st.signs[0], st.perm[0], st.ca[0], st.sa[0])
    port = mesh.MZIMesh(256, 1, *(t[0] for t in _port_stack(st)))
    for transpose in (False, True):
        want = np.asarray(jax.jit(lambda v: emu.apply(
            v, transpose=transpose))(jnp.asarray(x)))
        np.testing.assert_array_equal(
            port.apply(_t(x), transpose=transpose).numpy(), want)


# ----------------------------------------------------------- theta drift
@pytest.mark.parametrize("seed", [0, 1, 0x9E3779B9, 0xFFFFFFFF])
def test_drift_hash_and_normals_match_jax(seed):
    """Every counter of a (509, 256) field: the hash words equal JAX's
    ``_mix32``, u1 and u2 are exact, the normals within NORMAL_RTOL."""
    n_layers, m = 509, 256
    row = jax.lax.broadcasted_iota(jnp.uint32, (n_layers, m), 0)
    col = jax.lax.broadcasted_iota(jnp.uint32, (n_layers, m), 1)
    base = (row * jnp.uint32(m) + col) * jnp.uint32(0x9E3779B9) \
        + jnp.uint32(seed)
    words = jax.jit(lambda c: (jk._mix32(c),
                               jk._mix32(c ^ jnp.uint32(0x85EBCA6B))))
    h1, h2 = (np.asarray(h).astype(np.int64) for h in words(base))
    lw = torch.arange(n_layers * m, dtype=torch.int64).reshape(n_layers, m)
    c = (ref._mul32(lw, 0x9E3779B9) + seed) & 0xFFFFFFFF
    np.testing.assert_array_equal(c.numpy(), np.asarray(base).astype(np.int64))
    np.testing.assert_array_equal(ref.mix32_ref(c).numpy(), h1)
    np.testing.assert_array_equal(ref.mix32_ref(c ^ 0x85EBCA6B).numpy(), h2)
    u1, u2 = ref.drift_uniforms_ref(seed, n_layers, m)
    two24 = np.float32(2.0 ** -24)
    np.testing.assert_array_equal(
        u1.numpy(), ((h1 >> 8).astype(np.float32) + 1) * two24)
    np.testing.assert_array_equal(u2.numpy(),
                                  (h2 >> 8).astype(np.float32) * two24)
    g = ref.normal_field_ref(seed, n_layers, m).numpy()
    want = np.asarray(jax.jit(lambda s: jk._normal_field(
        s, n_layers, m, jnp.float32))(jnp.uint32(seed)))
    assert np.all(np.abs(g - want) <= NORMAL_RTOL * np.abs(want))
    assert abs(g.mean()) < 0.01 and abs(g.std() - 1.0) < 0.01


@pytest.mark.parametrize("case", [(4, 3, False, False), (12, 2, True, True),
                                  (64, 2, True, False), (64, 1, False, True)],
                         ids=lambda c: f"m{c[0]}-B{c[1]}-"
                                       f"{'blocked' if c[2] else 'shared'}-"
                                       f"{'T' if c[3] else 'F'}")
def test_plain_theta_drift_matches_the_jax_kernel(case):
    """theta_std 0.05 with given seeds against the interpret-mode Pallas
    kernel within THETA_RTOL of max|y|; theta_std 0 with seeds is the
    noise-free result bit for bit."""
    m, blocks, x_blocked, transpose = case
    st = _stack(m, blocks)
    rng = np.random.default_rng(m * blocks)
    x = rng.normal(size=(29, blocks, m) if x_blocked
                   else (29, m)).astype(np.float32)
    post = rng.normal(size=(blocks, m)).astype(np.float32)
    seeds = np.array([0, 0xFFFFFFFF, 0x9E3779B9][:blocks], np.uint32)
    kw = dict(x_block_axis=x_blocked, transpose=transpose)
    want = np.asarray(jk.mesh_scan_blocks(
        st.signs, st.perm, st.ca, st.sa, jnp.asarray(x), post_scale=post,
        interpret=True, blk_b=8, theta_std=0.05, seeds=jnp.asarray(seeds),
        **kw))
    args = (*_port_stack(st), _t(x))
    tseeds = _t(seeds.astype(np.int64))
    got = tk.mesh_scan_blocks(*args, post_scale=_t(post), theta_std=0.05,
                              seeds=tseeds, **kw).numpy()
    clean = tk.mesh_scan_blocks(*args, post_scale=_t(post), **kw).numpy()
    assert np.abs(got - want).max() <= THETA_RTOL * np.abs(want).max()
    assert np.abs(got - clean).max() > 100 * THETA_RTOL * np.abs(want).max()
    np.testing.assert_array_equal(
        tk.mesh_scan_blocks(*args, post_scale=_t(post), theta_std=0.0,
                            seeds=tseeds, **kw).numpy(), clean)


def test_theta_drift_leaves_untouched_wires_exact():
    """Wires no MZI touches (perm == self in every layer) get eps = 0
    exactly: with the drift on they still pass x * signs through bit for
    bit, while the rotated wires move."""
    q = np.eye(8)
    q[:4, :4] = _orthogonal(4, 3)
    emu = mesh.MZIMesh.compile(mzi.givens_decompose(q))
    assert (emu.perm[:, 4:] == torch.arange(4, 8, dtype=torch.int32)).all()
    x = _t(np.random.default_rng(5).normal(size=(50, 8)).astype(np.float32))
    for transpose in (False, True):
        clean = tk.mesh_scan(emu.signs, emu.perm, emu.ca, emu.sa, x,
                             transpose=transpose)
        noisy = tk.mesh_scan(emu.signs, emu.perm, emu.ca, emu.sa, x,
                             transpose=transpose, theta_std=0.3,
                             seed=torch.tensor(7))
        assert torch.equal(noisy[:, 4:], x[:, 4:] * emu.signs[4:])
        assert (noisy[:, :4] - clean[:, :4]).abs().max() > 1e-3


# --------------------------------------------------------------- the ONN
# the three ONNConfig structures of tests/test_photonics.py ORACLE_X64
ORACLE_CFGS = [
    jonn.ONNConfig(structure=(2, 64, 128, 64, 2), approx_layers=(2, 3),
                   bits=4, n_servers=2, k_inputs=2),
    jonn.ONNConfig(structure=(4, 32, 64, 32, 4), approx_layers=(),
                   bits=8, n_servers=4, k_inputs=4),
    jonn.ONNConfig(structure=(1, 4, 1), approx_layers=(), bits=2,
                   n_servers=3, k_inputs=1),
]
# the scenario-1 widths cut to 4-64-128-64-4, every layer approximated:
# tall layers of 16 blocks of 4 and 2 of 64, wide ones of 2 of 64 and 16
# of 4 (the 16-block sum)
APPROX_CFG = jonn.ONNConfig(structure=(4, 64, 128, 64, 4),
                            approx_layers=(1, 2, 3, 4), bits=8,
                            n_servers=4, k_inputs=4)


@pytest.mark.parametrize("i", range(len(ORACLE_CFGS)))
def test_mesh_onn_f64_matches_the_numpy_oracle(i):
    cfg = _port_cfg(ORACLE_CFGS[i])
    params = onn.project_approx(onn.init_params(cfg, i, "cpu"), cfg)
    hw = onn.map_to_hardware(params, cfg)
    progs = mesh.compile_hardware(hw, torch.float64)
    a = np.random.default_rng(i).uniform(0, cfg.in_scale,
                                         size=(32, cfg.structure[0]))
    got = mesh.apply_hardware(progs, _t(a), cfg).numpy()
    want = onn.apply_hardware(hw, a, cfg)
    assert np.abs(got - want).max() <= ORACLE_TOL
    # and the dense ONN of the projected weights computes the same map
    dense = onn.apply(params, _t(a).float(), cfg).numpy()
    assert np.abs(dense - want).max() <= 1e-4 * max(np.abs(want).max(), 1)


@functools.lru_cache(maxsize=None)
def _jax_onn(i):
    """(cfg, projected f32 params, compiled programs) of ORACLE_CFGS[i] or
    (i = 3) APPROX_CFG, from JAX's init and project_approx."""
    cfg = (ORACLE_CFGS + [APPROX_CFG])[i]
    params = jonn.project_approx(jonn.init_params(cfg, jax.random.PRNGKey(i)),
                                 cfg)
    params = [{k: np.asarray(l[k]) for k in ("w", "b")} for l in params]
    return cfg, params, jmesh.compile_hardware(jonn.map_to_hardware(params,
                                                                    cfg))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("i", [0, 1, 3])
def test_mesh_onn_matches_jax_f32(i, backend):
    """The port's f32 mesh ONN against JAX's jitted ``mesh.apply_hardware``
    on carried weights (JAX's projected f32 params, programmed by each
    package's own numpy mapping).

    Bit for bit against the pallas backend, except ORACLE_CFGS[0]: its
    2-wire meshes have ONE rotation layer, and in interpret mode the
    kernel is inlined into the jitted graph, where XLA unrolls a
    one-layer loop and contracts the other product, fma(sa, y[perm],
    ca * y).  Against the xla backend all within GLUE_RTOL of max|y|: XLA
    also fuses the wide approx layer's Sigma_a epilogue into its block
    sum, and unrolls one-layer scans the same way."""
    jcfg, params, jprogs = _jax_onn(i)
    cfg = _port_cfg(jcfg)
    progs = mesh.compile_hardware(onn.map_to_hardware(params, cfg))
    for p, jp in zip(progs, jprogs):
        meshes = ((p.u, jp.u), (p.v, jp.v)) if hasattr(p, "u") \
            else ((p.meshes, jp.meshes),)
        for mt, mj in meshes:
            for name in ("perm", "ca", "sa", "signs"):
                np.testing.assert_array_equal(getattr(mt, name).numpy(),
                                              np.asarray(getattr(mj, name)))
    a = np.random.default_rng(i).uniform(
        0, jcfg.in_scale, size=(64, jcfg.structure[0])).astype(np.float32)
    got = mesh.apply_hardware(progs, _t(a), cfg, backend=backend).numpy()
    want = np.asarray(jax.jit(lambda x: jmesh.apply_hardware(
        jprogs, x, jcfg, backend=backend))(jnp.asarray(a)))
    if backend == "pallas" and i != 0:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= GLUE_RTOL * np.abs(want).max()


@pytest.mark.parametrize("i", [0, 3])
def test_project_approx_matches_jax(i):
    jcfg = (ORACLE_CFGS + [APPROX_CFG])[i]
    cfg = _port_cfg(jcfg)
    raw = jonn.init_params(jcfg, jax.random.PRNGKey(10 + i))
    want = jonn.project_approx(raw, jcfg)
    got = onn.project_approx(
        [{k: _t(np.asarray(l[k])) for k in ("w", "b")} for l in raw], cfg)
    for idx, (g, w) in enumerate(zip(got, want), start=1):
        if idx in cfg.approx_layers:
            assert np.abs(g["w"].numpy() - np.asarray(w["w"])).max() \
                <= PROJECT_TOL
        else:
            np.testing.assert_array_equal(g["w"].numpy(), np.asarray(w["w"]))


def test_exact_identity_mesh_symbols_skip_the_kernel(monkeypatch):
    """All 27 three-server codes at bits 2 through ``symbols(fidelity=
    'mesh')`` on both backends equal Q(mean) and JAX's; the exact
    identity's meshes have zero rotations, so the kernel is never
    called."""
    def refuse(*a, **k):
        raise AssertionError("the zero-rotation path launched the kernel")

    monkeypatch.setattr(mesh, "mesh_scan", refuse)
    monkeypatch.setattr(mesh, "mesh_scan_blocks", refuse)
    module = ONNModule.exact_identity(bits=2, n_servers=3)
    jmodule = JaxONNModule.exact_identity(bits=2, n_servers=3)
    assert all(getattr(p, "u").n_rot == getattr(p, "v").n_rot == 0
               for p in module.programs)
    codes = np.stack(np.meshgrid(*([np.arange(3)] * 3),
                                 indexing="ij")).reshape(3, -1)
    jsym = jenc.pam4_encode(jnp.asarray(codes), 2)
    ja = jenc.preprocess(jsym, 2, 1)
    want = np.asarray(jenc.expected_avg_symbols(jsym, 2))
    sym = encoding.pam4_encode(_t(codes), 2)
    a = encoding.preprocess(sym, 2, 1)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    for backend in ("xla", "pallas"):
        got = module.symbols(a, fidelity="mesh", mesh_backend=backend)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jmodule.symbols(ja, fidelity="mesh", mesh_backend=backend)))


# ------------------------------------ what the CUDA kernel relies on
def _programs(m):
    """A Givens program of a random orthogonal matrix, and a stack of it
    with shallower ones (a 2 x 2 rotation, a half-width matrix) padded
    with identity layers."""
    full = mesh.MZIMesh.compile(mzi.givens_decompose(_orthogonal(m, m + 1)))
    few = np.eye(m)
    few[:2, :2] = [[0.6, -0.8], [0.8, 0.6]]
    half = np.eye(m)
    half[:m // 2, :m // 2] = _orthogonal(m // 2, m + 2)
    parts = [full] + [mesh.MZIMesh.compile(mzi.givens_decompose(q))
                      for q in (few, half)]
    return full, mesh._stack_meshes(parts), [p.depth for p in parts]


@pytest.mark.parametrize("m", [2, 4, 9, 64, 256])
def test_programs_pair_neighbouring_wires(m):
    """Every compiled program, and every identity-padded stack of
    programs of different depths, pairs only neighbouring wires
    (|perm[w] - w| <= 1), perm is an involution, and a wire with no
    partner has ca = 1 and sa = 0 exactly: the kernel's partner by
    shuffle and its identity slot rely on this."""
    full, stack, depths = _programs(m)
    assert full.depth == max(1, 2 * m - 3)
    if m > 2:
        assert len(set(depths)) > 1 and stack.depth == max(depths)
    for st in (full, stack):
        perm, ca, sa = st.perm.long(), st.ca, st.sa
        wire = torch.arange(m)
        assert ((perm - wire).abs() <= 1).all()
        assert torch.equal(perm.gather(-1, perm), wire.expand_as(perm))
        alone = perm == wire
        assert (ca[alone] == 1).all() and (sa[alone] == 0).all()
        assert int((~alone).sum()) == 2 * st.n_rot   # two wires a rotation
        # no layer mixes pairs (2i, 2i + 1) with (2i + 1, 2i + 2): the
        # kernel's two aligned forms take every layer as it is
        assert _mixed_layers(st.perm) == 0
        tk.check_program(st.perm, st.sa)


def _mixed_program(m, n, seed):
    """n rotations on random adjacent planes in random order: a mesh
    whose greedy layers hold pairs of both alignments."""
    rng = np.random.default_rng(seed)
    rots = [(int(i), int(i) + 1, float(t)) for i, t in zip(
        rng.integers(0, m - 1, n), rng.uniform(-np.pi, np.pi, n))]
    signs = np.where(rng.random(m) < 0.5, -1.0, 1.0)
    return mesh.MZIMesh.compile(mzi.MZIProgram(m, rots, signs))


def _mixed_layers(perm):
    m = perm.shape[-1]
    low = torch.minimum(perm.long(), torch.arange(m))
    paired = perm.long() != torch.arange(m)
    return int(((paired & (low % 2 == 0)).any(-1)
                & (paired & (low % 2 == 1)).any(-1)).sum())


@pytest.mark.parametrize("m", [5, 9, 64])
def test_check_program_refuses_layers_that_mix_alignments(m):
    """A stack of a Givens program and a program whose layers mix both
    pair alignments, which the kernel's two layer forms cannot take: the
    wrapper refuses it on every device, and takes the Givens program
    alone."""
    givens = mesh.MZIMesh.compile(mzi.givens_decompose(_orthogonal(m, m + 3)))
    st = mesh._stack_meshes([_mixed_program(m, 3 * m, m), givens])
    assert _mixed_layers(st.perm) > 0
    x = _t(np.random.default_rng(m).normal(size=(37, m)).astype(np.float32))
    with pytest.raises(ValueError, match="mix them"):
        tk.check_program(st.perm, st.sa)
    for transpose in (False, True):
        with pytest.raises(ValueError, match="mix them"):
            tk.mesh_scan_blocks(st.signs, st.perm, st.ca, st.sa, x,
                                transpose=transpose)
    one = mesh._stack_meshes([givens])
    assert tk.mesh_scan_blocks(one.signs, one.perm, one.ca, one.sa,
                               x).shape == (37, 1, m)


@pytest.mark.parametrize("m", [2, 4, 9, 64, 256])
def test_check_program_refuses_what_the_kernel_cannot_take(m):
    """The wrapper refuses, on every device, a program with a partner
    that is not a neighbour or off the mesh, partners that do not pair
    up, or a wire with no partner and sa != 0."""
    _, stack, _ = _programs(m)
    x = torch.ones((3, m))
    assert tk.mesh_scan_blocks(stack.signs, stack.perm, stack.ca, stack.sa,
                               x).shape == (3, stack.perm.shape[0], m)
    bad = []
    far = stack.perm.clone()
    far[0, 0, 0] = m - 1 if m > 2 else -1      # not a neighbour / off
    bad.append((far, stack.sa, "neighbouring"))
    off = stack.perm.clone()
    off[0, 0, m - 1] = m                        # past the last wire
    bad.append((off, stack.sa, "neighbouring"))
    if m > 2:
        one_way = stack.perm.clone()            # wire 2 -> 1, 1 -> 1
        one_way[0, -1, :3] = torch.tensor([0, 1, 1], dtype=torch.int32)
        bad.append((one_way, stack.sa, "pair up"))
    alone = stack.sa.clone()
    ident = (stack.perm == torch.arange(m, dtype=torch.int32))
    if ident.any():
        alone[ident.nonzero()[0].unbind()] = 0.5
        bad.append((stack.perm, alone, "no partner"))
    for perm, sa, match in bad:
        with pytest.raises(ValueError, match=match):
            tk.check_program(perm, sa)
        with pytest.raises(ValueError, match=match):
            tk.mesh_scan_blocks(stack.signs, perm, stack.ca, sa, x)


def test_lane_layout_of_every_width():
    """W wires a lane (m / 32 rounded up to a power of two) and the rows
    a warp holds (16, at most 128 values a lane) at every width the
    kernel takes."""
    for m, w, r in ((1, 1, 16), (4, 1, 16), (32, 1, 16), (33, 2, 16),
                    (64, 2, 16), (100, 4, 16), (128, 4, 16), (129, 8, 16),
                    (256, 8, 16), (512, 16, 8), (1024, 32, 4)):
        assert (tk.lane_wires(m), tk.warp_rows(m)) == (w, r)
        assert 32 * w >= m and (w == 1 or 16 * w < m) and w * r <= 128


# ----------------------------------------------------------- the wrapper
def test_wrapper_routes_cpu_to_the_plain_version_and_checks_its_inputs(
        monkeypatch):
    st = _stack(12, 3)
    signs, perm, ca, sa = _port_stack(st)
    x = _t(np.random.default_rng(0).normal(size=(10, 12)).astype(np.float32))
    calls = []
    real = ref.mesh_scan_blocks_ref
    monkeypatch.setattr(ref, "mesh_scan_blocks_ref",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    launches = tk.mesh_scan_blocks.launches
    out = tk.mesh_scan_blocks(signs, perm, ca, sa, x)
    assert calls and out.shape == (10, 3, 12)
    assert tk.mesh_scan_blocks.launches == launches     # no kernel launch
    assert tk.mesh_scan(signs[0], perm[0], ca[0], sa[0], x).shape == (10, 12)
    assert tk.mesh_scan_blocks(signs, perm, ca, sa, x[:0]).shape == (0, 3, 12)
    # float64 runs on the CPU (the oracle tests); the kernel is f32 only
    f64 = [t.double() for t in (signs, ca, sa, x)]
    assert tk.mesh_scan_blocks(f64[0], perm, f64[1], f64[2],
                               f64[3]).dtype == torch.float64
    with pytest.raises(TypeError, match="share float32"):
        tk.mesh_scan_blocks(signs, perm, ca, sa, x.double())
    with pytest.raises(TypeError, match="int32"):
        tk.mesh_scan_blocks(signs, perm.long(), ca, sa, x)
    with pytest.raises(ValueError, match="x must be"):
        tk.mesh_scan_blocks(signs, perm, ca, sa, x[:, :5])
    with pytest.raises(ValueError, match="x must be"):
        tk.mesh_scan_blocks(signs, perm, ca, sa, x, x_block_axis=True)
    with pytest.raises(ValueError, match="ca must be"):
        tk.mesh_scan_blocks(signs, perm, ca[:, :3], sa, x)
    with pytest.raises(ValueError, match="multiple of 8"):
        tk.mesh_scan_blocks(signs, perm, ca, sa, x, blk_b=12)
    with pytest.raises(ValueError, match="8 a block may have"):
        tk.mesh_scan_blocks(signs, perm, ca, sa, x, blk_b=8 * 400)
    with pytest.raises(ValueError, match="needs per-block uint32 seeds"):
        tk.mesh_scan_blocks(signs, perm, ca, sa, x, theta_std=0.1)
    with pytest.raises(ValueError, match="contiguous"):
        tk.mesh_scan_blocks(signs, perm, ca, sa, x.T.contiguous().T)
    with pytest.raises(ValueError, match="one CUDA device"):
        tk.mesh_scan_blocks(signs, perm, ca, sa, x.to("meta"))
    # a warp holds 16 rows up to 8 wires a lane (m 256), 4 at m 1024; a
    # block at most 8 warps, by default 4
    assert tk.row_tile(256, 10 ** 6) == 64 and tk.row_tile(4, 10 ** 6) == 64
    assert tk.row_tile(1024, 10 ** 6) == 16
    assert tk.row_tile(256, 10 ** 6, 112) == 112
    assert tk.row_tile(64, 5, 64) == 8
    with pytest.raises(ValueError, match="at most 128 rows"):
        tk.row_tile(256, 10 ** 6, 136)
