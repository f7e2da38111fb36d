"""repro_torch.kernels on the CPU: the plain versions of the port's CUDA
kernels held against the JAX package's Pallas kernels (interpret mode)
and their jnp twins on the same numpy-seeded inputs; the wrappers'
device and input rules; and the port's import hygiene (no jax, no repro,
nothing built or loaded at import).  Nothing here builds or launches
CUDA: every tensor lies on the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpk
from repro.kernels.attention import flash_attention as jax_flash
from repro.models.layers import ShardCtx
from repro.models.layers import blocked_attention as jax_blocked
from repro.models.layers import decode_attention as jax_decode
from repro.models.layers import paged_gather as jax_gather
from repro_torch.kernels import _build, attention, paged_attention, ref

ROOT = Path(__file__).resolve().parents[1]
# f32 attention, both sides summing in f32 in another order (online vs
# straight softmax, tile sizes): differences are a few ulp of O(1) values
PAGED_TOL = 2e-6
FLASH_TOL = 1e-5


@pytest.fixture(autouse=True)
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------- paged decode
def _paged_case(h, hkv, hd, ps, seed=0, nb=3):
    """Five slots with lengths 1, ps-1, ps, ps+1 and the full table;
    pages shuffled; null page 0 zero (the pool invariant)."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray([1, ps - 1, ps, ps + 1, nb * ps], np.int32)
    b = len(lengths)
    n_pages = 1 + b * nb
    q = rng.normal(size=(b, h, 1, hd)).astype(np.float32)
    kp = rng.normal(size=(n_pages, hkv, ps, hd)).astype(np.float32)
    vp = rng.normal(size=(n_pages, hkv, ps, hd)).astype(np.float32)
    kp[0] = vp[0] = 0
    perm = rng.permutation(n_pages - 1) + 1
    table = np.zeros((b, nb), np.int32)
    for i, n in enumerate(lengths):
        used = -(-int(n) // ps)
        table[i, :used] = perm[i * nb:i * nb + used]
    return q, kp, vp, table, lengths


PAGED_SHAPES = [
    (4, 4, 16, 4),     # MHA, hd 16
    (4, 2, 16, 4),     # GQA rep 2, hd 16 (the minitron smoke heads)
    (8, 8, 48, 8),     # MHA, hd 48 (paper_llama heads)
    (8, 2, 48, 4),     # GQA rep 4, hd 48
]


def _jax_paged(q, kp, vp, table, lengths, pool_dtype=jnp.float32):
    args = (jnp.asarray(q), jnp.asarray(kp, pool_dtype),
            jnp.asarray(vp, pool_dtype), jnp.asarray(table),
            jnp.asarray(lengths))
    kernel = jpk.paged_attention(*args, interpret=True)
    gather = jax_decode(ShardCtx(), args[0], jax_gather(args[1], args[3]),
                        jax_gather(args[2], args[3]), args[4])
    return np.asarray(kernel), np.asarray(gather)


@pytest.mark.parametrize("h,hkv,hd,ps", PAGED_SHAPES)
def test_paged_plain_matches_jax_kernel_and_gather(h, hkv, hd, ps):
    q, kp, vp, table, lengths = _paged_case(h, hkv, hd, ps)
    got = ref.paged_attention_ref(_t(q), _t(kp), _t(vp), _t(table),
                                  _t(lengths)).numpy()
    kernel, gather = _jax_paged(q, kp, vp, table, lengths)
    np.testing.assert_allclose(got, kernel, atol=PAGED_TOL, rtol=0)
    np.testing.assert_allclose(got, gather, atol=PAGED_TOL, rtol=0)


@pytest.mark.parametrize("h,hkv,hd,ps", PAGED_SHAPES[1::2])
def test_paged_plain_ignores_poisoned_null_page(h, hkv, hd, ps):
    """Garbage in the null page changes nothing for slots of length >= 1:
    masking is by position against length, never by pool contents."""
    q, kp, vp, table, lengths = _paged_case(h, hkv, hd, ps, seed=3)
    clean = ref.paged_attention_ref(_t(q), _t(kp), _t(vp), _t(table),
                                    _t(lengths)).numpy()
    kp[0], vp[0] = 1e4, -1e4
    dirty = ref.paged_attention_ref(_t(q), _t(kp), _t(vp), _t(table),
                                    _t(lengths)).numpy()
    np.testing.assert_array_equal(dirty, clean)
    kernel, _ = _jax_paged(q, kp, vp, table, lengths)
    np.testing.assert_allclose(dirty, kernel, atol=PAGED_TOL, rtol=0)


@pytest.mark.parametrize("h,hkv,hd,ps", PAGED_SHAPES[1:3])
def test_paged_plain_bf16_pool_matches_jax(h, hkv, hd, ps):
    """bf16 pages: both sides round the same f32 pages to bf16 (round to
    nearest even) and widen them exactly, then compute in f32."""
    q, kp, vp, table, lengths = _paged_case(h, hkv, hd, ps, seed=5)
    got = ref.paged_attention_ref(
        _t(q), _t(kp).to(torch.bfloat16), _t(vp).to(torch.bfloat16),
        _t(table), _t(lengths)).numpy()
    kernel, gather = _jax_paged(q, kp, vp, table, lengths, jnp.bfloat16)
    np.testing.assert_allclose(got, kernel, atol=PAGED_TOL, rtol=0)
    np.testing.assert_allclose(got, gather, atol=PAGED_TOL, rtol=0)


def test_paged_wrapper_routes_cpu_to_plain_and_rejects_bad_input():
    q, kp, vp, table, lengths = (_t(a) for a in _paged_case(4, 2, 16, 4))
    before = paged_attention.paged_attention.launches
    got = paged_attention.paged_attention(q, kp, vp, table, lengths)
    assert torch.equal(got, ref.paged_attention_ref(q, kp, vp, table,
                                                    lengths))
    assert paged_attention.paged_attention.launches == before
    with pytest.raises(ValueError, match="CPU or one CUDA"):
        paged_attention.paged_attention(q.to("meta"), kp, vp, table,
                                        lengths)
    with pytest.raises(TypeError, match="int32"):
        paged_attention.paged_attention(q, kp, vp, table, lengths.long())
    with pytest.raises(TypeError, match="f32/bf16"):
        paged_attention.paged_attention(q.half(), kp, vp, table, lengths)
    with pytest.raises(ValueError, match="page_table"):
        paged_attention.paged_attention(q, kp, vp, table[:2], lengths)
    with pytest.raises(ValueError, match=r"\(b, h, 1, hd\)"):
        paged_attention.paged_attention(q.expand(-1, -1, 2, -1), kp, vp,
                                        table, lengths)
    with pytest.raises(ValueError, match="head mismatch"):
        paged_attention.paged_attention(q[..., :8], kp, vp, table, lengths)


# ------------------------------------------------------- flash prefill
@pytest.mark.parametrize("hd,sq,skv", [(16, 64, 64), (48, 64, 64),
                                       (16, 32, 64)])
def test_flash_plain_matches_jax_kernel_per_head(hd, sq, skv):
    """The JAX Pallas flash kernel is single-head: run it per head (32-row
    tiles, so several tiles and the diagonal skip are exercised)."""
    rng = np.random.default_rng(hd + sq)
    b, h = 1, 2
    q = rng.normal(size=(b, h, sq, hd)).astype(np.float32)
    k = rng.normal(size=(b, h, skv, hd)).astype(np.float32)
    v = rng.normal(size=(b, h, skv, hd)).astype(np.float32)
    got = ref.attention_ref(_t(q), _t(k), _t(v)).numpy()
    for i in range(h):
        want = jax_flash(jnp.asarray(q[0, i]), jnp.asarray(k[0, i]),
                         jnp.asarray(v[0, i]), blk_q=32, blk_k=32,
                         interpret=True)
        np.testing.assert_allclose(got[0, i], np.asarray(want),
                                   atol=FLASH_TOL, rtol=0)


@pytest.mark.parametrize("b,h,hkv,hd,sq,skv", [
    (2, 4, 2, 16, 37, 37),    # GQA rep 2, ragged (not a tile multiple)
    (2, 8, 2, 48, 70, 70),    # GQA rep 4, paper_llama head dim
    (1, 8, 8, 48, 10, 37),    # MHA, fewer queries than keys (shifted mask)
])
def test_flash_plain_matches_jax_blocked_attention(b, h, hkv, hd, sq, skv):
    rng = np.random.default_rng(sq * skv)
    q = rng.normal(size=(b, h, sq, hd)).astype(np.float32)
    k = rng.normal(size=(b, hkv, skv, hd)).astype(np.float32)
    v = rng.normal(size=(b, hkv, skv, hd)).astype(np.float32)
    got = ref.attention_ref(_t(q), _t(k), _t(v)).numpy()
    want = jax_blocked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       blk_q=16, blk_kv=16)
    np.testing.assert_allclose(got, np.asarray(want), atol=FLASH_TOL, rtol=0)


def test_flash_wrapper_routes_cpu_to_plain_and_rejects_bad_input():
    rng = np.random.default_rng(0)
    q = _t(rng.normal(size=(1, 4, 8, 16)).astype(np.float32))
    k = _t(rng.normal(size=(1, 2, 8, 16)).astype(np.float32))
    before = attention.flash_attention.launches
    got = attention.flash_attention(q.transpose(2, 3).transpose(2, 3), k, k)
    assert torch.equal(got, ref.attention_ref(q, k, k))
    assert attention.flash_attention.launches == before
    with pytest.raises(ValueError, match="v head dim"):
        attention.flash_attention(q, k, k[..., :8])
    with pytest.raises(ValueError, match="skv >= sq"):
        attention.flash_attention(q, k[:, :, :4], k[:, :, :4])
    with pytest.raises(ValueError, match="shape mismatch"):
        attention.flash_attention(q[:, :3], k, k)
    with pytest.raises(TypeError, match="one dtype"):
        attention.flash_attention(q, k.bfloat16(), k)
    with pytest.raises(ValueError, match="CPU or one CUDA"):
        attention.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))


# ------------------------------------------------- flash backward
# f32 gradients of O(1) inputs, both sides summing in f32 in other
# orders (online vs straight softmax, the JAX scan's tiles): a few ulp
BWD_TOL = 2e-5


@pytest.mark.parametrize("b,h,hkv,hd,sq,skv", [
    (2, 4, 4, 16, 37, 37),    # MHA, ragged
    (2, 8, 2, 48, 40, 40),    # GQA rep 4, paper_llama head dim
    (1, 4, 2, 16, 10, 29),    # GQA, fewer queries than keys
])
def test_attention_bwd_plain_matches_jax_grad(b, h, hkv, hd, sq, skv):
    """attention_bwd_ref against jax.vjp of the JAX blocked_attention
    (the function the JAX package trains through)."""
    rng = np.random.default_rng(h * sq + skv)
    q = rng.normal(size=(b, h, sq, hd)).astype(np.float32)
    k = rng.normal(size=(b, hkv, skv, hd)).astype(np.float32)
    v = rng.normal(size=(b, hkv, skv, hd)).astype(np.float32)
    do = rng.normal(size=(b, h, sq, hd)).astype(np.float32)
    o, vjp = jax.vjp(lambda q, k, v: jax_blocked(q, k, v, blk_q=16,
                                                  blk_kv=16),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    out, lse = ref.attention_fwd_ref(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(o), atol=FLASH_TOL,
                               rtol=0)
    got = ref.attention_bwd_ref(_t(q), _t(k), _t(v), out, lse, _t(do))
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BWD_TOL,
                                   rtol=0, err_msg=f"d{name}")


def test_flash_autograd_on_cpu_is_the_plain_backward():
    """FlashAttention's CPU route: the forward keeps the plain lse and
    the backward is attention_bwd_ref, so its gradients equal autograd
    through attention_ref up to summation order; no launch is counted."""
    rng = np.random.default_rng(1)
    q, k, v = (_t(rng.normal(size=s).astype(np.float32)).requires_grad_()
               for s in ((2, 4, 9, 16), (2, 2, 9, 16), (2, 2, 9, 16)))
    before = (attention.flash_attention.launches,
              attention.flash_attention_bwd.launches)
    out = attention.FlashAttention.apply(q.transpose(2, 3).transpose(2, 3),
                                         k, v)
    grads = torch.autograd.grad((out * out).sum(), (q, k, v))
    want = torch.autograd.grad(
        (ref.attention_ref(q, k, v) ** 2).sum(), (q, k, v))
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, atol=BWD_TOL, rtol=0)
    assert (attention.flash_attention.launches,
            attention.flash_attention_bwd.launches) == before
    with torch.no_grad():
        assert torch.equal(attention.FlashAttention.apply(q, k, v),
                           ref.attention_ref(q, k, v))
    o, lse = attention.flash_attention(q.detach(), k.detach(), v.detach(),
                                       return_lse=True)
    want_o, want_lse = ref.attention_fwd_ref(q.detach(), k.detach(),
                                             v.detach())
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)


def test_flash_bwd_wrapper_rejects_bad_input():
    rng = np.random.default_rng(2)
    q = _t(rng.normal(size=(1, 4, 8, 16)).astype(np.float32))
    k = _t(rng.normal(size=(1, 2, 8, 16)).astype(np.float32))
    o, lse = ref.attention_fwd_ref(q, k, k)
    args = [q, k, k, o, lse, q]
    assert all(torch.equal(a, b) for a, b in zip(
        attention.flash_attention_bwd(*args), ref.attention_bwd_ref(*args)))
    with pytest.raises(ValueError, match="shape mismatch"):
        attention.flash_attention_bwd(q, k, k, o, lse[..., :4], q)
    with pytest.raises(TypeError, match="f32 lse"):
        attention.flash_attention_bwd(q, k, k, o, lse.double(), q)
    with pytest.raises(TypeError, match="one dtype"):
        attention.flash_attention_bwd(q, k.bfloat16(), k, o, lse, q)
    with pytest.raises(ValueError, match="CPU or one CUDA"):
        attention.flash_attention_bwd(*(a.to("meta") for a in args))


# ------------------------------------------------------------- build
def test_build_is_content_addressed_and_reuses_a_current_build(
        tmp_path, monkeypatch):
    """A library named by the hash of its source is reused as it is: no
    compiler is needed when the build is current."""
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert names == ["flash_attention", "flash_attention_bwd", "mesh_scan",
                     "onn_layer", "paged_attention", "pam4"]
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("nvcc called"))
    paths = {n: _build.library_path(n) for n in names}
    assert len({p.name for p in paths.values()}) == len(names)
    for p in paths.values():
        assert p.parent == tmp_path
        p.write_bytes(b"")
    assert _build.build() == paths
    assert _build.library_path(names[0]) == paths[names[0]]


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "Path", lambda *a: tmp_path / "no-nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


# ------------------------------------------------------ import hygiene
def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def test_port_imports_no_jax_and_nothing_of_repro():
    banned = {"jax", "jaxlib", "repro", "triton"}
    found = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            found += [f"{path.name}: {m}" for m in mods
                      if m.split(".")[0] in banned]
    assert len(_port_sources()) > 15
    assert not found, found


def test_importing_the_trainer_loads_no_jax_and_builds_nothing():
    code = ("import sys\n"
            "import repro_torch.launch.train, repro_torch.collectives.engine\n"
            "import repro_torch.kernels.pam4, repro_torch.photonics\n"
            "from repro_torch.kernels import _build\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'repro' not in sys.modules, 'repro imported'\n"
            "assert 'triton' not in sys.modules, 'triton imported'\n"
            "assert not _build._ENTRIES, 'a kernel library was loaded'\n"
            "print('CLEAN')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "CLEAN" in out.stdout


def test_importing_the_engine_loads_no_jax_and_builds_nothing():
    code = ("import sys\n"
            "import repro_torch.serving.engine, repro_torch.kernels.ref\n"
            "from repro_torch.kernels import _build\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'repro' not in sys.modules, 'repro imported'\n"
            "assert 'triton' not in sys.modules, 'triton imported'\n"
            "assert not _build._ENTRIES, 'a kernel library was loaded'\n"
            "print('CLEAN')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "CLEAN" in out.stdout
