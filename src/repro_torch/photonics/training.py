"""Hardware-aware ONN training (paper III-B, eq. 7; counterpart of
``repro.photonics.training``).

Two-stage loss:
  stage 1 (E < E1):  per-symbol weighted MSE on the raw analog outputs
                     (``weight_mode``: uniform / 2^(M-i) / 4^(M-i)).
  stage 2 (E >= E1): MSE on the reconstructed gradient G_bar from
                     transceiver-quantized outputs (a straight-through
                     estimator keeps the rounding trainable), plus a 0.1
                     symbol-level anchor.

The hardware constraint (matrix approximation) is enforced two ways:
  mode='project' — the paper's algorithm: periodically project the
                   selected layers onto the Sigma_a U_a manifold
                   (``onn.project_approx``), and once more at the end.
  mode='cayley'  — the selected layers are parametrized exactly as
                   diag(d) @ cayley(P - P^T) per block, so the trained
                   network is hardware-exact by construction.

The forward pass here is plain tensor arithmetic under autograd
(``x @ w.T + b``, ReLU), as the JAX loop differentiates plain jnp; it is
a path of its own, not the ``onn_layer`` kernel, which has no backward
and stays the path the sync runs (``onn.apply``).  The arithmetic is the
compiled JAX step's: a division by a constant is a product with its f32
reciprocal, ``jnp.mean`` a sum times f32(1/N), and Adam is JAX's formula
as written (bias-corrected moments, then p - lr mhat / (sqrt(vhat) +
eps)) with the FMAs XLA forms in it, not ``torch.optim.Adam``.

``train``, ``accuracy`` and ``error_histogram`` run on CUDA unless the
caller passes ``device``, and raise when there is no CUDA device.  Initial
parameters come from a CPU ``torch.Generator`` (not ``jax.random``);
``train(init=...)`` takes parameters carried across from JAX
(``onn.params_from_jax``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import prng
from ..kernels import ref
from . import approx as approx_mod
from . import onn as onn_mod
from .encoding import f32_reciprocal
from .onn import ONNConfig


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 4000
    e1: int = 3000               # stage-1 epoch count
    lr: float = 1e-2
    batch_size: int = 0          # 0 = full batch
    proj_every: int = 100        # approximation projection period (project)
    mode: str = "project"        # project | cayley
    weight_mode: str = "uniform"  # uniform | pow2 | pow4
    seed: int = 0
    cosine: bool = True


def resolve_device(device) -> torch.device:
    """``device``, or CUDA when it is None (raising if there is none)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ONN training runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to train on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def symbol_weights(m: int, mode: str) -> torch.Tensor:
    if mode == "uniform":
        w = torch.ones((m,))
    elif mode == "pow2":
        w = 2.0 ** torch.arange(m - 1, -1, -1, dtype=torch.float32)
    elif mode == "pow4":
        w = 4.0 ** torch.arange(m - 1, -1, -1, dtype=torch.float32)
    else:
        raise ValueError(mode)
    return w / w.sum()


def _ste_round(x: torch.Tensor) -> torch.Tensor:
    return x + (torch.clamp(torch.round(x), 0, 3) - x).detach()


def _mean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean`` as XLA compiles it: the sum times f32(1/N)."""
    return x.sum() * f32_reciprocal(x.numel())


# ----------------- Cayley-constrained parametrization -----------------

def _cayley(p: torch.Tensor) -> torch.Tensor:
    """Skew-symmetrize the free matrix and map to the orthogonal group."""
    a = p - p.transpose(-1, -2)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return torch.linalg.solve(eye + a, eye - a)


def init_constrained_layer(gen: torch.Generator, m: int, n: int,
                           device="cpu") -> dict:
    s = approx_mod.block_size(m, n)
    nblocks = (m // s) * (n // s)
    p = torch.randn((nblocks, s, s), generator=gen) * 0.1
    d = torch.randn((nblocks, s), generator=gen) * float(np.sqrt(2.0 / n))
    return {"p": p.to(device), "d": d.to(device),
            "b": torch.zeros((m,), device=device), "shape": (m, n)}


def materialize_constrained(layer) -> torch.Tensor:
    """Build W (m x n) from the exact diag(d) @ U block parametrization."""
    m, n = layer["shape"]
    u = _cayley(layer["p"])                      # (nblocks, s, s)
    w_blocks = layer["d"][..., None] * u         # diag(d) @ U
    if m == n:
        return w_blocks[0]
    if m > n:
        return w_blocks.reshape(m, n)
    return w_blocks.permute(1, 0, 2).reshape(m, n)


def init_params(cfg: ONNConfig, seed: int = 0, mode: str = "project",
                device="cpu") -> list:
    """Dense params (``onn.init_params``), with the approximated layers
    replaced by the constrained parametrization when mode == 'cayley'
    (their p and d drawn from one CPU generator seeded from ``seed``)."""
    dense = onn_mod.init_params(cfg, seed, device)
    if mode != "cayley":
        return dense
    gen = torch.Generator().manual_seed(prng.PRNGKey(seed))
    out = []
    for idx, layer in enumerate(dense, start=1):
        if idx in cfg.approx_layers:
            m, n = layer["w"].shape
            out.append(init_constrained_layer(gen, m, n, device))
        else:
            out.append(layer)
    return out


def apply_onn(params, a: torch.Tensor, cfg: ONNConfig) -> torch.Tensor:
    """Forward pass that understands both layer parametrizations."""
    x = a.float() * f32_reciprocal(cfg.in_scale)
    nl = len(params)
    for i, layer in enumerate(params):
        w = layer["w"] if "w" in layer else materialize_constrained(layer)
        x = x @ w.T + layer["b"]
        if i < nl - 1:
            x = torch.relu(x)
    return x * cfg.out_scale


def to_dense(params) -> list:
    """Materialize any constrained layers into plain dense weights."""
    with torch.no_grad():
        return [{"w": layer["w"] if "w" in layer
                 else materialize_constrained(layer), "b": layer["b"]}
                for layer in params]


# ------------------------------ losses ------------------------------

def _place(m: int, device) -> torch.Tensor:
    return 4.0 ** torch.arange(m - 1, -1, -1, dtype=torch.float32,
                               device=device)


def stage1_loss(params, a, tgt, cfg: ONNConfig, w_sym) -> torch.Tensor:
    out = apply_onn(params, a, cfg)
    return _mean(torch.sum(w_sym * (out - tgt.float()) ** 2, -1))


def stage2_loss(params, a, tgt, cfg: ONNConfig, w_sym) -> torch.Tensor:
    out = apply_onn(params, a, cfg)
    m = out.shape[-1]
    place = _place(m, out.device)
    g_hat = torch.sum(_ste_round(out) * place, -1)
    g_star = torch.sum(tgt.float() * place, -1)
    scale = 4.0 ** m - 1.0
    # a small symbol-level anchor, so that stage 2 cannot drift symbols
    # that currently round correctly (zero STE gradient regions)
    anchor = _mean(torch.sum(w_sym * (out - tgt.float()) ** 2, -1))
    return (_mean(((g_hat - g_star) * f32_reciprocal(scale)) ** 2)
            + 0.1 * anchor)


# ----------------------------- metrics ------------------------------

def _on(x, device, dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device, dtype)
    return torch.from_numpy(np.asarray(x)).to(device, dtype)


def _readouts(params, a, cfg: ONNConfig, batch: int, device):
    """(start, PAM4 symbols) of each batch of ``a`` through the dense
    forward pass on ``device``."""
    dev = resolve_device(device)
    dense = [{k: _on(v, dev, torch.float32) for k, v in layer.items()}
             for layer in to_dense(params)]
    with torch.no_grad():
        for i in range(0, a.shape[0], batch):
            out = apply_onn(dense, _on(a[i:i + batch], dev, torch.float32),
                            cfg)
            yield i, onn_mod.readout(out)


def accuracy(params, a, tgt, cfg: ONNConfig, batch: int = 262144,
             device=None) -> float:
    """Fraction of samples whose entire reconstructed gradient is exact
    (all M symbols round correctly): the paper's 'ONN Accuracy'."""
    n = a.shape[0]
    correct = 0
    for i, sym in _readouts(params, a, cfg, batch, device):
        want = _on(tgt[i:i + batch], sym.device, torch.int32)
        correct += int((sym == want).all(-1).sum())
    return correct / n


def error_histogram(params, a, tgt, cfg: ONNConfig, batch: int = 262144,
                    device=None) -> dict:
    """Integer-error distribution of the reconstructed gradient on the
    misclassified samples (paper Table II col 3)."""
    m = tgt.shape[-1]
    place = 4 ** np.arange(m - 1, -1, -1)
    errs = {}
    for i, sym in _readouts(params, a, cfg, batch, device):
        g_hat = (sym.cpu().numpy() * place).sum(-1)
        g_star = (np.asarray(_on(tgt[i:i + batch], "cpu", torch.int32))
                  * place).sum(-1)
        for e in (g_hat - g_star)[g_hat != g_star]:
            errs[int(e)] = errs.get(int(e), 0) + 1
    return errs


# ----------------------------- optimizer ----------------------------

def _leaves(tree) -> list:
    return [v for layer in tree for _, v in sorted(layer.items())]


def _rebuild(tree, leaves) -> list:
    it = iter(leaves)
    return [{k: next(it) for k, _ in sorted(layer.items())}
            for layer in tree]


def _adam_init(params) -> dict:
    zeros = [torch.zeros_like(v) for v in _leaves(params)]
    return {"m": _rebuild(params, zeros),
            "v": _rebuild(params, [z.clone() for z in zeros]), "t": 0}


def _adam_update(params, grads, state, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step on trees of layer dicts, JAX's formula in the form
    XLA compiles it: the moments as fma(b1, m, (1 - b1) g) and fma(b2, v,
    ((1 - b2) g) g), the bias corrections 1 - b^t in f32, then p - lr mhat
    / (sqrt(vhat) + eps) with true divisions.  The leaves are updated as
    one flat vector."""
    t = state["t"] + 1
    sizes = [v.numel() for v in _leaves(params)]

    def flat(tree):
        return torch.cat([v.reshape(-1) for v in _leaves(tree)])

    def unflat(vec):
        return _rebuild(params, [piece.view_as(v) for piece, v in zip(
            vec.split(sizes), _leaves(params))])

    p, g = flat(params), flat(grads)
    c1 = torch.tensor(b1, dtype=torch.float32, device=p.device)
    c2 = torch.tensor(b2, dtype=torch.float32, device=p.device)
    m = ref.fma_f32(c1, flat(state["m"]), (1 - b1) * g)
    v = ref.fma_f32(c2, flat(state["v"]), (1 - b2) * g * g)
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(t))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(t))
    mhat, vhat = m / bc1, v / bc2
    # the correctly rounded f32 square root (torch's vectorized CPU sqrt
    # is not, for about 1 value in 150)
    new = p - lr * mhat / (torch.sqrt(vhat.double()).float() + eps)
    return unflat(new), {"m": unflat(m), "v": unflat(v), "t": t}


# ------------------------------ driver ------------------------------

def _project(dyn, shapes, cfg: ONNConfig) -> list:
    with torch.no_grad():
        return [{k: v for k, v in layer.items() if k != "shape"}
                for layer in onn_mod.project_approx(
                    _with_shapes(dyn, shapes), cfg)]


def _with_shapes(dyn, shapes) -> list:
    return [dict(layer, shape=s) if s is not None else layer
            for layer, s in zip(dyn, shapes)]


def train(cfg: ONNConfig, tcfg: TrainConfig, a: np.ndarray, tgt: np.ndarray,
          eval_every: int = 0, verbose: bool = False,
          target_acc: float = 1.0, init=None, device=None):
    """Hardware-aware training loop on ``device`` (CUDA by default).
    Returns (params, history): dense {"w", "b"} layers on the device,
    which satisfy the hardware constraint on ``cfg.approx_layers``, and
    one record per epoch.  ``init`` replaces the seeded initial
    parameters (``init_params(cfg, tcfg.seed, tcfg.mode)``)."""
    dev = resolve_device(device)
    if init is None:
        init = init_params(cfg, tcfg.seed, tcfg.mode)
    shapes = [layer.get("shape") for layer in init]
    dyn = [{k: v.detach().to(dev, torch.float32).clone()
            for k, v in layer.items() if k != "shape"} for layer in init]
    w_sym = symbol_weights(cfg.structure[-1], tcfg.weight_mode).to(dev)
    project = tcfg.mode == "project" and bool(cfg.approx_layers)

    def step(dyn, opt, ab, tb, lr, stage):
        leaves = [v.detach().requires_grad_() for v in _leaves(dyn)]
        f = stage1_loss if stage == 1 else stage2_loss
        loss = f(_with_shapes(_rebuild(dyn, leaves), shapes), ab, tb, cfg,
                 w_sym)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            dyn, opt = _adam_update(_rebuild(dyn, [v.detach()
                                                   for v in leaves]),
                                    _rebuild(dyn, grads), opt, lr)
        return dyn, opt, loss.detach()

    n = a.shape[0]
    bs = tcfg.batch_size if tcfg.batch_size > 0 else n
    steps = max(1, n // bs)
    history = []
    perm_rng = np.random.default_rng(tcfg.seed)
    a_t, t_t = _on(a, dev, torch.float32), _on(tgt, dev, torch.int32)
    opt = _adam_init(dyn)
    for epoch in range(tcfg.epochs):
        stage = 1 if epoch < tcfg.e1 else 2
        lr = tcfg.lr
        if tcfg.cosine:
            lr = float(tcfg.lr * 0.5 * (1 + np.cos(np.pi * epoch
                                                   / tcfg.epochs)))
        if steps == 1:
            dyn, opt, loss = step(dyn, opt, a_t, t_t, lr, stage)
            ep_loss = float(loss)
        else:
            perm = perm_rng.permutation(n)
            ep_loss = 0.0
            for s in range(steps):
                idx = torch.from_numpy(perm[s * bs:(s + 1) * bs]).to(dev)
                dyn, opt, loss = step(dyn, opt, a_t[idx], t_t[idx], lr,
                                      stage)
                ep_loss += float(loss) / steps
        projected = False
        if project and (epoch + 1) % tcfg.proj_every == 0:
            dyn = _project(dyn, shapes, cfg)
            projected = True
        rec = {"epoch": epoch, "stage": stage, "loss": ep_loss,
               "projected": projected, "lr": lr}
        if eval_every and (epoch + 1) % eval_every == 0:
            p_eval = _project(dyn, shapes, cfg) if project else dyn
            rec["acc"] = accuracy(_with_shapes(p_eval, shapes), a_t, t_t,
                                  cfg, device=dev)
            if verbose:
                print(f"epoch {epoch:5d} stage {stage} loss {ep_loss:.3e} "
                      f"acc {rec['acc']:.6f}", flush=True)
            if rec["acc"] >= target_acc:
                history.append(rec)
                dyn = p_eval
                break
        history.append(rec)
    if project:
        dyn = _project(dyn, shapes, cfg)
    return to_dense(_with_shapes(dyn, shapes)), history
