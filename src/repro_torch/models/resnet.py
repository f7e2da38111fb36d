"""ResNet-50 of the paper's CIFAR-100 task (counterpart of
``repro.models.resnet``): NHWC images, GroupNorm in place of BatchNorm
(no cross-device batch statistics, so the gradient sync is the only
communication between peers), a 3x3 stem and no max-pool.

The parameters are JAX's nested dict with JAX's keys and shapes: every
conv weight is HWIO, (kh, kw, cin, cout), so a gradient leaf, its place
in the sorted-key flat order (``repro_torch.tree``), the bucket layout
and a checkpoint's leaves are JAX's element for element.  ``conv``
permutes a view of the weight to OIHW at use (autograd hands back HWIO
gradients) and runs the NHWC activations through ``F.conv2d`` as NCHW
views in ``torch.channels_last`` memory.  JAX's "SAME" padding puts the
odd pad of a strided conv on the high side (32 -> 16 through a 3x3
stride-2 conv pads (0, 1)), which no ``F.conv2d`` padding gives, so
asymmetric pads go through ``F.pad``.

``BLOCKS`` and ``WIDTHS`` are read when a function is called, as in
JAX, so a test narrows both packages by setting them.  Every width must
divide by the 8 groups; the stem is 64 channels.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import prng
from .. import device as device_util
from ..tree import leaves_with_paths, set_path, tree_map

BLOCKS = (3, 4, 6, 3)
WIDTHS = (64, 128, 256, 512)
STEM = 64


def _same_pads(size: int, k: int, stride: int) -> tuple:
    """XLA's SAME padding of one spatial axis: (low, high), the odd pad
    high."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """``lax.conv_general_dilated(x, w, (stride, stride), "SAME")`` with
    NHWC x, HWIO w and NHWC out."""
    (top, bottom), (left, right) = (
        _same_pads(x.shape[1], w.shape[0], stride),
        _same_pads(x.shape[2], w.shape[1], stride))
    pad = (top, left)
    if (top, left) != (bottom, right):
        x = F.pad(x, (0, 0, left, right, top, bottom))
        pad = (0, 0)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def groupnorm(x: torch.Tensor, scale, bias, groups: int = 8,
              eps: float = 1e-5) -> torch.Tensor:
    """JAX's ``groupnorm`` of NHWC x: statistics over (H, W, C / groups)
    in f32, the two-pass variance, then the affine map."""
    b, h, w, c = x.shape
    xg = x.reshape(b, h, w, groups, c // groups).float()
    d = xg - xg.mean(dim=(1, 2, 4), keepdim=True)
    var = d.square().mean(dim=(1, 2, 4), keepdim=True)
    xg = d * torch.rsqrt(var + eps)
    return xg.reshape(b, h, w, c).to(x.dtype) * scale + bias


def _blocks():
    """(key, cin, width, stride, has a projection) of each bottleneck
    block in JAX's order, from BLOCKS and WIDTHS as they are now."""
    cin = STEM
    for si, (nb, w) in enumerate(zip(BLOCKS, WIDTHS)):
        for bi in range(nb):
            stride = 2 if (bi == 0 and si > 0) else 1
            yield f"block{si}_{bi}", cin, w, stride, (cin != 4 * w
                                                     or stride != 1)
            cin = 4 * w


def _tree(conv_leaf, ones, zeros, head, classes: int) -> dict:
    """The parameter dict of JAX's ``init_params``, each leaf made by
    the factory of its kind, called in JAX's order of key draws."""
    p = {"stem": conv_leaf(3, 3, 3, STEM), "stem_s": ones(STEM),
         "stem_b": zeros(STEM)}
    for name, cin, w, _, proj in _blocks():
        blk = {"c1": conv_leaf(1, 1, cin, w), "c2": conv_leaf(3, 3, w, w),
               "c3": conv_leaf(1, 1, w, 4 * w)}
        for j in (1, 2, 3):
            cw = w if j < 3 else 4 * w
            blk[f"s{j}"], blk[f"b{j}"] = ones(cw), zeros(cw)
        if proj:
            blk["proj"] = conv_leaf(1, 1, cin, 4 * w)
            blk["proj_s"], blk["proj_b"] = ones(4 * w), zeros(4 * w)
        p[name] = blk
    p["head_w"] = head(4 * WIDTHS[-1], classes)
    p["head_b"] = zeros(classes)
    return p


def param_shapes(classes: int = 100) -> dict:
    """Each leaf's shape, the structure of ``init_params``."""
    return _tree(lambda *s: s, lambda n: (n,), lambda n: (n,),
                 lambda *s: s, classes)


def init_params(seed: int = 0, classes: int = 100, device=None) -> dict:
    """Seeded f32 parameters, JAX's distributions: convs normal x
    sqrt(2 / (kh kw cin)), the head normal x 0.01, GroupNorm scales one,
    biases zero.  One key a drawn leaf from ``prng.split(PRNGKey(seed),
    256)``, drawn on the CPU and moved, so the weights do not depend on
    the device; they are not ``jax.random``'s numbers (carry JAX weights
    across with ``params_from_jax``).  On CUDA unless ``device`` names
    another device."""
    dev = device_util.resolve(device, "resnet.init_params")
    keys = iter(prng.split(prng.PRNGKey(seed), 256))

    def conv_leaf(kh, kw, cin, cout):
        return (prng.normal(next(keys), (kh, kw, cin, cout))
                * math.sqrt(2.0 / (kh * kw * cin)))

    p = _tree(conv_leaf, torch.ones, torch.zeros,
              lambda cin, c: prng.normal(next(keys), (cin, c)) * 0.01,
              classes)
    return tree_map(lambda t: t.to(dev), p)


def params_from_jax(tree: dict, device=None) -> dict:
    """JAX's parameter dict (leaves as f32 numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's tensors, bit for
    bit; every leaf's shape is checked against ``param_shapes``."""
    dev = device_util.resolve(device, "resnet.params_from_jax")
    shapes = param_shapes(np.shape(tree["head_b"])[0])
    want = [path for path, _ in leaves_with_paths(shapes)]
    got = [path for path, _ in leaves_with_paths(tree)]
    if got != want:
        raise ValueError(f"leaves {sorted(set(got) ^ set(want))} are not "
                         f"those of BLOCKS {BLOCKS}, WIDTHS {WIDTHS}")
    out: dict = {}
    for (path, leaf), (_, shp) in zip(leaves_with_paths(tree),
                                      leaves_with_paths(shapes)):
        a = np.array(leaf)                 # a writable copy torch can own
        if a.shape != shp or a.dtype != np.float32:
            raise ValueError(f"param {'/'.join(path)}: {a.dtype} "
                             f"{a.shape}, want float32 {shp}")
        set_path(out, path, torch.from_numpy(a).to(dev))
    return out


def forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) NHWC images -> (B, classes) logits."""
    x = F.relu(groupnorm(conv(x, p["stem"]), p["stem_s"], p["stem_b"]))
    for name, _, _, stride, _ in _blocks():
        blk = p[name]
        h = F.relu(groupnorm(conv(x, blk["c1"]), blk["s1"], blk["b1"]))
        h = F.relu(groupnorm(conv(h, blk["c2"], stride), blk["s2"],
                             blk["b2"]))
        h = groupnorm(conv(h, blk["c3"]), blk["s3"], blk["b3"])
        if "proj" in blk:
            x = groupnorm(conv(x, blk["proj"], stride), blk["proj_s"],
                          blk["proj_b"])
        x = F.relu(x + h)
    x = x.mean(dim=(1, 2))
    return x @ p["head_w"] + p["head_b"]


def loss_fn(p: dict, images: torch.Tensor, labels: torch.Tensor):
    """(mean negative log-likelihood, accuracy) of the batch."""
    logits = forward(p, images)
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels.long()[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return nll, acc
