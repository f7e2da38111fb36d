"""Deterministic synthetic data, a numpy copy of ``repro.data.pipeline``
(``DataConfig``, ``SyntheticLM``, ``make_batch_iterator``,
``synthetic_images``), so both packages see identical tokens and images.

Streams are functions of (seed, step, shard): a Zipfian token process
shaped like the paper's Wikipedia-1B setup (vocab 32000) in which half
the positions follow a fixed bigram map, so the loss is learnable; and
CIFAR-100-shaped images (the paper's ResNet-50 task), class-conditional
blobs over Gaussian noise.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int = 32000
    seq_len: int = 512
    global_batch: int = 32
    seed: int = 1234
    zipf_a: float = 1.2


class SyntheticLM:
    """Deterministic-by-(step, shard) synthetic LM token stream."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        if cfg.global_batch % num_shards:
            raise ValueError(f"global_batch {cfg.global_batch} is not "
                             f"divisible by {num_shards} shards")
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        # fixed Zipfian unigram table + deterministic bigram shift
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        self.probs = ranks ** -cfg.zipf_a
        self.probs /= self.probs.sum()
        self.shift = rng.integers(1, cfg.vocab, size=cfg.vocab)

    def batch(self, step: int) -> np.ndarray:
        """(local_batch, seq_len + 1) int32 tokens for this shard/step."""
        rng = np.random.default_rng(
            (self.cfg.seed * 1_000_003 + step) * 65_537 + self.shard)
        t = self.cfg.seq_len + 1
        base = rng.choice(self.cfg.vocab, size=(self.local_batch, t),
                          p=self.probs)
        # 50% of positions follow the deterministic bigram map (learnable)
        follow = rng.random((self.local_batch, t)) < 0.5
        out = base.copy()
        for i in range(1, t):
            out[:, i] = np.where(follow[:, i],
                                 self.shift[out[:, i - 1]], base[:, i])
        return out.astype(np.int32)


def make_batch_iterator(cfg: DataConfig, start_step: int = 0, shard: int = 0,
                        num_shards: int = 1):
    ds = SyntheticLM(cfg, shard, num_shards)
    step = start_step
    while True:
        yield step, {"tokens": ds.batch(step)}
        step += 1


def synthetic_images(step: int, batch: int, seed: int = 7,
                     shape=(32, 32, 3), classes: int = 100):
    """CIFAR-100-shaped deterministic image stream (paper's ResNet50 task):
    class-conditional Gaussian blobs (learnable but non-trivial).
    Returns ((batch, *shape) f32 NHWC images, (batch,) int32 labels), the
    JAX package's arrays bit for bit (the same generators, the same
    per-image loop)."""
    rng = np.random.default_rng(seed * 999_983 + step)
    labels = rng.integers(0, classes, size=batch)
    protos = np.random.default_rng(seed).normal(
        size=(classes, 8)).astype(np.float32)
    noise = rng.normal(size=(batch,) + shape).astype(np.float32)
    grid = np.linspace(0, 1, shape[0] * shape[1] * shape[2]).reshape(shape)
    imgs = noise * 0.5
    for i in range(batch):
        f = protos[labels[i]]
        imgs[i] += (f[:4].reshape(2, 2, 1) * grid[:2, :2] * 0).sum() + \
            f.mean() + 0.3 * np.outer(
                np.sin(np.linspace(0, f[0] * 6, shape[0])),
                np.cos(np.linspace(0, f[1] * 6, shape[1])))[..., None]
    return imgs.astype(np.float32), labels.astype(np.int32)
