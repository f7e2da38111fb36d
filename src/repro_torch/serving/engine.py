"""ServeEngine: continuous-batching decode over the paged KV pool
(counterpart of ``repro.serving.engine``).

One ``step()`` advances every active sequence by one token: sequences
admitted this step prefill through ONE batched prefill call (prompts
packed into a padded batch, their KV scattered into freshly allocated
pages), then every active sequence decodes one token in one packed
decode call.  Sequences finish (budget / stop token / capacity) and new
arrivals are admitted between steps.

Both calls pad their dynamic dimensions to buckets as the JAX engine
does: the decode batch to a power-of-two occupancy (capped at
``max_active``), prefill rows the same way and prompt lengths to
power-of-two whole pages.  Pad rows carry length 0 and an all-null page
table; their outputs are discarded.

On the card, prefill attention runs the flash kernel and decode attention
the paged kernel, each ``n_layers`` times a call.  The engine runs on ``"cuda"`` unless the caller passes another
device; it never falls back to the CPU by itself.

``ServeEngine.from_spec`` builds one from a RunSpec: parameters through
``reload.resolve_params`` and, with ``ckpt.dir`` and
``serve.reload_every``, a ``reload.ParamReloader`` polled every
``reload_every`` steps, between steps.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import device as device_util
from ..models import lm
from ..models.config import ModelConfig
from . import kv_pool, reload
from .config import ServeConfig
from .scheduler import Scheduler, Sequence

_MASK64 = (1 << 63) - 1


def sample_seed(seed: int, rid: int, position: int) -> int:
    """Generator seed of one sampled token: a fixed mix of (engine seed,
    request id, position in the generation), so a request samples the
    same tokens whatever it shares a batch with and across preemption."""
    x = (seed * 0x9E3779B97F4A7C15 + rid) & _MASK64
    return (x * 0xBF58476D1CE4E5B9 + position) & _MASK64


class ServeEngine:
    def __init__(self, cfg: ModelConfig, serve: ServeConfig, params=None, *,
                 device=None, seed: int = 0):
        device = device_util.resolve(device, "ServeEngine")
        if not kv_pool.supports_paged(cfg):
            raise NotImplementedError(
                f"paged serving covers the dense-attention families; "
                f"{cfg.name} (ssm/enc-dec/moe) is not ported to the paged "
                f"engine (the JAX engine serves none of them either; "
                f"ServeSession serves every family, these on JAX's "
                f"contiguous cache path)")
        if serve.top_k and serve.temperature == 0.0:
            raise ValueError("top_k needs temperature > 0")
        self.cfg = cfg
        self.scfg = serve
        self.device = torch.device(device)
        self.seed = seed
        self.params = (lm.init_params(cfg, seed, self.device) if params is None
                       else params)
        n_pages = serve.auto_pages()
        self.pool = kv_pool.init_pool(cfg, n_pages, serve.page_size,
                                      kv_dtype=serve.kv_dtype,
                                      device=self.device)
        self.sched = Scheduler(serve, kv_pool.PageAllocator(n_pages))
        self.results: dict = {}      # rid -> list of generated token ids
        self.max_observed_active = 0
        self.step_count = 0
        self.params_step = None      # checkpoint step of the params
        self.reloader = None

    @classmethod
    def from_spec(cls, spec, params=None, *, device=None, cfg=None):
        """The engine of a RunSpec (``spec.serve``, ``spec.seed``):
        ``params``, else the checkpoint when ``ckpt.resume`` is set, else
        a seeded init; hot-swaps newer checkpoints every
        ``serve.reload_every`` steps when ``ckpt.dir`` is set.  A mesh
        the engine would not run as JAX shards it is refused by name
        (``RunSpec.check_serves``)."""
        spec.validate()
        cfg = cfg if cfg is not None else spec.model_config()
        spec.check_serves(cfg)
        device = device_util.resolve(device, "ServeEngine")
        step = None
        if params is None:
            params, step = reload.resolve_params(spec, cfg, device)
        eng = cls(cfg, spec.serve, params, device=device, seed=spec.seed)
        eng.params_step = step
        if spec.ckpt.dir and spec.serve.reload_every > 0:
            eng.reloader = reload.ParamReloader(spec, cfg, device,
                                                current_step=step)
        return eng

    # -------------------------------------------------------------- intake
    def submit(self, prompt, max_new_tokens=None) -> int:
        return self.sched.submit(prompt, max_new_tokens)

    def has_work(self) -> bool:
        return self.sched.has_work()

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ---------------------------------------------------------------- step
    @torch.inference_mode()
    def step(self):
        """Advance every active sequence by one token.  Returns the list
        of (rid, token) pairs emitted this step (prefill first-tokens of
        newly admitted sequences included)."""
        self.step_count += 1
        if (self.reloader is not None
                and self.step_count % self.scfg.reload_every == 0):
            swapped = self.reloader.poll()
            if swapped is not None:
                self.params, self.params_step = swapped
                print(f"hot-swapped params to checkpoint step "
                      f"{self.params_step}", flush=True)
        emitted = []
        admitted = self.sched.admit()
        if admitted:
            emitted += self._prefill_batch(admitted)
        self._ensure_growth()
        act = self.sched.active
        self.max_observed_active = max(self.max_observed_active, len(act))
        if not act:
            return emitted
        b = self._row_bucket(len(act))
        pt = np.zeros((b, self.scfg.max_blocks), np.int32)
        ln = np.zeros((b,), np.int32)
        tok = np.zeros((b, 1), np.int64)
        for i, seq in enumerate(act):
            pt[i, :len(seq.pages)] = seq.pages
            ln[i] = seq.length
            tok[i, 0] = seq.last_token
        logits, self.pool = lm.paged_decode_step(
            self.cfg, self.params, self.pool, self._tensor(pt),
            self._tensor(ln), self._tensor(tok))
        toks = self._sample(logits[:len(act)], act)
        for seq, t in zip(list(act), toks):
            seq.length += 1
            emitted += self._push_token(seq, int(t))
        return emitted

    def _ensure_growth(self):
        """Every active sequence gets a page for its next cache entry;
        when the pool runs dry the youngest sequences are preempted
        (pages freed, request re-queued with its generated tokens) until
        the remaining ones fit."""
        i = 0
        while i < len(self.sched.active):
            seq = self.sched.active[i]
            if self.sched.grow(seq):
                i += 1
                continue
            victim = self.sched.preempt_youngest()
            if victim is seq:  # even alone it can't grow — re-queued
                break

    def _len_bucket(self, t: int) -> int:
        """Prompt-length bucket: pow2 rounded up to a whole number of
        pages, capped at capacity."""
        ps = self.scfg.page_size
        tb = -(-max(ps, 1 << (t - 1).bit_length()) // ps) * ps
        return min(tb, self.scfg.capacity)

    def _row_bucket(self, n: int) -> int:
        """Batch-row bucket: pow2 occupancy, capped at max_active."""
        return min(max(1, 1 << (n - 1).bit_length()), self.scfg.max_active)

    def _prefill_batch(self, seqs):
        """ONE padded prefill call for every sequence admitted this step:
        prompts (+ previously generated tokens — preemption resume)
        right-padded into a length bucket, rows padded to the occupancy
        bucket, each row's KV scattered into its own pages and its first
        token sampled from its own last-position logits."""
        feeds = [s.req.prompt + s.req.generated for s in seqs]
        n = len(feeds)
        tb = self._len_bucket(max(len(f) for f in feeds))
        bb = self._row_bucket(n)
        tok = np.zeros((bb, tb), np.int64)
        ln = np.zeros((bb,), np.int32)
        pt = np.zeros((bb, tb // self.scfg.page_size), np.int32)
        for i, (seq, feed) in enumerate(zip(seqs, feeds)):
            tok[i, :len(feed)] = feed
            ln[i] = len(feed)
            pt[i, :len(seq.pages)] = seq.pages
        ln_t = self._tensor(ln)
        logits, pkv = lm.batched_prefill_step(self.cfg, self.params,
                                              self._tensor(tok), ln_t)
        kv_pool.write_prompts(self.pool, pkv, self._tensor(pt), ln_t)
        emitted = []
        for seq, t in zip(seqs, self._sample(logits[:n], seqs)):
            emitted += self._push_token(seq, int(t))
        return emitted

    def _push_token(self, seq: Sequence, tok: int):
        seq.req.generated.append(tok)
        seq.last_token = tok
        if self._stopped(seq):
            req = self.sched.finish(seq)
            self.results[req.rid] = list(req.generated)
        return [(seq.req.rid, tok)]

    def _stopped(self, seq: Sequence) -> bool:
        req = seq.req
        return (len(req.generated) >= req.max_new_tokens
                or seq.last_token == self.scfg.stop_token
                or seq.length >= self.scfg.capacity)

    # -------------------------------------------------------------- sample
    def _sample(self, logits: torch.Tensor, seqs) -> np.ndarray:
        """Greedy argmax at temperature 0 (first maximum on ties, as
        ``jnp.argmax``).  Otherwise each token is drawn from a CPU
        ``torch.Generator`` seeded by ``sample_seed(seed, rid, position)``:
        deterministic under preemption and re-batching, but not the
        numbers ``jax.random`` draws."""
        logits = logits[:, :self.cfg.vocab]
        if self.scfg.temperature == 0.0:
            return logits.argmax(dim=-1).cpu().numpy()
        out = []
        for row, seq in zip(logits.float().cpu(), seqs):
            gen = torch.Generator().manual_seed(
                sample_seed(self.seed, seq.req.rid, len(seq.req.generated)))
            row = row / self.scfg.temperature
            if self.scfg.top_k:
                kth = torch.sort(row).values[-self.scfg.top_k]
                row = torch.where(row < kth, float("-inf"), row)
            out.append(int(torch.multinomial(torch.softmax(row, dim=-1), 1,
                                             generator=gen)))
        return np.asarray(out)

    # --------------------------------------------------------------- drive
    def serve(self, prompts, max_new_tokens=None) -> dict:
        """Submit a batch of prompts and run the engine to drain.
        Returns {rid: np.ndarray of generated token ids}."""
        rids = [self.submit(p, max_new_tokens) for p in prompts]
        while self.has_work():
            self.step()
        return {rid: np.asarray(self.results[rid]) for rid in rids}
