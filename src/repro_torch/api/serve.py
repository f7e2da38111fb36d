"""ServeSession: prefill + decode + KV-cache management behind one object
(counterpart of ``repro.api.serve``).

Parameters come from (in order of precedence): the ``params`` argument,
the spec's checkpoint directory when ``ckpt.resume`` is set (serve a
trained run), or a fresh seeded init — the ``serving.reload`` resolution
the continuous-batching ServeEngine uses too.

The port has two decode paths, picked by family (``api.build``).  The
dense-attention families decode over a paged pool in which each
sequence owns ``ceil(max_seq / page_size)`` pages through a fixed block
table (``build.new_decode_cache``): ``generate`` runs one prefill over
the whole prompt batch (``lm.batched_prefill_step``: the flash forward
kernel), scatters its KV into the pages and decodes greedily through
``lm.paged_decode_step`` (the paged_attention kernel).  The MoE family
(GQA, or MLA over its int8 compressed cache), the enc-dec family
(whisper: self and cross KV caches) and the ssm families (the Mamba-2
hybrid, xLSTM) decode on JAX's contiguous path: ``generate`` runs
``lm.prefill_step`` over the unpadded prompt (padding would change the
MoE's token count, and so its expert capacity, and a recurrent state),
seeds its cache into ``lm.init_cache(batch, max_seq)``
(``build.seed_cache``, JAX's ``_seed_cache``) and decodes through
``lm.decode_step`` (attention on the paged kernel, the contiguous cache
one page a row).

The enc-dec family takes ``enc_frames`` (b, frames, d), the encoder's
input, in ``prefill`` and ``generate``.  The reference's cross cache is
sized to ``max_seq``, not to the frames: the prefill's cross K/V is
written at offset 0, and each decode step attends over all ``max_seq``
columns without a mask, as JAX's does.  So only ``max_seq`` equal to the
frame count gives a decode without zero columns; a longer cache weighs
its zero columns in the softmax (the tokens change, in JAX too), and a
shorter one raises.

Serving runs in one process, unsharded.  A mesh it would not compute as
JAX shards it is refused by name (``RunSpec.check_serves``: tp > 1, the
MoE family over data shards, the enc-dec family with FSDP); dense and
recurrent rows at dp > 1 or with FSDP are JAX's rows.  JAX's
token-by-token replay, which exists for its flash-decode seq-sharded
cache, is not ported: ``seq_shard_cache=True`` is refused.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import device as device_util
from ..models import lm
from ..serving import kv_pool
from ..serving import reload as serving_reload
from . import build
from .spec import RunSpec, SpecError


class ServeSession:
    def __init__(self, spec: RunSpec, params=None, *, device=None, cfg=None,
                 seq_shard_cache: bool = False):
        if seq_shard_cache:
            raise SpecError("seq_shard_cache: the flash-decode seq-sharded "
                            "cache is not ported (the port decodes over "
                            "one paged pool on one device)")
        self.cfg = cfg if cfg is not None else spec.model_config()
        self.contiguous = lm.serves_contiguous(self.cfg)
        spec.validate()
        spec.check_serves(self.cfg)
        self.spec = spec
        self.device = device_util.resolve(device, "ServeSession")
        if params is not None:
            self.params, self.params_step = params, None
        else:
            self.params, self.params_step = serving_reload.resolve_params(
                spec, self.cfg, self.device)
        self._prefill = build.build_prefill_step(spec, self.cfg)
        self._decode = build.build_decode_step(spec, self.cfg)

    def _tokens(self, tokens) -> torch.Tensor:
        if isinstance(tokens, torch.Tensor):     # a card's argmax, say
            return tokens.to(self.device, torch.int64)
        return torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                               device=self.device)

    # ------------------------------------------------------------ serving
    def _frames(self, enc_frames):
        """``enc_frames`` on the session's device; refused by name where
        the family has no encoder (``lm.prefill_step`` refuses a missing
        one where it has)."""
        if enc_frames is None:
            return {}
        if not self.cfg.enc_dec:
            raise ValueError(f"enc_frames given to {self.cfg.name}, which "
                             f"has no encoder")
        if not isinstance(enc_frames, torch.Tensor):
            enc_frames = torch.from_numpy(np.array(enc_frames))
        return {"enc_frames": enc_frames.to(self.device)}

    @torch.inference_mode()
    def prefill(self, tokens, enc_frames=None):
        """(logits (b, V) f32 at the last position, prefill cache) for a
        prompt batch: {"layers": {"k","v": (L, b, kvl, t, hd)}}, or the
        contiguous families' cache of the prompt (``lm.prefill_step``;
        the enc-dec family's with its ``enc_frames`` (b, frames, d))."""
        return self._prefill(self.params, self._tokens(tokens),
                             **self._frames(enc_frames))

    def new_cache(self, batch: int, max_seq: int) -> dict:
        """An empty decode cache for ``batch`` sequences of up to
        ``max_seq`` tokens: a paged pool, or JAX's contiguous cache
        (``lm.init_cache``)."""
        return build.new_decode_cache(self.spec, self.cfg, batch, max_seq,
                                      self.device)

    @torch.inference_mode()
    def decode(self, cache, token, pos: int):
        """One decode step of every row at position ``pos``; a paged
        pool and a contiguous KV cache are written in place.  Returns
        (logits (b, V) f32, cache)."""
        return self._decode(self.params, cache, self._tokens(token), pos)

    def engine(self):
        """A continuous-batching ServeEngine over this session's spec and
        params (paged KV pool, per-request scheduling)."""
        from ..serving.engine import ServeEngine
        return ServeEngine.from_spec(self.spec, params=self.params,
                                     device=self.device, cfg=self.cfg)

    @torch.inference_mode()
    def generate(self, prompts, gen_len: int, max_seq: int | None = None,
                 enc_frames=None):
        """Greedy decode: one prefill over the prompt batch, its KV
        scattered into each row's pages (or, for the contiguous
        families, the prompt's cache seeded into a ``max_seq`` one; the
        enc-dec family's cross cache too, which the module docstring's
        caveat on ``max_seq`` concerns), then argmax sampling one token
        per decode step.  Returns (batch, gen_len) int64 token ids."""
        frames = self._frames(enc_frames)
        prompts = self._tokens(prompts)
        batch, prompt_len = prompts.shape
        max_seq = max_seq or prompt_len + gen_len
        assert max_seq >= prompt_len + gen_len, (max_seq, prompt_len, gen_len)
        if self.contiguous:
            logits, pre = self._prefill(self.params, prompts, **frames)
            cache = build.seed_cache(self.new_cache(batch, max_seq), pre)
            return self._greedy(logits, cache, prompt_len, gen_len)
        ps = self.spec.serve.page_size
        t_pad = -(-prompt_len // ps) * ps      # whole pages for the scatter
        cache = self.new_cache(batch, max(max_seq, t_pad))
        padded = torch.zeros((batch, t_pad), dtype=torch.int64,
                             device=self.device)
        padded[:, :prompt_len] = prompts
        lengths = torch.full((batch,), prompt_len, dtype=torch.int32,
                             device=self.device)
        logits, pre = self._prefill(self.params, padded, lengths)
        kv_pool.write_prompts(cache["pool"], pre,
                              cache["page_table"][:, :t_pad // ps], lengths)
        return self._greedy(logits, cache, prompt_len, gen_len)

    def _greedy(self, logits, cache, prompt_len: int, gen_len: int):
        """The argmax of the prefill's logits, then gen_len - 1 decode
        steps from ``cache``, each feeding the last argmax."""
        vocab = self.cfg.vocab
        tok = logits[:, :vocab].argmax(-1)[:, None]
        out = [tok]
        for i in range(gen_len - 1):
            logits, cache = self._decode(self.params, cache, tok,
                                         prompt_len + i)
            tok = logits[:, :vocab].argmax(-1)[:, None]
            out.append(tok)
        return torch.cat(out, dim=1)
