"""Continuous-batching scheduler: admission, growth, preemption (copy of
``repro.serving.scheduler``).

Pure host-side bookkeeping — no tensors.  The engine drives it once per
decode step: ``admit()`` pulls queued requests into free slots while
pages last (FCFS with head-of-line blocking so long prompts cannot
starve), ``grow()`` extends a sequence's page table when it crosses a
page boundary, and when the pool runs dry the engine preempts the
youngest sequence — its pages are freed and the request re-queued at the
FRONT with its generated tokens kept, so re-admission prefills
prompt + generated and continues exactly where it left off.
"""
from __future__ import annotations

import dataclasses
from collections import deque

from .config import ServeConfig
from .kv_pool import PageAllocator


class QueueFull(RuntimeError):
    """submit() would exceed ServeConfig.max_queue."""


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new_tokens: int
    generated: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Sequence:
    """An admitted request bound to physical pages.  ``length`` counts
    cache entries written so far (prompt + generated tokens whose KV is
    in the pool); ``last_token`` is the next decode input."""
    req: Request
    pages: list
    length: int = 0
    last_token: int = 0


class Scheduler:
    def __init__(self, cfg: ServeConfig, alloc: PageAllocator):
        self.cfg = cfg
        self.alloc = alloc
        self.queue: deque = deque()
        self.active: list = []    # index == engine slot row
        self.n_preempted = 0
        self._next_rid = 0

    def has_work(self) -> bool:
        return bool(self.queue or self.active)

    def submit(self, prompt, max_new_tokens=None) -> int:
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        mnt = self.cfg.max_new_tokens if max_new_tokens is None \
            else int(max_new_tokens)
        if mnt < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {mnt}")
        if len(prompt) + mnt > self.cfg.capacity:
            raise ValueError(
                f"prompt ({len(prompt)}) + budget ({mnt}) exceeds "
                f"serve.max_seq capacity ({self.cfg.capacity})")
        if len(self.queue) >= self.cfg.max_queue:
            raise QueueFull(f"serve.max_queue={self.cfg.max_queue}")
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, prompt, mnt))
        return rid

    def admit(self) -> list:
        """Move queued requests into free slots while pages last.
        Returns the newly-admitted Sequences (engine must prefill them)."""
        new = []
        while self.queue and len(self.active) < self.cfg.max_active:
            req = self.queue[0]
            feed = len(req.prompt) + len(req.generated)
            nb = -(-feed // self.cfg.page_size)
            pages = self.alloc.alloc(nb)
            if pages is None:
                break  # head-of-line blocking: keep FCFS order
            self.queue.popleft()
            seq = Sequence(req, pages, length=feed)
            self.active.append(seq)
            new.append(seq)
        return new

    def grow(self, seq: Sequence) -> bool:
        """Ensure seq has a page for the cache entry at index
        ``seq.length`` (the token about to be decoded).  False = pool
        exhausted; caller must preempt someone."""
        blk = seq.length // self.cfg.page_size
        if blk < len(seq.pages):
            return True
        got = self.alloc.alloc(1)
        if got is None:
            return False
        seq.pages.extend(got)
        return True

    def preempt_youngest(self) -> Sequence:
        """Evict the most recently admitted sequence: free its pages and
        push its request back to the FRONT of the queue (generated
        tokens kept, so re-admission resumes exactly)."""
        seq = self.active.pop()
        self.alloc.free(seq.pages)
        seq.pages = []
        self.queue.appendleft(seq.req)
        self.n_preempted += 1
        return seq

    def finish(self, seq: Sequence) -> Request:
        self.active.remove(seq)
        self.alloc.free(seq.pages)
        seq.pages = []
        return seq.req
