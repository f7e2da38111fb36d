#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.  Run from the root of a checkout: ``python3 chip_smoke.py``.

1. Prints the card's name and power limit, then builds every CUDA kernel
   from ``src/repro_torch/csrc`` (timed).
2. Holds each kernel against its plain PyTorch version on the card at
   paper_llama shapes (and a GQA shape, and the other head dims and page
   sizes the kernels take); times kernel, plain version and the PyTorch
   SDPA yardstick.
3. Serves paper_llama at full width (bf16) through ``ServeEngine``: 16
   staggered requests, then again with a pool small enough to force
   preemption.  Both kernels must have been launched by the serve run
   (the launch counts are reset just before it and read just after).
   The same window is then served a few more times for the spread of
   tokens/s and step times, and once under ``torch.profiler`` for the
   device's busy share and the device time of each kernel.
4. Card vs plain end to end: the f32 model with the same weights served
   through the kernels on the card and through the plain path on the
   CPU; teacher-forced logits must agree, greedy tokens must agree up to
   the first position the plain run's top-2 margin is too thin to decide.

Every phase raises on failure, so the script exits non-zero without the
last line.  The line before the last is a JSON object of per-kernel
numbers; the last line is ``{"ok": true, "device": {...}}``.  The script
imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense bf16 TC / f32
# Stated tolerances (max abs difference, kernel vs plain on the same
# inputs).  f32: both sum in f32 in another order, ~1e-6 at these sizes.
# bf16 outputs: each side rounds its f32 result to bf16; a 1e-6 difference
# can flip one rounding, and one bf16 ulp is 2^-6 for |x| in [2, 4).
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# Teacher-forced f32 logits, card (kernels, cuBLAS f32 without TF32) vs
# CPU (plain): sums reordered through 8 layers; logits are O(1).
LOGIT_TOL = 1e-3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


# ------------------------------------------------------------- timing
def time_ms(fn, inputs, iters: int = 50):
    """(device ms, host ms) per call of fn(*inputs[i % n]).  inputs are
    copies rotated through so the working set exceeds the 50 MB L2 and
    every call reads device memory, as in the model (each layer reads its
    own pool).  The host ms is the wall time of the calls, synchronised
    at the end.  For the device ms a spin kernel holds the stream while
    the host enqueues every call behind it; CUDA events around the calls
    then time the device alone, not the Python that launches them.  The
    spin covered the enqueue when the start event is still pending once
    the host has queued the last call; otherwise the spin is doubled and
    the timing repeated, and the function raises if it never covers.
    The plain versions launch a dozen kernels a call, so they are timed
    with fewer iterations to keep the queue below what blocks the host."""
    import torch
    for i in range(3):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = int(2 * host_s * 2e9)               # ~2x the enqueue at 2 GHz
    for _ in range(4):
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
        end.record()
        covered = not start.query()
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(end) / iters, host_s * 1e3 / iters
        cycles *= 2
    raise AssertionError(f"the spin never covered the enqueue of {fn}")


def copies_for(tensors, budget_bytes: int = 96 << 20):
    n = max(2, math.ceil(budget_bytes / sum(t.numel() * t.element_size()
                                             for t in tensors)))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


# ---------------------------------------------------- phase 2: kernels
def paged_case(b, h, hkv, hd, ps, lengths, dtype, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    nb = -(-max(lengths) // ps)
    n_pages = 1 + b * nb
    q = torch.randn((b, h, 1, hd), generator=g).to(dtype)
    kp = torch.randn((n_pages, hkv, ps, hd), generator=g).to(dtype)
    vp = torch.randn((n_pages, hkv, ps, hd), generator=g).to(dtype)
    kp[0] = 1e4                       # poisoned null page: masked by length
    vp[0] = -1e4
    perm = torch.randperm(n_pages - 1, generator=g) + 1   # pages out of order
    table = torch.zeros((b, nb), dtype=torch.int32)
    for i, n in enumerate(lengths):
        used = -(-n // ps)
        table[i, :used] = perm[i * nb:i * nb + used]
    ln = torch.tensor(lengths, dtype=torch.int32)
    return [t.cuda() for t in (q, kp, vp, table, ln)]


def paged_bounds(b, h, hkv, hd, ps, lengths, dtype):
    import torch
    item = torch.tensor([], dtype=dtype).element_size()
    kv_bytes = sum(-(-n // ps) * ps for n in lengths) * hkv * hd * 2 * item
    io_bytes = 2 * b * h * hd * item + 4 * b * (1 + -(-max(lengths) // ps))
    flops = 4 * sum(lengths) * h * hd
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def flash_case(b, h, hkv, hd, sq, skv, dtype, seed):
    """q/k/v as the model passes them: (b, t, heads, hd) transposed to
    (b, heads, t, hd) views (strided, last dim contiguous)."""
    import torch
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, sq, h, hd), generator=g).to(dtype).cuda()
    k = torch.randn((b, skv, hkv, hd), generator=g).to(dtype).cuda()
    v = torch.randn((b, skv, hkv, hd), generator=g).to(dtype).cuda()
    return [t.transpose(1, 2) for t in (q, k, v)]


def flash_bounds(b, h, hkv, hd, sq, skv, dtype):
    import torch
    item = torch.tensor([], dtype=dtype).element_size()
    pairs = sum(min(skv, r + (skv - sq) + 1) for r in range(sq))  # causal
    flops = 4 * b * h * pairs * hd
    nbytes = (2 * b * h * sq * hd + 2 * b * hkv * skv * hd) * item
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_kernels(card: str) -> dict:
    """Kernel vs plain on the card; returns the per-kernel record of the
    main-path shape (paper_llama, bf16) with its timings."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import attention, paged_attention, ref

    records = {}
    spread = [1, 15, 16, 17, 100, 128, 255, 256]      # page edges, 1..256
    paged_cases = [
        # (label, b, h, hkv, hd, ps, lengths, dtype)
        ("main", 8, 8, 8, 48, 16, spread, torch.bfloat16),
        ("f32", 8, 8, 8, 48, 16, spread, torch.float32),
        ("gqa", 8, 8, 2, 48, 16, spread, torch.bfloat16),
        ("hd16", 4, 4, 2, 16, 4, [1, 3, 4, 5], torch.float32),
        ("hd64", 4, 8, 4, 64, 32, [1, 31, 33, 200], torch.bfloat16),
        ("hd128", 4, 8, 8, 128, 64, [1, 63, 64, 300], torch.float32),
    ]
    for label, b, h, hkv, hd, ps, lengths, dt in paged_cases:
        args = paged_case(b, h, hkv, hd, ps, lengths, dt, SEED)
        got = paged_attention.paged_attention(*args).float()
        want = ref.paged_attention_ref(*args).float()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = KERNEL_TOL[str(dt).split(".")[-1]]
        print(f"paged_attention {label}: b={b} h={h} hkv={hkv} hd={hd} "
              f"page={ps} lengths={lengths} {dt}: max_abs_err {err:.3e} "
              f"(tol {tol:.0e})", flush=True)
        if not err <= tol:
            raise AssertionError(f"paged_attention {label} disagrees with "
                                 f"its plain version: {err} > {tol}")
        if label != "main":
            continue
        ins = copies_for(args)
        ms, host_ms = time_ms(paged_attention.paged_attention, ins)
        plain_ms, _ = time_ms(ref.paged_attention_ref, ins, iters=20)
        # yardstick: SDPA over the same KV already gathered contiguous
        # (the gather itself not timed), a boolean length mask
        sd_ins = []
        for q, kp, vp, tb, ln in ins:
            kg, vg = ref.paged_gather(kp, tb), ref.paged_gather(vp, tb)
            mask = (torch.arange(kg.shape[2], device="cuda")[None, :]
                    < ln[:, None].long())[:, None, None, :]
            sd_ins.append((q, kg, vg, mask))
        lib_ms, _ = time_ms(lambda q, k, v, m: F.scaled_dot_product_attention(
            q, k, v, attn_mask=m), sd_ins)
        bound, by = paged_bounds(b, h, hkv, hd, ps, lengths, dt)
        print(f"paged_attention main timing: kernel {ms * 1e3:.2f} us "
              f"(wrapper call on the host {host_ms * 1e3:.2f} us), "
              f"plain {plain_ms * 1e3:.2f} us, sdpa (pre-gathered) "
              f"{lib_ms * 1e3:.2f} us, bound {bound * 1e3:.3f} us ({by}) "
              f"[{card}]", flush=True)
        records["paged_attention"] = dict(
            name="paged_attention", route="cuda",
            source="src/repro_torch/csrc/paged_attention.cu",
            replaces="src/repro/kernels/paged_attention.py:108",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=by, library_ms=lib_ms)

    flash_cases = [
        # (label, b, h, hkv, hd, sq, skv, dtype)
        ("main", 8, 8, 8, 48, 128, 128, torch.bfloat16),
        ("t256", 8, 8, 8, 48, 256, 256, torch.bfloat16),
        ("f32", 8, 8, 8, 48, 128, 128, torch.float32),
        ("f32_t256", 8, 8, 8, 48, 256, 256, torch.float32),
        ("ragged", 8, 8, 8, 48, 100, 100, torch.bfloat16),
        ("ragged_shift", 8, 8, 8, 48, 37, 203, torch.float32),
        ("gqa", 8, 8, 2, 48, 200, 200, torch.bfloat16),
        ("hd16", 2, 4, 2, 16, 70, 70, torch.float32),
        ("hd32", 2, 4, 4, 32, 50, 50, torch.float32),
        ("hd64", 2, 8, 2, 64, 96, 96, torch.bfloat16),
        ("hd128", 2, 8, 4, 128, 130, 130, torch.bfloat16),
    ]
    for label, b, h, hkv, hd, sq, skv, dt in flash_cases:
        args = flash_case(b, h, hkv, hd, sq, skv, dt, SEED)
        got = attention.flash_attention(*args).float()
        want = ref.attention_ref(*args).float()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = KERNEL_TOL[str(dt).split(".")[-1]]
        print(f"flash_attention {label}: b={b} h={h} hkv={hkv} hd={hd} "
              f"sq={sq} skv={skv} {dt}: max_abs_err {err:.3e} "
              f"(tol {tol:.0e})", flush=True)
        if not err <= tol:
            raise AssertionError(f"flash_attention {label} disagrees with "
                                 f"its plain version: {err} > {tol}")
        if label not in ("main", "t256"):
            continue
        ins = copies_for(args)
        ms, host_ms = time_ms(attention.flash_attention, ins)
        plain_ms, _ = time_ms(ref.attention_ref, ins, iters=20)
        lib_ms, _ = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), ins)
        bound, by = flash_bounds(b, h, hkv, hd, sq, skv, dt)
        print(f"flash_attention {label} timing: kernel {ms * 1e3:.2f} us "
              f"(wrapper call on the host {host_ms * 1e3:.2f} us), "
              f"plain {plain_ms * 1e3:.2f} us, sdpa {lib_ms * 1e3:.2f} us, "
              f"bound {bound * 1e3:.3f} us ({by}) [{card}]", flush=True)
        if label == "main":
            records["flash_attention"] = dict(
                name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/attention.py:63",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib_ms)
    return records


# ----------------------------------------------------- phase 3: serve
def make_prompts(n, vocab, lo, hi, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (int(rng.integers(lo, hi + 1)),)).tolist()
            for _ in range(n)]


def drive(eng, prompts, new_tokens, stagger: bool):
    """Half the prompts up front, then one per step; returns per-step
    (seconds, had_prefill) and the wall time."""
    from repro_torch.kernels import attention
    first = len(prompts) // 2 if stagger else len(prompts)
    rids = [eng.submit(p, new_tokens) for p in prompts[:first]]
    pending = list(prompts[first:])
    steps = []
    t0 = time.perf_counter()
    while eng.has_work() or pending:
        if pending:
            rids.append(eng.submit(pending.pop(0), new_tokens))
        n_flash = attention.flash_attention.launches
        t = time.perf_counter()
        eng.step()                 # ends in a host read of the sampled ids
        steps.append((time.perf_counter() - t,
                      attention.flash_attention.launches > n_flash))
    wall = time.perf_counter() - t0
    for rid in rids:
        got = eng.results.get(rid)
        if got is None or len(got) != new_tokens:
            raise AssertionError(f"request {rid} did not finish with its "
                                 f"budget of {new_tokens}: {got}")
    return rids, steps, wall


def pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def device_profile(prof, wall_s: float, card: str) -> None:
    """Print the device's busy share of a profiled serve window (device
    time of every kernel and copy CUPTI saw, over the window's wall time)
    and the device time of its heaviest kernels."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in rows)
    if not rows:
        print("device busy share: not measured (the profiler saw no device "
              "time)", flush=True)
        return
    print(f"profiled serve window: {wall_s * 1e3:.3f} ms wall, device busy "
          f"{busy_us / 1e3:.3f} ms = {100 * busy_us / (wall_s * 1e6):.2f}% "
          f"[{card}]", flush=True)
    for e in sorted(rows, key=dev_us, reverse=True)[:10]:
        print(f"  device {dev_us(e):10.1f} us {e.count:5d} calls "
              f"{dev_us(e) / e.count:8.2f} us/call "
              f"{100 * dev_us(e) / busy_us:5.1f}%  {e.key[:90]}", flush=True)


def serve_full_width(card: str) -> dict:
    """Returns the launch count of each kernel in the main serve run."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import attention, paged_attention
    from repro_torch.serving.config import ServeConfig
    from repro_torch.serving.engine import ServeEngine

    cfg = configs.get("paper_llama")
    serve = ServeConfig(page_size=16, max_active=8, max_seq=256,
                        max_queue=64)
    eng = ServeEngine(cfg, serve, device="cuda", seed=SEED)
    prompts = make_prompts(16, cfg.vocab, 8, 128, SEED)
    ServeEngine(cfg, serve, eng.params, device="cuda").serve(
        prompts[:2], 4)                                  # warm-up
    torch.cuda.synchronize()

    attention.flash_attention.launches = 0
    paged_attention.paged_attention.launches = 0
    rids, steps, wall = drive(eng, prompts, 32, stagger=True)
    launches = {"flash_attention": attention.flash_attention.launches,
                "paged_attention": paged_attention.paged_attention.launches}
    print(f"serve paper_llama bf16: {len(rids)} requests x 32 tokens in "
          f"{len(steps)} steps, max active {eng.max_observed_active}, "
          f"launches {launches}", flush=True)
    for name, n in launches.items():
        if n == 0 or n % cfg.n_layers:
            raise AssertionError(f"{name} launched {n} times in the serve "
                                 f"run (want a positive multiple of "
                                 f"{cfg.n_layers})")
    # the same window again on fresh engines, for the spread between
    # windows of one machine (the host is shared, so host-bound steps vary)
    tps = [32 * len(rids) / wall]
    dec = [s for s, pre in steps if not pre]
    for _ in range(4):
        e = ServeEngine(cfg, serve, eng.params, device="cuda")
        r, st, w = drive(e, prompts, 32, stagger=True)
        tps.append(32 * len(r) / w)
        dec += [s for s, pre in st if not pre]
    print(f"serve metrics over {len(tps)} windows of 16 x 32 tokens: tok/s "
          f"{', '.join(f'{x:.1f}' for x in tps)}; decode step p50 "
          f"{pct(dec, 0.5) * 1e3:.3f} ms p99 {pct(dec, 0.99) * 1e3:.3f} ms "
          f"over {len(dec)} decode-only steps [{card}]", flush=True)

    from torch.profiler import ProfilerActivity, profile
    e = ServeEngine(cfg, serve, eng.params, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, w = drive(e, prompts, 32, stagger=True)
        torch.cuda.synchronize()
    device_profile(prof, w, card)

    tight = dataclasses.replace(serve, pages=1 + 30)   # + the null page
    eng2 = ServeEngine(cfg, tight, eng.params, device="cuda")
    rids2, _, wall2 = drive(eng2, prompts, 32, stagger=True)
    if eng2.sched.n_preempted == 0:
        raise AssertionError("the 30-page pool forced no preemption")
    same = sum(eng2.results[r2] == eng.results[r1]
               for r1, r2 in zip(rids, rids2))
    print(f"serve with a pool of 30 pages (+ the null page): "
          f"{eng2.sched.n_preempted} preemptions, all {len(rids2)} requests "
          f"finished, {32 * len(rids2) / wall2:.1f} tok/s; "
          f"{same}/{len(rids2)} token streams equal to the unpreempted run "
          f"(bf16: a resumed request re-prefills its generated tokens, so a "
          f"thin margin may flip) [{card}]", flush=True)
    return launches


# ----------------------------------------- phase 4: card vs plain, f32
def teacher_forced_logits(cfg, params, prompts, forced, device):
    """Logits of prefill + every decode step, feeding ``forced`` tokens
    (n, steps) instead of sampling, through the engine's own calls."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    from repro_torch.serving import kv_pool

    ps, n = 16, len(prompts)
    t = -(-max(len(p) for p in prompts) // ps) * ps
    nb = -(-(t + forced.shape[1]) // ps)
    pool = kv_pool.init_pool(cfg, 1 + n * nb, ps, device=device)
    table = (1 + np.arange(n * nb, dtype=np.int32)).reshape(n, nb)
    tok = np.zeros((n, t), np.int64)
    for i, p in enumerate(prompts):
        tok[i, :len(p)] = p
    ln = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                      device=device)
    with torch.inference_mode():
        logits, cache = lm.batched_prefill_step(
            cfg, params, torch.from_numpy(tok).to(device), ln)
        kv_pool.write_prompts(pool, cache,
                              torch.from_numpy(table[:, :t // ps]).to(device),
                              ln)
        out = [logits]
        pt = torch.from_numpy(table).to(device)
        for j in range(forced.shape[1] - 1):
            x = torch.from_numpy(forced[:, j:j + 1].astype(np.int64))
            logits, pool = lm.paged_decode_step(cfg, params, pool, pt, ln,
                                                x.to(device))
            ln = ln + 1
            out.append(logits)
    return torch.stack(out, dim=1).float().cpu()       # (n, steps, V)


def card_vs_plain(card: str) -> None:
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serving.config import ServeConfig
    from repro_torch.serving.engine import ServeEngine

    cfg = dataclasses.replace(configs.get("paper_llama"), dtype="float32")
    serve = ServeConfig(page_size=16, max_active=8, max_seq=256)
    params_cpu = lm.init_params(cfg, SEED, "cpu")
    params_gpu = {k: ({kk: vv.cuda() for kk, vv in v.items()}
                      if isinstance(v, dict) else v.cuda())
                  for k, v in params_cpu.items()}
    prompts = make_prompts(4, cfg.vocab, 8, 64, SEED + 1)
    new = 16
    plain = ServeEngine(cfg, serve, params_cpu, device="cpu").serve(
        prompts, new)
    card_out = ServeEngine(cfg, serve, params_gpu, device="cuda").serve(
        prompts, new)
    forced = np.stack([plain[r] for r in sorted(plain)])
    lg_cpu = teacher_forced_logits(cfg, params_cpu, prompts, forced, "cpu")
    lg_gpu = teacher_forced_logits(cfg, params_gpu, prompts, forced, "cuda")
    err = (lg_cpu - lg_gpu).abs().max().item()
    print(f"card vs plain (paper_llama f32, 4 requests x {new} tokens): "
          f"teacher-forced logits max_abs_err {err:.3e} (tol {LOGIT_TOL:.0e})"
          f", |logits| max {lg_cpu.abs().max().item():.3f}", flush=True)
    if not err <= LOGIT_TOL:
        raise AssertionError(f"card logits disagree with plain: {err}")
    top2 = lg_cpu.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).numpy()        # (n, steps)
    for i, rid in enumerate(sorted(plain)):
        thin = np.nonzero(margin[i] < 2 * LOGIT_TOL)[0]
        upto = int(thin[0]) if thin.size else new
        if not np.array_equal(card_out[rid][:upto], plain[rid][:upto]):
            raise AssertionError(
                f"request {rid}: card tokens {card_out[rid].tolist()} != "
                f"plain {plain[rid].tolist()} before position {upto}")
        if thin.size:
            print(f"request {rid}: plain top-2 margin below "
                  f"{2 * LOGIT_TOL:.0e} first at position {upto}; tokens "
                  f"compared up to it", flush=True)
    equal = sum(np.array_equal(card_out[r], plain[r]) for r in plain)
    print(f"greedy tokens: {equal}/{len(plain)} requests identical on card "
          f"and plain [{card}]", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False    # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    paths = _build.build()
    print(f"built {sorted(paths)} in {time.perf_counter() - t:.1f} s",
          flush=True)
    for name, path in sorted(paths.items()):
        log = Path(str(path) + ".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    records = check_kernels(card)
    launches = serve_full_width(card)
    for name, rec in records.items():
        rec["launches"] = launches[name]
    card_vs_plain(card)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys}
                                  for rec in records.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
