#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.  Run from the root of a checkout: ``python3 chip_smoke.py``.

1. Prints the card's name and power limit, then builds every CUDA kernel
   from ``src/repro_torch/csrc`` (timed, all sources in parallel).
2. Holds each kernel against its plain PyTorch version on the card at
   the main paths' shapes (and a GQA shape, and the other head dims and
   page sizes the kernels take): paged decode, flash forward (with and
   without the log-sum-exp), flash backward, and the pam4 encode/decode
   pair (bit for bit, ties, zero blocks and ragged tails included);
   times each kernel, its plain version and a PyTorch yardstick where
   one call computes the same function.  The paged checks
   (``check_kernels``) print each paged kernel's registers and spills,
   cover one slot over every split, slots of length 0 among others (held
   to zeros), all lengths 1, minitron_4b's heads (rep 3, hd 128) and the
   mixed dtype pairs, run the main case twice for identical bits, and
   time it beside gather + SDPA, the plain version, an empty kernel
   launch and other split sizes.  The pam4 checks
   (``check_training_kernels``) print each pam4 kernel's registers and
   spills, add encodes of views off the 16-byte alignment, a row stride
   that is not a multiple of 4 and blocks of 1000 and 999, and every
   decode form (one line a case, with its form) at bits 2, 4 and 8: sums
   of n = 1 to 4 peers with Q(mean) ties and zero blocks, ragged tails, 4
   rows with m % 4 != 0, and the error-feedback form with bases off 16
   bytes or of a row stride 2 mod 4; they time encode, and decode at its
   two main-path shapes (one bucket's Q(mean); the error-feedback term
   of 4 peers from bucket views of a full peer stack), each beside a
   device ``copy_`` of the same bytes.  Alone: ``python3 -c 'import
   chip_smoke as c; c.check_training_kernels(c.card_line())'``.  The
   flash checks (``check_flash_kernels``) cover every case in bf16, the
   tensor-core kernels, and in f32, the CUDA-core kernels; they print
   each flash kernel's registers, spills and HMMA count, run the backward
   twice for bit-equal gradients, and time the forward at t 128, 256 and
   512 (the training shape) and the backward at t 512 beside SDPA, then
   both at one sequence of 512 and at t 2048.  Alone, for iterating on
   them: ``python3 -c 'import chip_smoke as c;
   c.check_flash_kernels(c.card_line())'``.
3. Serves paper_llama at full width (bf16) through ``ServeEngine``: 16
   staggered requests, then again with a pool small enough to force
   preemption.  Both serving kernels must have been launched by the serve
   run (the launch counts are reset just before it and read just after).
   The same window is then served a few more times for the spread of
   tokens/s and step times, and once under ``torch.profiler`` for the
   device's busy share, the device time of each kernel and the paged
   kernels' share of it.
   2c. The ``onn_layer`` kernel (``check_onn_kernel``): each kernel's
   registers and spills; every layer of the bits-8 ONN
   (4-64-128-256-128-64-4) and of the exact identity ONN (1-4-1) over
   one full bucket of rows on the form the wrapper's plan picks, and
   the edges of each form (rows 1, 127, 129, 1000; a partial k chunk;
   masked columns; a ring that runs across row tiles; an x view off the
   16-byte alignment; a ragged shape with d != 1), each against its
   plain version, twice for identical bits and equal to the general
   form; timed at every bucket shape beside the general form (the first
   kernel), the plain version, one PyTorch call
   (``torch._addmm_activation`` with its fused ReLU, ``torch.addmm`` for
   the last layer) and ``addmm`` + ``relu``, all in f32 without TF32.
   Alone: ``python3 -c 'import chip_smoke as c;
   c.check_onn_kernel(c.card_line())'``.
   2d. The ``mesh_scan_blocks`` kernel against its plain version on
   random Givens-programmed meshes of every width of the mesh path (4,
   64, 128, 256; B = 1, 2 and 16), both transposes, shared and blocked
   x, a post_scale, 1000 ragged rows and two row tiles; then widths
   that are not a multiple of 32 (9, 33, 100), 512 and 600, 777 rows, a
   stack of meshes of different depths and an x off the vector
   alignment: bit for bit without noise, within MESH_THETA_TOL with the
   theta drift; timed over a full bucket at the path's two largest
   launches beside its plain version and the dense f32 product of the
   same linear map, and once with the drift.  Alone, for iterating on the kernel: ``python3 -c 'import
   chip_smoke as c; c.check_mesh_kernel(c.card_line())'``.
4. Trains paper_llama at full width (bf16) through the training entry
   point, ``--sync optinc --bits 8 --block 2048 --mesh 4x1`` (four
   data-parallel peers stacked on the card), global batch 32 x 512
   tokens, 30 steps: the loss must fall and the four training kernels
   (flash forward and backward, pam4 encode and decode) must have been
   launched by the run (counts reset just before, read just after): the
   flash pair once a layer and peer each step, pam4 once a bucket, every
   encode on a vector form and every decode on the aligned one (the
   count of each form is printed).
   Step time p50/p99 and tokens/s; one step under ``torch.profiler``,
   with the flash and pam4 kernels' shares of its device time; a short
   ``--sync psum`` run of the same config as a yardstick.
   4f. Sessions (``repro_torch.api``), the same config with
   ``--error-feedback`` and a temporary ``--ckpt-dir`` under build/
   (deleted after): (a) a TrainSession runs 10 steps, checkpointing
   every 5; (b) another runs 5, and a fresh one with ``--resume
   --sparse-residuals`` must start at step 5, give (a)'s losses for steps
   5-9 bit for bit and launch the flash and pam4 kernels (counts reset
   just before, read just after); the seconds of one save (waited on)
   and of a resuming session, and the bytes of ``arrays.npz``, dense and
   block-sparse; (c) a ServeSession with ``ckpt.resume`` serves (a)'s
   step-9 checkpoint: ``generate`` on 8 seeded prompts (8-128 tokens)
   x 32 new tokens must give a ServeEngine's greedy tokens on the same
   parameters and launch flash and ``paged_attention``; (d) a ServeEngine
   with ``reload_every=1`` serves while (b) trains and checkpoints step
   10: the swap to step 10 must be seen, and the requests admitted after
   it must get a fresh engine's tokens.  Alone: ``python3 -c 'import
   chip_smoke as c; c.sessions_full_width(c.card_line())'``.
   4d. (run before 4b) The paper's scenario-1 ONN trained on the card
   (``photonics.training``: 4-64-128-256-128-64-4, layers 1-6
   approximated, bits 8, N 4, K 4, the full 28,561-sample grid, 3000
   epochs, stage 2 from 2400): once in the paper's project mode as
   ``examples/quickstart.py --scenario1`` does, once in cayley mode
   through ``runtime.get_module(params='train')``.  For each: seconds,
   first and last loss, the accuracy through the plain path, the
   ``onn_layer`` kernel and the ``mesh_scan`` kernel (both backends), the
   error histogram, and the paper's 1.0 and Table II's worst row beside
   it; a kernel path's count of exact samples may differ from the plain
   path's only by the samples within ONN_MARGIN of a threshold.  The ONN
   with the higher onn_layer accuracy is installed (``put_module``) for
   4b, 4c and 4e.  Alone (it prints the chosen ONN): ``python3 -c
   'import chip_smoke as c; c.trained_onn_full_width(c.card_line())'``.
   4b. The same config through the in-network ONN: ``--fidelity onn
   --bits 2`` (the exact identity ONN) for 10 steps must print the
   losses of ``--fidelity behavioral --bits 2`` and launch ``onn_layer``
   2 x 42 times a step (in every run pam4 encode and decode once a
   bucket, each decode on the aligned form); ``--fidelity onn --bits 8``
   through the trained ONN for 10 steps beside phase 4's first 10
   behavioral losses, 6 x 42 launches a step, and the share of one
   bucket's codes that differ from behavioral Q(mean); if the ONN is
   exact on the whole grid, the losses must be behavioral's.  Step
   times, and one profiled step at each bit width.
   4c. The same config through the ONN's MZI meshes (``--fidelity
   mesh``): at ``--bits 2`` for 10 steps the losses of the behavioral
   run and no ``mesh_scan`` launch (the exact identity has no rotation);
   at ``--bits 8`` through the trained Table I row 1 ONN for 3 steps on
   ``--mesh-backend pallas`` and 1 on ``xla`` (the same step-0 loss),
   6 x 42 launches a step, beside phase 4's losses; a seeded ONN of the
   default structure (no approximated layer) for 2 steps, 12 x 42 a
   step, for its timing; pam4 as in 4b.  Step times, peak memory, one
   profiled step.
   4e. PhaseNoise through the trained ONN, ``--fidelity mesh --bits 8
   --theta-drift-std 0.02 --shot-noise-std 0.01``: 2 steps on pallas,
   whose 6 x 42 mesh launches a step must all take the kernel's drift
   branch (``mesh_scan_blocks.branches``), the same 2 steps again with
   the same seed for the same losses, 1 step on xla (the drift in tensor
   ops, no drift launch); step times and losses beside the clean run's;
   then ``--bits 2`` with the same stds for 8 steps beside behavioral.
   4g. The other sync modes on phase 4's config (``sync_modes_full_width``;
   alone: ``python3 -c 'import chip_smoke as c;
   c.sync_modes_alone(c.card_line())'``), each run with the launch
   counts reset just before it and read just after: ``--sync ring``
   (10 steps, no pam4 launch) equal to phase 4's psum losses bit for
   bit; ``--sync cascade --pods 2 --mesh 2x1`` (10 steps) equal to
   phase 4's first 10 optinc losses bit for bit; the paper's 16-server
   cascade, ``--pods 4 --mesh 4x1`` (5 steps), whose loss must fall;
   the photonic cascade at ``--bits 2``, ``--fidelity onn`` and
   ``mesh`` (10 steps each), equal to the behavioral cascade's losses
   bit for bit, with 4 ``onn_layer`` launches a bucket at onn and no
   ``mesh_scan`` launch; ``--error-layers 3,4,5,6`` (10 steps, twice for
   the same losses) with the Table-II hits within INJECT_SIGMAS of their
   binomial expectation; and ``--overlap --error-feedback`` against the
   barrier path in turns (10 steps each, barrier, overlap, overlap,
   barrier): the same losses bit for bit and buckets launched before the
   last peer's backward ended.  Step p50 and peak memory of each run.
   4h. Peers as processes (``processes_full_width``; alone: ``python3 -c
   'import chip_smoke as c; c.processes_alone(c.card_line())'``), each
   launched through ``python -m torch.distributed.run --standalone -m
   repro_torch.launch.train``, rank 0's step lines and rank report read
   back: a world of one on NCCL (``--mesh 1x1 --error-feedback``, 10
   steps) equal to the stacked 1-peer run bit for bit, on every run;
   with 4 cards, 4 ranks (one a card) of optinc bits 8 with feedback,
   ring, cascade ``--pods 2``, onn bits 2, overlap with feedback and
   psum, 10 steps each, against the stacked 4-peer run of the same spec
   on one card: bit for bit but psum, each mode's step p50/p99 and
   tokens/s beside the stacked run's, the bytes each rank handed to each
   collective a step beside ``bytes_on_wire`` (optinc bits 8: 2 bytes a
   code reduce-scattered, 1 all-gathered), each rank's kernel launches
   (flash once a layer a step, pam4 encode once a bucket); then psum's
   first-step synced gradients (a rank worker of this script, ``python3
   chip_smoke.py --psum-grads <file>`` under torchrun) within PSUM_ULPS
   spacings of the stacked sum.  With one card the phase prints that
   the 4-rank part needs 4 cards.
   4i. FSDP, tensor parallelism and remat groups (``sharded_full_width``;
   alone ``sharded_alone``): deepseek_coder_33b at its published widths
   with 1 layer as a world of one on NCCL (``--fsdp --remat-groups 2
   --sync optinc --bits 8``, one sequence of 4096, 5 steps; its
   ``--train-layers`` rank worker cuts the depth): finite, falling
   losses, step p50, tokens/s, peak memory, launches; paper_llama's
   ``--fsdp`` world of one against the stacked 1-peer ``--fsdp`` run and
   ``--remat-groups 2`` against none, bit for bit; the flash forward and
   backward at deepseek's shape (hd 128, t 4096, bf16) against their
   plain versions, timed beside SDPA and the bound.  With 4 cards: (a)
   ``--pods 2 --mesh 2x1 --fsdp --error-feedback`` as 4 ranks against 4
   stacked peers, bit for bit; (b) ``--mesh 2x2``: step 0's loss against
   the stacked dp-2 run's, the model-sharded leaves' step-0 gradients 2x
   the tp-1 ones (a ``--tp-grads`` rank worker), falling losses; (c)
   deepseek_coder_33b with 8 layers on ``--mesh 2x2 --fsdp``; every
   run's bytes a rank a step by axis, op and dtype equal to those
   derived from the shapes.
   4j. ResNet-50 on CIFAR-100 shapes (``resnet_full_width``; alone
   ``resnet_alone``, with a seeded ONN): benchmarks/fig7a.py's step
   (each peer's ``resnet.loss_fn`` gradients, one ``sync_gradients``,
   SGD) at full width, 100 classes, 32 x 32 x 3 ``synthetic_images``, 4
   peers stacked on one card, 64 images a peer, TF32 off and cuDNN
   deterministic: (a) 6 steps each of psum, ring, optinc bits 8
   (twice), Table-II injection, bits 2 at behavioral, onn and mesh and
   cascade over 2 pods, then 3 onn and 2 mesh bits-8 steps through
   phase 4d's ONN; losses finite and falling, the bits-2 runs, the
   cascade and the repeat bit-equal to their twins, ring within
   RESNET_RING_TOL of psum, the injection hits of each step within
   INJECT_SIGMAS, every kernel's launches (pam4 once a bucket, 23 a
   step); step p50/p99, images/s and peak memory of each run, the pam4
   forms of the ragged last bucket, a profiled step; (b) a narrow f32
   step card vs CPU (loss and gradients within tolerance, the synced
   gradients bit for bit in optinc and ring); (c) with 4 cards, 4
   ``chip_smoke.py --resnet-rank`` ranks (NCCL) against the stacked
   runs: bit for bit in optinc, ring and cascade, psum's first-step
   gradients within PSUM_ULPS spacings, optinc's bytes a rank a step
   equal to the count derived from the buckets (``resnet_processes_alone``
   on a 4-card host).
   4k. The MoE family (``moe_full_width``; alone ``moe_alone``; run
   after 4i): (a) phi35_moe_42b at its published widths (d 4096, 32/8
   heads, 16 experts top-2, moe_d_ff 6400, vocab 32064) cut to
   PHI_LAYERS layer, a world of one on NCCL, ``--sync optinc --bits 8
   --lr 1e-5``, one sequence of 4096, 5 steps: finite losses, step
   p50/p99, tokens/s, peak memory beside the reckoning, the capacity
   (641 tokens an expert), step 0's loss and aux loss from a forward of
   the seeded weights in the rank before the run, and the flash and pam4
   launches; (b) the phi35 and
   deepseek_v3 SMOKE configs in f32, one 2-peer step card vs CPU (loss
   and pre-sync gradients within phase 5's tolerances, the synced
   gradients and residuals bit for bit), deepseek's through MLA's
   (24, 16) flash instantiation, which is then timed at that shape;
   deepseek's SMOKE step in bf16 (its experts' ``index_add``) twice from
   the same state, bit for bit;
   (c) deepseek_v3's MLA block at its published widths (QK 192, V 128,
   128 heads, seq 4096) forward and backward through
   ``blocks.mla_attention`` (the (192, 128) launches), and the flash
   forward and backward at that shape against their plain versions,
   timed beside SDPA and the bound; (d) with 4 cards, phi35_moe_42b
   with PHI_LAYERS_4 layers on ``--mesh 2x2 --fsdp`` (8 experts a rank):
   finite losses, the bytes a rank a step against the shapes, and a
   ``chip_smoke.py --moe-grads`` rank worker for the step-0 loss against
   the stacked dp-2 run's and the 2x gradients of the model-sharded
   leaves at tp 2.  deepseek_v3_671b at its published widths does not
   fit four H100s (PERF.md has the arithmetic).
   4l. The encoder-decoder family (``whisper_phase``; alone
   ``whisper_alone``): (a) the flash forward and backward's non-causal
   mode against their plain versions at whisper's encoder shape (b 8, h
   6, 1500 x 1500, hd 64, bf16), its cross shape (448 queries over 1500
   keys) and a ragged f32 case with sq 37 > skv 32, timed beside SDPA
   (``is_causal=False``) and the bound; (b) whisper_tiny at its
   published widths (4 + 4 layers, d 384, 6 heads, vocab 51865, 1500
   frames) through ``launch/steps.make_train_step``, 4 stacked peers x 8
   rows, t 448, seeded ``enc_frames``, ``--sync optinc --bits 8``, 10
   steps: falling losses, step p50/p99, tokens/s, frames/s, peak memory,
   the flash launches split by mask equal to the layers' count (a step:
   4 peers x (4 encoder + 4 cross) non-causal, 4 x 4 causal), pam4 once
   a bucket, the last step profiled; 10 psum steps as a yardstick; (c)
   its SMOKE step (2 peers x 2 rows, t 37, 32 frames, f32) card vs CPU,
   the synced gradients bit for bit.
   4m. qk-norm and the Mamba-2 hybrid (``hybrid_phase``; alone
   ``hybrid_alone``): (a) the flash forward and backward at the new
   head dims against their plain versions, timed beside SDPA (GQA) and
   the bound: qwen3_32b's shape (64 query and 8 KV heads of 80, one
   sequence of 4096, bf16, with the lse), zamba2_7b's shared block's (32
   heads of 112) and a ragged f32 case at each dim, with the ptxas lines
   of the (80, 80) and (112, 112) instantiations; the paged decode
   kernel at qwen3's head layout (hd 80, 64/8 heads, pages of 16,
   lengths 1-256, bf16) against its plain version, timed beside gather
   + SDPA; (b) qwen3_32b at its published widths cut to 1 layer, a
   world of one on NCCL in this process (``--fsdp --mesh 1x1 --sync
   optinc --bits 8``, the sync taking the replicated leaves only), seq
   4096, lr 1e-5, 5 steps and a 6th traced on the device: finite
   falling losses, step p50/p99, tokens/s, peak memory beside the
   reckoning, the flash launches (all at 80 x 80), pam4 once a bucket of
   the replicated leaves, the traced step's busy share; then
   ServeEngine at those widths (8 requests, the paged kernel at hd 80);
   (c) zamba2_7b at its published widths cut to 7 layers (6 mamba2
   layers, one use of the shared block), every leaf synced, seq 4096, 8
   steps: finite falling losses, step p50/p99 over steps 1-6, tokens/s,
   peak memory beside the reckoning, buckets a step, the flash launches
   at 112 x 112, the last step profiled for its busy share and the SSD
   scan's share of it; (b) and (c) draw their seeded weights on the
   card (``device_params``, the init_params recipe); (d) the qwen3,
   chameleon and zamba2 SMOKE steps in f32 card vs CPU (chameleon's
   SMOKE shapes are qwen3's: only the name differs), the synced
   gradients bit for bit, and qwen3's SMOKE serving card vs CPU
   (teacher-forced logits and greedy tokens, as phase 5).
   4o. The xLSTM family (``xlstm_phase``; alone ``xlstm_alone``): (a)
   xlstm_125m at its published widths and depth (12 layers: 3 x (3 mLSTM
   + 1 sLSTM), d 768, vocab 50304), bf16, 4 stacked peers x 8 rows, t
   512, ``--sync optinc --bits 8 --mesh 4x1 --lr 3e-4``, weights drawn
   on the card, 7 steps, the last profiled (the device alone): finite
   falling losses, every gradient of a peer finite at t 512 after the
   run, step p50/p99, tokens/s, peak memory beside the reckoning, pam4
   once a bucket, the busy share; the sLSTM loop alone as training runs
   it (CUDA graphs) and dispatched op by op, gradients bit for bit, and
   its share of the wall; the mLSTM chunk scan alone and its share of
   the device time; (b) ServeSession at those widths, 8 prompts of 128
   tokens x 32 new: prefill ms, decode step p50/p99, tokens/s, equal to
   ``generate``; (c) the SMOKE step in f32 card vs CPU (synced
   gradients bit for bit) and ServeSession card vs CPU (teacher-forced
   logits, greedy tokens, as phase 5).  The phase prints each part's
   seconds.
   4p. ServeSession on the MoE family and the Mamba-2 hybrid
   (``serve_families_phase``; alone ``serve_families_alone``): the paged
   kernel one page a row at their heads, phi35_moe_42b, deepseek_v3_671b
   and zamba2_7b at their published widths (depth cut) over JAX's
   contiguous caches, and their SMOKE configs card vs CPU.
   4q. ServeSession on the enc-dec family and lm_loss's sequence chunks
   (``whisper_serve_phase``; alone ``whisper_serve_alone``): (a) the
   paged kernel one page a row at whisper's heads (b 8, 6/6, hd 64, S
   1500): the self rows (lengths 129-160) and the cross rows (every
   column), and a ragged f32 case, against the plain version, with its
   plan; the bf16 cases timed beside the plain version, SDPA over the
   same columns, the bound and the same K/V in a pool of 16-position
   pages, and the flash forward at the prefill's cross shape; (b)
   whisper_tiny at its published widths and depth, bf16, weights drawn
   on the card, 8 prompts of 128 tokens x 32 new with seeded frames,
   max_seq 1500 (the frame count): prefill ms, decode p50/p99, tokens/s,
   peak memory beside the reckoning, a profiled window, flash 12 a
   prefill (8 non-causal, 4 causal) and paged 8 a decode step, exactly,
   and the tokens of ``generate``; (c) the SMOKE config in f32 card vs
   CPU (teacher-forced logits, greedy tokens, as phase 5); (d)
   ``lm_loss`` at qwen3_32b's vocabulary, b 1, t 4096, d 5120, bf16:
   the chunked loss and gradients against the one-chunk form, each
   form's peak memory and time, and the time of the chunked form with
   its chunks summed by the host-read ``kernels.ref.fma_f32`` (the
   recompute's cost and the host stalls' apart).
5. Card vs plain end to end: the f32 model with the same weights served
   through the kernels on the card and through the plain path on the
   CPU; teacher-forced logits must agree, greedy tokens must agree up to
   the first position the plain run's top-2 margin is too thin to decide.
   Then a narrow f32 training step on the card and on the CPU: losses
   and pre-sync gradients within tolerance, and the card's gradient
   stack synced on the CPU through the plain versions must give the
   card's synced gradients and residuals bit for bit, at fidelity
   behavioral and at fidelities onn and mesh with bits 2; at bits 8 the
   ONN's analog outputs must agree within tolerance and the averaged
   codes bit for bit away from the PAM4 decision thresholds (fidelity
   onn over the whole stack, fidelity mesh over MESH_ELEMS elements
   through the Table I row 1 ONN, whose mesh outputs must also match
   the dense ONN of the same projected weights).  Then a 4-peer narrow
   gradient stack of the card synced on the card and on the CPU, two
   steps with error feedback, bit for bit: the ring at 4 peers, at 3 and
   over 2 pods of 2, the behavioral cascade over 2 pods, the photonic
   cascade at bits 2, Table-II injection on one fixed draw, and the
   card's streaming ``BucketStream`` against the CPU's barrier path.

Every phase raises on failure, so the script exits non-zero without the
last line; each phase's seconds are printed on a line of their own.  The line before the last is a JSON object of per-kernel
numbers; the last line is ``{"ok": true, "device": {...}}``.  The script
imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import io
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
# Flash backward, kernel vs plain, max abs difference over the largest
# |gradient|: f32 sums reordered over a 512-long row (~1e-6 relative);
# bf16 outputs each round their f32 result, 2^-8 relative at worst.
BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# Card vs CPU training step, f32 (cuBLAS without TF32 vs CPU BLAS): the
# loss (O(6)) and each gradient leaf relative to its largest entry.
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-4
TRAIN_ARGV = ["--arch", "paper_llama", "--sync", "optinc", "--bits", "8",
              "--block", "2048", "--mesh", "4x1", "--global-batch", "32",
              "--seq-len", "512", "--device", "cuda"]
# Teacher-forced f32 logits, card (kernels, cuBLAS f32 without TF32) vs
# CPU (plain): sums reordered through 8 layers; logits are O(1).
LOGIT_TOL = 1e-3
# onn_layer, kernel vs plain (cuBLAS f32 without TF32), and the whole ONN
# card vs CPU: max abs difference over the largest |output|; f32 sums of
# up to 256 products in another order, a few ulp
ONN_TOL = 1e-5
# PAM4 decisions card vs CPU are compared where the plain version's
# analog ONN output is farther than this from a threshold k + 0.5
ONN_MARGIN = 1e-4
ONN8_STRUCTURE = (4, 64, 128, 256, 128, 64, 4)
# Table I row 1 of the paper: layers 1-6 of ONN8_STRUCTURE approximated
# (Sigma_a U_a), area ratio 0.393
APPROX_LAYERS = (1, 2, 3, 4, 5, 6)
BUCKET_ROWS = 1 << 20                 # f32 elements of one 4 MiB bucket
# mesh_scan with the theta drift, kernel vs plain: max abs difference over
# the largest |output|; the drift's logf/cosf/sinf differ by a few ulp
# between CUDA's libm and the CPU's, through up to 509 layers
MESH_THETA_TOL = 1e-5
# the mesh ONN against the dense ONN of the same projected weights: the
# Givens programs reproduce W to ~1e-15 in f64, and f32 rounding through
# up to 509 rotation layers adds a few hundred ulp
MESH_DENSE_TOL = 1e-4
# elements of the bits-8 mesh sync compared card vs CPU: four blocks of
# 2048 (the CPU's plain mesh took ~95 s for the 32768 of PRs 16-30)
MESH_ELEMS = 8192


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
    kv_bytes = sum(lengths) * hkv * hd * 2 * item   # the tokens held
    io_bytes = 2 * b * h * hd * item + 4 * b * (1 + -(-max(lengths) // ps))
    flops = 4 * sum(lengths) * h * hd
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def flash_case(b, h, hkv, hd, sq, skv, dtype, seed, hdv=None):
    """q/k/v as the model passes them: (b, t, heads, hd) transposed to
    (b, heads, t, hd) views (strided, last dim contiguous); v is hdv wide
    (MLA), hd by default."""
    import torch
    hdv = hd if hdv is None else hdv
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, sq, h, hd), generator=g).to(dtype).cuda()
    k = torch.randn((b, skv, hkv, hd), generator=g).to(dtype).cuda()
    v = torch.randn((b, skv, hkv, hdv), generator=g).to(dtype).cuda()
    return [t.transpose(1, 2) for t in (q, k, v)]


def visible_pairs(sq: int, skv: int, causal: bool = True) -> int:
    """The (row, column) pairs a query row sees: causal, columns <= r +
    (skv - sq); not causal, every column."""
    if not causal:
        return sq * skv
    return sum(min(skv, r + (skv - sq) + 1) for r in range(sq))


def flash_bounds(b, h, hkv, hd, sq, skv, dtype, lse=False, hdv=None,
                 causal=True):
    """(ms, what bounds it) of the forward: QK^T 2 hd and PV 2 hdv
    flops a visible (row, column) pair; q, k, v read and o (and the lse)
    written once."""
    import torch
    hdv = hd if hdv is None else hdv
    item = torch.tensor([], dtype=dtype).element_size()
    pairs = visible_pairs(sq, skv, causal)
    flops = 2 * b * h * pairs * (hd + hdv)
    nbytes = ((b * h * sq * (hd + hdv) + b * hkv * skv * (hd + hdv)) * item
              + (4 * b * h * sq if lse else 0))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def flash_bwd_bounds(b, h, hkv, hd, sq, skv, dtype, hdv=None, causal=True):
    import torch
    hdv = hd if hdv is None else hdv
    item = torch.tensor([], dtype=dtype).element_size()
    pairs = visible_pairs(sq, skv, causal)
    # S, dK, dQ: 2 hd flops a pair each; dP, dV: 2 hdv each
    flops = 2 * b * h * pairs * (3 * hd + 2 * hdv)
    nbytes = ((2 * b * h * sq * (hd + hdv) + 2 * b * hkv * skv * (hd + hdv))
              * item + 4 * b * h * sq)   # q, dq, o, dO; k, dk, v, dv; lse
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def gather_sdpa(q, kp, vp, tb, ln):
    """The paged kernel's yardstick: the same work through PyTorch calls,
    each slot's pages gathered contiguous and SDPA (GQA where the pool
    has fewer heads) under a boolean length mask, all inside the call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    kg, vg = ref.paged_gather(kp, tb), ref.paged_gather(vp, tb)
    mask = (torch.arange(kg.shape[2], device=q.device)[None, :]
            < ln[:, None].long())[:, None, None, :]
    return F.scaled_dot_product_attention(q, kg, vg, attn_mask=mask,
                                          enable_gqa=q.shape[1] != kg.shape[1])


def paged_build_report(card: str) -> None:
    """Registers, spills and shared memory of every kernel of the paged
    source (nvcc -Xptxas -v)."""
    from repro_torch.kernels import _build

    path = _build.build(["paged_attention"])["paged_attention"]
    for short, _, st in ptxas_stats(path):
        spill = st["spill"]
        print(f"  paged_attention: {short}: {st.get('regs')} registers, "
              f"{spill[0]} bytes spill stores, {spill[1]} bytes spill loads, "
              f"{st.get('smem', 0)} bytes static smem", flush=True)
    print(f"paged build report done [{card}]", flush=True)


def check_kernels(card: str) -> dict:
    """The paged decode kernel vs plain on the card; returns its record
    at the main-path shape (paper_llama, bf16) with its timings.  A slot
    of length 0 is a pad row: the kernel writes zeros there (the plain
    version the mean of its pages), so such rows are held to 0 and the
    others to the plain version."""
    import torch
    from repro_torch.kernels import paged_attention, ref

    paged_build_report(card)
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
        # one slot over every split of the table
        ("one slot", 1, 8, 8, 48, 16, [256], torch.bfloat16),
        ("empty slots", 8, 8, 8, 48, 16, [0, 5, 0, 200, 17, 0, 64, 1],
         torch.bfloat16),
        ("all length 1", 8, 8, 8, 48, 16, [1] * 8, torch.bfloat16),
        # minitron_4b's heads: rep 3 at hd 128
        ("rep3", 4, 6, 2, 128, 16, [1, 17, 100, 256], torch.bfloat16),
        # the mixed dtype pairs: f32 queries over bf16 pages and back
        ("rep3 f32 q", 4, 6, 2, 128, 16, [0, 16, 33, 250], torch.float32),
        ("gqa bf16 q", 8, 8, 2, 48, 16, spread, torch.bfloat16),
    ]
    mixed = {"rep3 f32 q": torch.bfloat16, "gqa bf16 q": torch.float32}
    for label, b, h, hkv, hd, ps, lengths, dt in paged_cases:
        args = paged_case(b, h, hkv, hd, ps, lengths, dt, SEED)
        if label in mixed:                     # the pool in the other dtype
            args[1], args[2] = (t.to(mixed[label]) for t in args[1:3])
        got = paged_attention.paged_attention(*args).float()
        want = ref.paged_attention_ref(*args).float()
        torch.cuda.synchronize()
        live = args[4] > 0
        err = (got[live] - want[live]).abs().max().item()
        pad = got[~live].abs().max().item() if (~live).any() else 0.0
        tol = KERNEL_TOL[str(dt).split(".")[-1]]   # the output's dtype
        p = paged_attention.plan(
            b, h, hkv, ps, hd, args[3].shape[1], args[1].element_size(),
            16, torch.cuda.get_device_properties(0).multi_processor_count)
        print(f"paged_attention {label}: b={b} h={h} hkv={hkv} hd={hd} "
              f"page={ps} lengths={lengths} {dt}: max_abs_err {err:.3e} "
              f"(tol {tol:.0e}), length-0 rows max |out| {pad:.1e}; split "
              f"{p.split} x {p.n_splits}, {p.vec_bytes}-byte loads, "
              f"{p.rows} rows a block", flush=True)
        if not (err <= tol and pad == 0.0):
            raise AssertionError(f"paged_attention {label} disagrees with "
                                 f"its plain version: {err} > {tol} or a "
                                 f"length-0 row is not 0 ({pad})")
        if label != "main":
            continue
        again = paged_attention.paged_attention(*args).float()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError("paged_attention main: two runs differ")
        print("paged_attention main: two runs bit-identical", flush=True)
        ins = copies_for(args)
        ms, host_ms = time_ms(paged_attention.paged_attention, ins)
        plain_ms, _ = time_ms(ref.paged_attention_ref, ins, iters=20)
        lib_ms, _ = time_ms(gather_sdpa, ins)
        # the floor a launch sets, which a sub-microsecond bound cannot
        # show: an empty kernel through the same harness
        empty_ms, _ = time_ms(lambda *a: torch.cuda._sleep(0), ins)
        bound, by = paged_bounds(b, h, hkv, hd, ps, lengths, dt)
        splits = {}
        for split in (16, 32, 64, 128, 256):
            splits[split], _ = time_ms(
                lambda *a, s=split: paged_attention.paged_attention_with(
                    *a, split=s), ins)
        print(f"paged_attention main timing: kernel {ms * 1e3:.2f} us "
              f"(wrapper call on the host {host_ms * 1e3:.2f} us), "
              f"plain {plain_ms * 1e3:.2f} us, gather + sdpa "
              f"{lib_ms * 1e3:.2f} us, empty kernel launch "
              f"{empty_ms * 1e3:.2f} us, bound {bound * 1e3:.3f} us ({by}); "
              f"by split: " + ", ".join(f"{s} {t * 1e3:.2f} us"
                                        for s, t in splits.items())
              + f" [{card}]", flush=True)
        records["paged_attention"] = dict(
            name="paged_attention", route="cuda",
            source="src/repro_torch/csrc/paged_attention.cu",
            replaces="src/repro/kernels/paged_attention.py:108",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=by, library_ms=lib_ms)
    return records


def _tool(name: str):
    """A CUDA toolkit program on PATH or in /usr/local/cuda/bin, or None."""
    import shutil
    found = Path("/usr/local/cuda/bin") / name
    return shutil.which(name) or (str(found) if found.exists() else None)


def ptxas_stats(path) -> list:
    """[(short name, mangled name, {"regs", "spill", "smem"})] of every
    kernel in a library built by ``_build`` (its ``-Xptxas -v`` log),
    demangled where cu++filt exists."""
    import re
    stats, fn = {}, None
    for line in Path(str(path) + ".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            stats[fn] = {"spill": [0, 0]}
        elif fn and "spill" in line:
            stats[fn]["spill"] = [int(x) for x in re.findall(
                r"(\d+) bytes spill", line)]
        elif fn and "Used" in line:
            stats[fn]["regs"] = int(re.search(r"Used (\d+) registers",
                                              line).group(1))
            m = re.search(r"(\d+) bytes smem", line)
            stats[fn]["smem"] = int(m.group(1)) if m else 0
    names = list(stats)
    filt = _tool("cu++filt") or _tool("c++filt")
    if filt and names:
        out = subprocess.run([filt], input="\n".join(names),
                             capture_output=True, text=True,
                             timeout=60).stdout.splitlines()
        if len(out) == len(names):
            names = [short_kernel(n) for n in out]
    return [(short, fn, st) for short, (fn, st) in zip(names, stats.items())]


def sass_counts(path, ops) -> dict:
    """{mangled kernel name: {op: instructions}} for the SASS opcodes
    ``ops`` (matched as prefixes) in a built library, or {} without
    cuobjdump."""
    import re
    objdump = _tool("cuobjdump")
    if not objdump:
        return {}
    sass = subprocess.run([objdump, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = dict.fromkeys(ops, 0)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                      line)
        if fn and m:
            for op in ops:
                if m.group(1).startswith(op):
                    counts[fn][op] += 1
    return counts


def flash_build_report(card: str) -> None:
    """Registers, spills and shared memory of every kernel of the two
    flash sources (nvcc -Xptxas -v), and the HMMA instructions of each
    where cuobjdump exists.  Raises if a head-dim-48 tensor-core kernel
    spills."""
    import re
    from repro_torch.kernels import _build

    paths = _build.build(["flash_attention", "flash_attention_bwd"])
    for name, path in sorted(paths.items()):
        hmma = sass_counts(path, ("HMMA",))
        for short, fn, st in ptxas_stats(path):
            spill = st["spill"]
            count = (hmma[fn]["HMMA"] if fn in hmma
                     else "not counted (no cuobjdump)")
            print(f"  {name}: {short}: {st.get('regs')} registers, "
                  f"{spill[0]} bytes spill stores, {spill[1]} bytes spill "
                  f"loads, {st.get('smem', 0)} bytes static smem; HMMA "
                  f"{count}", flush=True)
            if ("_mma_" in short and re.search(r"<48(, 48)?>", short)
                    and any(spill)):
                raise AssertionError(f"{short} spills registers: {spill}")
    print(f"flash build report done [{card}]", flush=True)


def kernel_split(fn, inputs, calls: int = 20) -> dict:
    """Device us a call of each kernel that fn(*inputs[i]) launches, from
    torch.profiler over ``calls`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(*inputs[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(*inputs[i % len(inputs)])
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if e.device_type == DeviceType.CUDA and us > 0:
            out[kernel_name(e.key)] = us / calls
    return out


def check_flash_kernels(card: str) -> dict:
    """The flash forward (with and without the log-sum-exp) and backward
    kernels vs their plain versions on the card, at the main paths'
    shapes, GQA, the shifted mask, ragged tiles and every head dim, in
    bf16 (the tensor-core kernels) and f32 (the CUDA-core kernels); the
    backward twice for bit-equal gradients; timings beside SDPA and the
    bound at the serve (t 128, 256) and training (t 512) shapes.  Returns
    the records of the main shapes.  Alone, for iterating on the
    kernels: ``python3 -c 'import chip_smoke as c;
    c.check_flash_kernels(c.card_line())'``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import attention, ref

    flash_build_report(card)
    records = {}
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
        # bf16 twins of the f32-only cases, for the tensor-core kernel
        ("ragged_shift_bf16", 8, 8, 8, 48, 37, 203, torch.bfloat16),
        ("hd16_bf16", 2, 4, 2, 16, 70, 70, torch.bfloat16),
        ("hd32_bf16", 2, 4, 4, 32, 50, 50, torch.bfloat16),
        # the training shape (one peer's batch of the training step)
        ("t512", 8, 8, 8, 48, 512, 512, torch.bfloat16),
        # MLA: a V head dim of its own, (192, 128) at deepseek-v3's
        # published widths and (24, 16) at its SMOKE config
        ("mla", 2, 8, 8, 192, 130, 130, torch.bfloat16, 128),
        ("mla_f32", 2, 8, 8, 192, 130, 130, torch.float32, 128),
        ("mla_shift", 1, 4, 4, 192, 37, 203, torch.bfloat16, 128),
        ("mla_smoke", 2, 4, 4, 24, 100, 100, torch.bfloat16, 16),
        ("mla_smoke_f32", 2, 4, 4, 24, 100, 100, torch.float32, 16),
    ]
    for label, b, h, hkv, hd, sq, skv, dt, *hdv in flash_cases:
        args = flash_case(b, h, hkv, hd, sq, skv, dt, SEED, *hdv)
        got = attention.flash_attention(*args).float()
        want = ref.attention_ref(*args).float()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = KERNEL_TOL[str(dt).split(".")[-1]]
        print(f"flash_attention {label}: b={b} h={h} hkv={hkv} hd={hd} "
              f"{f'hdv={hdv[0]} ' if hdv else ''}"
              f"sq={sq} skv={skv} {dt}: max_abs_err {err:.3e} "
              f"(tol {tol:.0e})", flush=True)
        if not err <= tol:
            raise AssertionError(f"flash_attention {label} disagrees with "
                                 f"its plain version: {err} > {tol}")
        if label not in ("main", "t256", "t512"):
            continue
        # the training step calls the forward with the log-sum-exp
        lse = label == "t512"
        ins = copies_for(args)
        ms, host_ms = time_ms(lambda q, k, v: attention.flash_attention(
            q, k, v, return_lse=lse), ins)
        plain_ms, _ = time_ms(ref.attention_fwd_ref if lse
                              else ref.attention_ref, ins, iters=20)
        lib_ms, _ = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), ins)
        bound, by = flash_bounds(b, h, hkv, hd, sq, skv, dt, lse)
        print(f"flash_attention {label} timing{' (with lse)' if lse else ''}"
              f": kernel {ms * 1e3:.2f} us "
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

    bwd_cases = [
        # (label, b, h, hkv, hd, sq, skv, dtype)
        ("main", 8, 8, 8, 48, 512, 512, torch.bfloat16),
        ("f32", 8, 8, 8, 48, 512, 512, torch.float32),
        ("gqa_hd16", 4, 8, 2, 16, 300, 300, torch.float32),
        ("gqa_shift", 2, 4, 2, 64, 100, 173, torch.bfloat16),
        ("hd32", 2, 4, 4, 32, 70, 70, torch.float32),
        ("hd128", 2, 4, 2, 128, 129, 129, torch.bfloat16),
        # bf16 twins of the f32-only cases, for the tensor-core kernels
        ("gqa_hd16_bf16", 4, 8, 2, 16, 300, 300, torch.bfloat16),
        ("hd32_bf16", 2, 4, 4, 32, 70, 70, torch.bfloat16),
        # MLA's (QK, V) head dims, as the forward's
        ("mla", 2, 4, 4, 192, 129, 129, torch.bfloat16, 128),
        ("mla_f32", 2, 4, 4, 192, 129, 129, torch.float32, 128),
        ("mla_shift", 1, 4, 4, 192, 60, 150, torch.bfloat16, 128),
        ("mla_smoke", 2, 4, 4, 24, 100, 100, torch.bfloat16, 16),
        ("mla_smoke_f32", 2, 4, 4, 24, 100, 100, torch.float32, 16),
    ]
    for label, b, h, hkv, hd, sq, skv, dt, *hdv in bwd_cases:
        q, k, v = flash_case(b, h, hkv, hd, sq, skv, dt, SEED, *hdv)
        g = torch.Generator().manual_seed(SEED + 1)
        do = torch.randn((b, h, sq, v.shape[-1]), generator=g).to(dt).cuda()
        o, lse = attention.flash_attention(q, k, v, return_lse=True)
        o_ref, lse_ref = ref.attention_fwd_ref(q, k, v)
        torch.cuda.synchronize()
        f_err = (o.float() - o_ref.float()).abs().max().item()
        l_err = (lse - lse_ref).abs().max().item()
        tol = KERNEL_TOL[str(dt).split(".")[-1]]
        if not (f_err <= tol and l_err <= KERNEL_TOL["float32"]):
            raise AssertionError(f"flash forward with lse {label}: out "
                                 f"{f_err}, lse {l_err}")
        got = attention.flash_attention_bwd(q, k, v, o, lse, do)
        want = ref.attention_bwd_ref(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        rel = max(((a.float() - w.float()).abs().max()
                   / w.float().abs().max()).item() for a, w in zip(got, want))
        btol = BWD_TOL[str(dt).split(".")[-1]]
        print(f"flash_attention_bwd {label}: b={b} h={h} hkv={hkv} hd={hd} "
              f"{f'hdv={hdv[0]} ' if hdv else ''}"
              f"sq={sq} skv={skv} {dt}: max_abs_err / max|grad| {rel:.3e} "
              f"(tol {btol:.0e}); forward with lse: out {f_err:.3e}, lse "
              f"{l_err:.3e}", flush=True)
        if not rel <= btol:
            raise AssertionError(f"flash_attention_bwd {label} disagrees "
                                 f"with its plain version: {rel} > {btol}")
        if label != "main":
            continue
        again = attention.flash_attention_bwd(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"flash_attention_bwd main run twice: dq, dk, dv bit-equal "
              f"{same}", flush=True)
        if not same:
            raise AssertionError("flash_attention_bwd is not deterministic")
        ins = copies_for([q, k, v, o, lse, do])
        ms, host_ms = time_ms(attention.flash_attention_bwd, ins)
        plain_ms, _ = time_ms(ref.attention_bwd_ref, ins, iters=10)
        lib_ms = sdpa_bwd_ms(ins)
        bound, by = flash_bwd_bounds(b, h, hkv, hd, sq, skv, dt)
        print(f"flash_attention_bwd main timing: kernel {ms * 1e3:.2f} us "
              f"(host {host_ms * 1e3:.2f} us), plain {plain_ms * 1e3:.2f} "
              f"us, sdpa backward {lib_ms * 1e3:.2f} us, bound "
              f"{bound * 1e3:.3f} us ({by}) [{card}]", flush=True)
        split = kernel_split(attention.flash_attention_bwd, ins)
        print("flash_attention_bwd main, device us a call by kernel "
              "(profiler): " + ", ".join(f"{n} {us:.2f}"
                                         for n, us in split.items())
              + f" [{card}]", flush=True)
        records["flash_attention_bwd"] = dict(
            name="flash_attention_bwd", route="cuda",
            source="src/repro_torch/csrc/flash_attention_bwd.cu",
            replaces="src/repro/kernels/attention.py:63",
            max_abs_err=max((a.float() - w.float()).abs().max().item()
                            for a, w in zip(got, want)),
            ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=lib_ms)

    # either side of the training shape: one sequence (a lone block on
    # most SMs, so each tile step's latency shows) and t 2048 (enough
    # tiles to fill the card: the products' rate shows)
    for b, t in ((1, 512), (8, 2048)):
        q, k, v = flash_case(b, 8, 8, 48, t, t, torch.bfloat16, SEED)
        g = torch.Generator().manual_seed(SEED + 1)
        do = torch.randn((b, 8, t, 48), generator=g).bfloat16().cuda()
        o, lse = attention.flash_attention(q, k, v, return_lse=True)
        ins = copies_for([q, k, v, o, lse, do])
        fwd = time_ms(lambda q, k, v, *_: attention.flash_attention(
            q, k, v, return_lse=True), ins)[0]
        sdpa = time_ms(lambda q, k, v, *_: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), ins)[0]
        bwd = time_ms(attention.flash_attention_bwd, ins)[0]
        sdpa_bwd = sdpa_bwd_ms(ins)
        shape = (b, 8, 8, 48, t, t, torch.bfloat16)
        f_bound, b_bound = flash_bounds(*shape, True), flash_bwd_bounds(*shape)
        print(f"flash at b={b} h=8 hd=48 t={t} bf16: forward with lse "
              f"{fwd * 1e3:.2f} us (sdpa {sdpa * 1e3:.2f}, bound "
              f"{f_bound[0] * 1e3:.3f} {f_bound[1]}), backward "
              f"{bwd * 1e3:.2f} us (sdpa backward {sdpa_bwd * 1e3:.2f}, "
              f"bound {b_bound[0] * 1e3:.3f} {b_bound[1]}) [{card}]",
              flush=True)
    return records


def sdpa_bwd_ms(ins, gqa: bool = False, causal: bool = True) -> float:
    """Device ms of the backward of PyTorch's SDPA alone on the (q, k, v,
    o, lse, do) copies ins (``gqa``: fewer KV heads than query heads):
    its forward graph built once, the backward replayed on it (the flash
    backward's yardstick)."""
    import torch
    import torch.nn.functional as F
    sd_ins = []
    for qq, kk, vv, _, _, dd in ins:
        qq, kk, vv = (t.detach().requires_grad_() for t in (qq, kk, vv))
        out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=causal,
                                             enable_gqa=gqa)
        sd_ins.append((out, qq, kk, vv, dd))
    return time_ms(lambda out, qq, kk, vv, dd: torch.autograd.grad(
        out, (qq, kk, vv), dd, retain_graph=True), sd_ins)[0]


# ------------------------------------------ phase 2b: training kernels
def pam4_case(peers, nb, block, tail, bits, seed):
    """A bucket of ``peers`` rows with exact ties (g / s * levels on a
    .5), all-zero blocks on every peer, and a ragged tail of ``tail``
    missing elements; its shared block scale; and the code sum with
    exact Q(mean) ties (total = n k + n / 2)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(seed)
    m = nb * block - tail
    x = torch.randn((peers, m), generator=g)
    x[:, :block] = 0.0
    x[:, 5 * block:6 * block] = 0.0
    levels = 2 ** (bits - 1) - 1
    s1 = x[:, block:2 * block].abs().max()
    k = torch.arange(1, 33, dtype=torch.float32)
    x[:, block:block + 32] = (k - 0.5) / levels * s1
    padded = F.pad(x, (0, nb * block - m)).reshape(peers, nb, block)
    scale = padded.abs().amax(-1).clamp_min(
        torch.finfo(torch.float32).tiny).amax(0)
    u = ref.pam4_quantize_encode_ref(x, scale, bits, block)
    total = u.sum(0, dtype=torch.int32).reshape(1, -1)
    total[0, 2 * block:2 * block + 64] = (
        peers * torch.arange(64, dtype=torch.int32) + peers // 2)
    return x.cuda(), scale.cuda(), total.cuda(), u.cuda(), m


def pam4_bound(nbytes):
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def pam4_sums_case(rows, n, nb, block, tail, bits, seed):
    """``rows`` sums of ``n`` peers' codes in ``nb`` blocks of ``block``
    (the last ``tail`` columns pad), with exact Q(mean) ties (total = n k
    + n / 2, ties at even n) and two zero blocks (scale at the f32-tiny
    floor); its scale and m."""
    import torch
    g = torch.Generator().manual_seed(seed)
    levels = 2 ** (bits - 1) - 1
    total = torch.randint(0, 2 * levels + 1, (rows, n, nb * block),
                          generator=g, dtype=torch.int32).sum(
                              1, dtype=torch.int32)
    k = torch.arange(64, dtype=torch.int32) % (2 * levels)
    total[:, block:block + 64] = n * k + n // 2
    scale = torch.rand(nb, generator=g) * 4 + 0.01
    scale[[0, nb // 2]] = torch.finfo(torch.float32).tiny
    return total.cuda(), scale.cuda(), nb * block - tail


def view_copy(x, how: str):
    """x (rows, m) copied into a view on the card: ``contiguous``;
    ``offset``, one float past 16 bytes; ``ld``, a row stride 2 mod 4."""
    import torch
    rows, m = x.shape
    if how == "offset":
        return torch.empty(rows * m + 1, device="cuda")[1:].view(
            rows, m).copy_(x)
    if how == "ld":
        ld = m + ((2 - m) % 4 or 4)
        return torch.empty((rows, ld), device="cuda")[:, :m].copy_(x)
    return x.clone()


# decode cases without a base, each at n = 1, 2, 3 and 4: (label, rows,
# blocks, block, pad columns, the form decode_form must pick)
PAM4_DECODE_CASES = (("bucket", 1, 512, 2048, 0, "aligned"),
                     ("ragged", 1, 37, 2048, 1001, "aligned"),
                     ("rows4 ragged", 4, 37, 2048, 1001, "scalar"),
                     ("rows4 block1000", 4, 60, 1000, 8, "aligned"),
                     ("rows4 block999", 4, 60, 999, 0, "scalar"))
# with a base (error feedback: n = 1, the base the rows' own gradients,
# which the plain version's exact f64 difference needs): (label, rows,
# blocks, block, pad columns, base view, form)
PAM4_DECODE_BASE_CASES = (
    ("ef", 4, 40, 2048, 1000, "contiguous", "aligned"),
    ("ef offset", 4, 40, 2048, 1000, "offset", "scalar"),
    ("ef ld", 4, 40, 2048, 1000, "ld", "scalar"),
    ("ef one row offset", 1, 37, 2048, 1001, "offset", "scalar"),
    ("ef one row ragged", 1, 37, 2048, 1001, "contiguous", "aligned"),
    ("ef rows4 ragged", 4, 37, 2048, 1001, "contiguous", "scalar"),
    ("ef block1000 ld", 4, 60, 1000, 8, "ld", "scalar"),
    ("ef block999 offset", 4, 60, 999, 0, "offset", "scalar"))


def decode_and_form(*args):
    """pam4_decode_dequantize(*args) on the card and the form it took."""
    from repro_torch.kernels import pam4
    before = dict(pam4.pam4_decode_dequantize.forms)
    out = pam4.pam4_decode_dequantize(*args)
    after = pam4.pam4_decode_dequantize.forms
    return out, next(f for f in after if after[f] != before[f])


def check_pam4_decode(bits: int) -> None:
    """Every decode form bit for bit against the plain version at
    ``bits``; each case prints its form."""
    import torch
    from repro_torch.kernels import ref

    def check(total, scale, n, m, base):
        out, form = decode_and_form(total, scale, bits, n, m, base)
        plain = ref.pam4_decode_dequantize_ref(total, scale, bits, n, m, base)
        torch.cuda.synchronize()
        return form, torch.equal(out, plain)

    for label, rows, nb, block, tail, want in PAM4_DECODE_CASES:
        results = []
        for n in (1, 2, 3, 4):
            total, scale, m = pam4_sums_case(rows, n, nb, block, tail, bits,
                                             SEED + 10 * bits + n)
            results.append(check(total, scale, n, m, None))
        forms = {f for f, _ in results}
        print(f"pam4 decode {label} bits={bits} n=1,2,3,4: {rows} x {m} "
              f"sums in blocks of {block}, no base: {sorted(forms)} form, "
              f"bit-equal {[same for _, same in results]}", flush=True)
        if forms != {want} or not all(same for _, same in results):
            raise AssertionError(f"pam4 decode {label} bits={bits}: forms "
                                 f"{forms} (want {want}), {results}")
    for label, rows, nb, block, tail, how, want in PAM4_DECODE_BASE_CASES:
        x, scale, _, u, m = pam4_case(rows, nb, block, tail, bits,
                                      SEED + bits)
        base = view_copy(x, how)
        form, same = check(u.reshape(rows, -1), scale, 1, m, base)
        print(f"pam4 decode {label} bits={bits} n=1: {rows} x {m} in blocks "
              f"of {block}, base row stride {base.stride(0)}, pointer mod 16 "
              f"{base.data_ptr() % 16}: {form} form, bit-equal {same}",
              flush=True)
        if form != want or not same:
            raise AssertionError(f"pam4 decode {label} bits={bits}: {form} "
                                 f"form (want {want}), bit-equal {same}")


def pam4_decode_timing_inputs():
    """The decode's two shapes on the main path at bits 8, as rotated
    inputs: (scale, m, [(sums of 4, None)] for the Q(mean) decode of one
    bucket, [(codes, base)] for the error-feedback decode of 4 peers,
    each base a bucket view of a full paper_llama peer stack)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.tree import leaves
    x, scale, total, u, m = pam4_case(4, 512, 2048, 0, 8, SEED + 8)
    n_params = sum(math.prod(s) for s in leaves(lm.param_shapes(
        configs.get("paper_llama"))))
    stack = torch.empty((4, n_params), device="cuda")
    ef = []
    for k in range(6):                   # 6 x 32 MiB: past the 50 MB L2
        base = stack[:, k * m:(k + 1) * m]
        base.copy_(x)
        ef.append((u.reshape(4, -1).clone(), base))
    return scale, m, [(t, None) for t, in copies_for([total])], ef


def pam4_copy_ms(nbytes: int) -> float:
    """Device ms of a ``copy_`` of nbytes / 2 into nbytes / 2 (the bytes
    a decode moves), sources rotated past the L2."""
    import torch
    src = torch.empty(nbytes // 8, device="cuda")
    dst = torch.empty_like(src)
    return time_ms(lambda a: dst.copy_(a), copies_for([src]))[0]


def check_training_kernels(card: str) -> dict:
    """pam4 encode/decode vs their plain versions on the card; records of
    the training path's shapes with timings."""
    import torch
    from repro_torch.kernels import _build, pam4, ref

    records = {}
    for short, _, st in ptxas_stats(_build.build(["pam4"])["pam4"]):
        print(f"pam4 {short}: {st.get('regs')} registers, spills "
              f"{st['spill']} bytes (stores, loads)", flush=True)
    # encode of views the vector forms must read around: off the 16-byte
    # alignment, a row stride not a multiple of 4, a block of 1000 (vector)
    # and of 999 (scalar); each bit for bit against the plain version
    for bits in (2, 4, 8):
        for label, nb, block, tail in (("offset", 40, 2048, 1001),
                                       ("ld", 40, 2048, 3),
                                       ("block1000", 60, 1000, 7),
                                       ("block999", 60, 999, 0)):
            x, scale, _, u_ref, m = pam4_case(4, nb, block, tail, bits,
                                              SEED + bits)
            if label in ("offset", "ld"):
                x = view_copy(x, label)
            form = pam4.encode_form(4, x.stride(0), block, x.data_ptr())
            u = pam4.pam4_quantize_encode(x, scale, bits, block)
            torch.cuda.synchronize()
            same = torch.equal(u, u_ref)
            print(f"pam4 encode {label} bits={bits}: 4 x {m} elements, "
                  f"row stride {x.stride(0)}, pointer mod 16 "
                  f"{x.data_ptr() % 16}, block {block}: {form} form, "
                  f"bit-equal {same}", flush=True)
            if not same:
                raise AssertionError(f"pam4 encode {label} bits={bits} "
                                     f"differs from its plain version")
        check_pam4_decode(bits)
    # a full 4 MiB bucket of 4 peers, and a ragged one
    for bits in (2, 4, 8):
        for label, nb, tail in (("bucket", 512, 0), ("ragged", 37, 1000)):
            x, scale, total, u_ref, m = pam4_case(4, nb, 2048, tail, bits,
                                                  SEED + bits)
            u = pam4.pam4_quantize_encode(x, scale, bits, 2048)
            out = pam4.pam4_decode_dequantize(total, scale, bits, 4, m)
            out_ref = ref.pam4_decode_dequantize_ref(total, scale, bits, 4,
                                                     m)
            err = pam4.pam4_decode_dequantize(u.reshape(4, -1), scale, bits,
                                              1, m, base=x)
            err_ref = ref.pam4_decode_dequantize_ref(
                u_ref.reshape(4, -1), scale, bits, 1, m, base=x)
            torch.cuda.synchronize()
            same = (torch.equal(u, u_ref), torch.equal(out, out_ref),
                    torch.equal(err, err_ref))
            print(f"pam4 {label} bits={bits}: 4 peers x {m} elements in "
                  f"blocks of 2048: encode bit-equal {same[0]}, decode "
                  f"(Q(mean), n=4) bit-equal {same[1]}, decode n=1 with "
                  f"base (error feedback) bit-equal {same[2]}", flush=True)
            if not all(same):
                raise AssertionError(f"pam4 {label} bits={bits} differs "
                                     f"from its plain version")
            if label != "bucket" or bits != 8:
                continue
            ins = copies_for([x, scale])
            ms, host_ms = time_ms(lambda a, s: pam4.pam4_quantize_encode(
                a, s, 8, 2048), ins)
            plain_ms, _ = time_ms(lambda a, s: ref.pam4_quantize_encode_ref(
                a, s, 8, 2048), ins, iters=20)
            bound, by = pam4_bound(4 * x.numel() + 4 * u.numel()
                                   + 4 * scale.numel())
            # the reachable bandwidth: a device copy of the same bytes
            # (not the same function, so not a library time)
            dst = torch.empty_like(x)
            copy_ms, _ = time_ms(lambda a, s: dst.copy_(a), ins)
            print(f"pam4_quantize_encode timing (4 x 512 x 2048, bits 8, "
                  f"{pam4.encode_form(4, x.stride(0), 2048, x.data_ptr())} "
                  f"form): kernel {ms * 1e3:.2f} us (host "
                  f"{host_ms * 1e3:.2f} us), plain {plain_ms * 1e3:.2f} us, "
                  f"copy_ of the same bytes {copy_ms * 1e3:.2f} us, bound "
                  f"{bound * 1e3:.3f} us ({by}), {100 * bound / ms:.1f}% of "
                  f"it [{card}]", flush=True)
            records["pam4_quantize_encode"] = dict(
                name="pam4_quantize_encode", route="cuda",
                source="src/repro_torch/csrc/pam4.cu",
                replaces="src/repro/kernels/pam4.py:40", max_abs_err=0.0,
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=None)
    records["pam4_decode_dequantize"] = time_pam4_decode(card)
    return records


def time_pam4_decode(card: str) -> dict:
    """The decode at its two main-path shapes (bits 8), each beside a
    device ``copy_`` of the same bytes, the reachable rate (not the same
    function, so not a library time); returns the main case's record."""
    import torch
    from repro_torch.kernels import pam4, ref
    scale, m, main_ins, ef_ins = pam4_decode_timing_inputs()
    width = main_ins[0][0].shape[1]
    cases = (("Q(mean): 1 x 512 x 2048 sums of 4", main_ins, 4,
              4 * width + 4 * m),
             (f"error feedback: 4 x 512 x 2048 codes, n 1, base a bucket "
              f"view of row stride {ef_ins[0][1].stride(0)}", ef_ins, 1,
              4 * 4 * width + 2 * 4 * 4 * m))
    record = None
    for label, ins, n, nbytes in cases:
        def decode(t, b, n=n):
            return pam4.pam4_decode_dequantize(t, scale, 8, n, m, b)

        def plain(t, b, n=n):
            return ref.pam4_decode_dequantize_ref(t, scale, 8, n, m, b)

        t, b = ins[0]
        out, form = decode_and_form(t, scale, 8, n, m, b)
        same = torch.equal(out, plain(t, b))
        ms, host_ms = time_ms(decode, ins)
        plain_ms, _ = time_ms(plain, ins, iters=20)
        copy_ms = pam4_copy_ms(nbytes)
        bound, by = pam4_bound(nbytes + 4 * scale.numel())
        print(f"pam4_decode_dequantize timing ({label}, bits 8, {form} "
              f"form, bit-equal {same}): kernel {ms * 1e3:.2f} us (host "
              f"{host_ms * 1e3:.2f} us), plain {plain_ms * 1e3:.2f} us, "
              f"copy_ of the same bytes {copy_ms * 1e3:.2f} us, bound "
              f"{bound * 1e3:.3f} us ({by}), {100 * bound / ms:.1f}% of it "
              f"[{card}]", flush=True)
        if not same or form != "aligned":
            raise AssertionError(f"pam4 decode {label}: {form} form, "
                                 f"bit-equal {same}")
        if record is None:
            record = dict(
                name="pam4_decode_dequantize", route="cuda",
                source="src/repro_torch/csrc/pam4.cu",
                replaces="src/repro/kernels/pam4.py:64", max_abs_err=0.0,
                ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=None)
    return record


# ---------------------------------------------- phase 2c: onn_layer
def onn_bound(rows, n, m):
    """Least time of one layer: each input read once, the output written
    once, against 2 rows n m f32 flops."""
    nbytes = 4 * (rows * n + m * n + 2 * m + rows * m)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * rows * n * m / PEAK_FLOPS["float32"] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def onn_build_report(card: str) -> list:
    """Registers, spills and shared memory of every onn_layer kernel, and
    the FFMA, 128-bit shared loads and cp.async copies of each where
    cuobjdump exists.  Returns the wide-form kernels that spill."""
    from repro_torch.kernels import _build
    path = _build.build(["onn_layer"])["onn_layer"]
    ops = ("FFMA", "LDS.128", "LDGSTS")
    sass = sass_counts(path, ops)
    spilling = []
    for short, fn, st in ptxas_stats(path):
        spill = st["spill"]
        count = (", ".join(f"{op} {sass[fn][op]}" for op in ops)
                 if fn in sass else "SASS not counted (no cuobjdump)")
        print(f"  onn_layer: {short}: {st.get('regs')} registers, "
              f"{spill[0]} bytes spill stores, {spill[1]} bytes spill loads, "
              f"{st.get('smem', 0)} bytes static smem; {count} [{card}]",
              flush=True)
        if "wide" in short and any(spill):
            spilling.append(short)
    return spilling


def onn_inputs(rows, n, m, random_d, g, offset=False):
    """x (rows, n), w (m, n), d, b on the card; x a view 4 bytes past
    the start of its buffer on the card when ``offset``."""
    import torch
    x = torch.randn((rows * n + offset,), generator=g).cuda()
    x = x[int(offset):].view(rows, n)
    w = torch.randn((m, n), generator=g) * (2.0 / n) ** 0.5
    d = torch.randn((m,), generator=g) if random_d else torch.ones(m)
    b = torch.randn((m,), generator=g) * 0.1
    return [x] + [t.cuda() for t in (w, d, b)]


def check_onn_case(label, x, w, d, b, relu, want_form=None):
    """One phase-2c case: the wrapper's form against the plain version
    within ONN_TOL of max|y|, twice for identical bits, and equal to the
    general form (every form sums in one order).  Returns the form and
    the max abs error."""
    import torch
    from repro_torch.kernels import onn_layer, ref
    (rows, n), m = x.shape, w.shape[0]
    y = torch.empty((rows, m), device="cuda")
    form = onn_layer.plan(rows, n, m, x.data_ptr(), y.data_ptr(),
                          onn_layer._sms(x.device.index)).form
    got = onn_layer.onn_layer(x, w, d, b, relu)
    again = onn_layer.onn_layer(x, w, d, b, relu)
    general = onn_layer.onn_layer_general(x, w, d, b, relu)
    want = ref.onn_layer_ref(x, w, d, b, relu)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    rel = err / max(want.abs().max().item(), 1e-30)
    same = torch.equal(got.view(torch.int32), again.view(torch.int32))
    as_general = torch.equal(got, general)
    print(f"onn_layer {label}: rows={rows} n={n} m={m} relu={relu} form "
          f"{form}: max_abs_err {err:.3e}, / max|y| {rel:.3e} (tol "
          f"{ONN_TOL:.0e}); two calls bit-identical {same}; equal to the "
          f"general form {as_general}", flush=True)
    if not (rel <= ONN_TOL and same and as_general):
        raise AssertionError(f"onn_layer {label} ({form} form) disagrees")
    if want_form and form != want_form:
        raise AssertionError(f"onn_layer {label}: form {form}, want "
                             f"{want_form}")
    return form, err


def check_onn_kernel(card: str) -> dict:
    """onn_layer on the card (phase 2c): every bits-8 layer and the exact
    identity's two over one bucket, then the edges of each form (rows 1,
    127, 129, 1000; a partial k chunk; masked columns; an x view off the
    16-byte alignment; a ragged d != 1 layer), each against its plain
    version, twice for identical bits and against the general form; then
    at every bucket shape the form the wrapper picks, the general form
    (the first kernel), the plain version, one PyTorch call
    (``torch._addmm_activation`` with its fused ReLU, ``torch.addmm`` for
    the last layer) and ``addmm`` + ``relu``, beside the bound.  Returns
    the record of the widest bits-8 layer.  Alone: ``python3 -c 'import
    chip_smoke as c; c.check_onn_kernel(c.card_line())'``."""
    import torch
    from repro_torch.kernels import onn_layer, ref

    spilling = onn_build_report(card)
    g = torch.Generator().manual_seed(SEED + 3)
    dims = list(zip(ONN8_STRUCTURE[:-1], ONN8_STRUCTURE[1:]))
    bucket = [(f"bits8 {n}->{m}", n, m, i < len(dims) - 1)
              for i, (n, m) in enumerate(dims)]
    bucket += [("exact 1->4", 1, 4, True), ("exact 4->1", 4, 1, False)]
    edges = []
    # (label, rows, n, m, random d, x off the alignment, the form wanted);
    # up to 1000 rows there are fewer row tiles than blocks
    for n, m, form in ((128, 256, "wide"), (256, 128, "wide"),
                       (128, 64, "wide"), (4, 64, "fan_out"),
                       (1, 4, "fan_out"), (4, 1, "fan_out"),
                       (64, 4, "fan_in"), (64, 2, "fan_in")):
        edges += [(f"edge {n}->{m}", rows, n, m, False, False, form)
                  for rows in (1, 127, 129, 1000)]
    edges += [("partial k chunk, masked columns", 1000, 36, 300, True,
               False, "wide"),
              ("partial k chunk, masked columns", 1000, 100, 12, True,
               False, "wide"),
              ("157 row tiles over 132 blocks", 20000, 64, 128, False,
               False, "wide"),
              ("x 4 bytes off", 1000, 128, 256, False, True, "general"),
              ("ragged d!=1", 1000, 37, 300, True, False, "general")]
    n_cases = 0
    for label, rows, n, m, random_d, offset, form in edges:
        x, w, d, b = onn_inputs(rows, n, m, random_d, g, offset)
        check_onn_case(label, x, w, d, b, rows % 2 == 1, form)
        n_cases += 1

    records = {}
    for label, n, m, relu in bucket:
        x, w, d, b = onn_inputs(BUCKET_ROWS, n, m, False, g)
        form, err = check_onn_case(label, x, w, d, b, relu)
        n_cases += 1
        ins = copies_for([x, w, d, b])
        ms, host_ms = time_ms(
            lambda *a: onn_layer.onn_layer(*a, relu=relu), ins)
        general_ms, _ = time_ms(
            lambda *a: onn_layer.onn_layer_general(*a, relu=relu), ins)
        plain_ms, _ = time_ms(
            lambda *a: ref.onn_layer_ref(*a, relu=relu), ins, iters=20)

        def one_call(x, w, d, b):              # d is 1 on these layers
            return (torch._addmm_activation(b, x, w.T) if relu
                    else torch.addmm(b, x, w.T))

        def addmm_relu(x, w, d, b):
            y = torch.addmm(b, x, w.T)
            return torch.relu(y) if relu else y

        lib_ms, _ = time_ms(one_call, ins)
        two_ms, _ = time_ms(addmm_relu, ins)
        want = ref.onn_layer_ref(x, w, d, b, relu)
        lib_err = ((one_call(x, w, d, b) - want).abs().max()
                   / want.abs().max()).item()
        bound, by = onn_bound(BUCKET_ROWS, n, m)
        print(f"onn_layer {label} timing: {form} form {ms * 1e3:.2f} us "
              f"(host {host_ms * 1e3:.2f} us), general form (the first "
              f"kernel) {general_ms * 1e3:.2f} us, plain "
              f"{plain_ms * 1e3:.2f} us, one call "
              f"({'_addmm_activation' if relu else 'addmm'}, within "
              f"{lib_err:.1e}) {lib_ms * 1e3:.2f} us, addmm"
              f"{' + relu' if relu else ''} {two_ms * 1e3:.2f} us, bound "
              f"{bound * 1e3:.3f} us ({by}); {form} form at "
              f"{100 * bound / ms:.1f}% of its bound, general at "
              f"{100 * bound / general_ms:.1f}% [{card}]", flush=True)
        if label == "bits8 128->256":
            records["onn_layer"] = dict(
                name="onn_layer", route="cuda",
                source="src/repro_torch/csrc/onn_layer.cu",
                replaces="src/repro/kernels/onn_layer.py:38",
                max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms)
        del ins, want
    print(f"onn_layer: {n_cases} cases within {ONN_TOL:.0e} of max|y|, "
          f"bit-identical twice and equal to the general form [{card}]",
          flush=True)
    if spilling:
        raise AssertionError(f"wide-form kernels spill registers: "
                             f"{spilling}")
    return records


ISSUE_PROBE_CU = r"""
// FFMA rate of a TM x 8 tile of register sums, 256 threads a block, one
// block an SM: alone, and fed by the 128-bit shared loads the wide form
// of onn_layer issues (TM + 8 a 4 k, each quarter warp reading 4 or 2
// distinct 16-byte words, as there).
#include <cstdio>
#include <cuda_runtime.h>
template <int TM, bool LOADS>
__global__ void __launch_bounds__(256, 1) probe(int iters, float* sink) {
  __shared__ float4 s[2048];
  for (int i = threadIdx.x; i < 2048; i += blockDim.x)
    s[i] = make_float4(1e-7f, 1e-7f, 1e-7f, 1e-7f);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int xo = (lane & 3) * 9, wo = ((lane >> 2) & 1) * 36 + 1024;
  float acc[TM][8];
  float4 a[TM], v[8];
  for (int i = 0; i < TM; ++i) {
    a[i] = make_float4(threadIdx.x * 1e-3f, i, 1, 2);
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  for (int j = 0; j < 8; ++j) v[j] = make_float4(j * 1e-3f, 3, 4, 5);
  for (int it = 0; it < iters; ++it) {
    if (LOADS) {
      const int o = it & 7;
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = s[xo + i * 36 + o];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = s[wo + j * 9 + o];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].x, v[j].x, acc[i][j]);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].y, v[j].y, acc[i][j]);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].z, v[j].z, acc[i][j]);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].w, v[j].w, acc[i][j]);
  }
  float sum = 0.f;
  for (int i = 0; i < TM; ++i)
    for (int j = 0; j < 8; ++j) sum += acc[i][j];
  if (sum == 1.2345f) sink[0] = sum;
}
template <int TM, bool LOADS>
void run(int sms, float* sink) {
  const int iters = 20000 * 8 / TM;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(e0);
    probe<TM, LOADS><<<sms, 256>>>(iters, sink);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    if (rep)
      printf("%d x 8 tile, %s: %.1f TFLOP/s (%s)\n", TM,
             LOADS ? "fed by 128-bit shared loads" : "registers only",
             2.0 * TM * 8 * 4 * iters * 256.0 * sms / ms / 1e9,
             cudaGetErrorString(cudaGetLastError()));
  }
}
int main() {
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* sink;
  cudaMalloc(&sink, 4);
  run<8, false>(sms, sink);
  run<8, true>(sms, sink);
  run<16, true>(sms, sink);
  return 0;
}
"""


def onn_issue_probe(card: str) -> None:
    """What bounds the wide form of onn_layer: the f32 FMA rate of an 8 x
    8 (and 16 x 8) tile of register sums alone and fed by its 128-bit
    shared loads, against the card's peak.  Not part of the run; alone:
    ``python3 -c 'import chip_smoke as c; c.onn_issue_probe(c.card_line())'``."""
    from repro_torch.kernels import _build
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, exe = out_dir / "issue_probe.cu", out_dir / "issue_probe"
    src.write_text(ISSUE_PROBE_CU)
    subprocess.run([_build._nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-o", str(exe),
                    str(src)], check=True, timeout=300)
    out = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True, timeout=300).stdout
    for line in out.splitlines():
        tf = float(line.split(": ")[1].split()[0])
        print(f"{line}; {100 * tf / (PEAK_FLOPS['float32'] / 1e12):.1f}% of "
              f"the f32 peak [{card}]", flush=True)


# ---------------------------------------------- phase 2d: mesh_scan
def random_stack(m: int, blocks: int, seed: int):
    """B compiled programs of random orthogonal m x m matrices (QR, then
    Givens) stacked on a block axis, on the CPU, and the matrices."""
    import numpy as np
    from repro_torch.photonics import mesh, mzi
    rng = np.random.default_rng(seed)
    qs = [np.linalg.qr(rng.normal(size=(m, m)))[0] for _ in range(blocks)]
    return mesh._stack_meshes([mesh.MZIMesh.compile(mzi.givens_decompose(q))
                               for q in qs]), qs


def mesh_diagonal_products(rows, blocks, m, transpose, post_scale):
    """The products a launch needs for its diagonals: one a wire a row,
    two going forward with a post_scale (signs before the layers, the
    scale after them; the transpose applies both after, as one)."""
    both = post_scale is not None and not transpose
    return rows * blocks * m * (2 if both else 1)


# operations of the theta drift for one (layer, wire, block), counted
# from its plain version (kernels/ref.py): the counter and its two mix32
# hashes 21 integer operations, the two uniforms 7, Box-Muller 6, the
# symmetrised eps 6, its cos and sin 2, the rotated (ca, sa) 6
DRIFT_OPS = 48


def mesh_bound(rows, st, x_blocked, transpose, post_scale, drift=False):
    """Least time of one launch of the stack st: x read once (one slice
    per block when blocked), the output written once, the (perm, ca, sa)
    stacks and the diagonals read once, against the f32 flops the
    function needs: 3 for each wire of each of the st.n_rot rotations (a
    product and an fma) a row, and the diagonals' products.  Identity
    slots (perm[w] = w, ca 1, sa 0) need none.  With ``drift``, the
    theta drift's DRIFT_OPS once per layer, wire and block, as the JAX
    kernel draws its field (once, not once a row tile)."""
    blocks, layers, m = st.perm.shape
    x_rows = rows * blocks if x_blocked else rows
    nbytes = 4 * (x_rows * m + rows * blocks * m + 3 * blocks * layers * m
                  + 2 * blocks * m)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    flops = (6 * rows * st.n_rot
             + mesh_diagonal_products(rows, blocks, m, transpose, post_scale)
             + (DRIFT_OPS * blocks * layers * m if drift else 0))
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def mesh_instruction_floor(rows, st, transpose, post_scale):
    """The ms of one launch of the stack st if it issued only what the
    function needs: a product and an fma for each wire of each rotation
    (2 instruction slots of a lane) and the diagonals' products, at the
    H100 SXM's instruction rate (132 SMs x 4 schedulers x 32 lanes at
    the 1.98 GHz boost clock)."""
    blocks, _, m = st.perm.shape
    slots = (4 * rows * st.n_rot
             + mesh_diagonal_products(rows, blocks, m, transpose, post_scale))
    return slots / (132 * 4 * 32 * 1.98e9) * 1e3


def once_ms(fn, *args):
    """(fn(*args), device ms of that one call): for the plain versions at
    a full bucket, seconds a call, where a warm-up and launch overhead
    are noise."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn(*args)
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def mixed_depth_stack(m: int, seed: int):
    """Three programs of width m and different depths stacked (the
    shallower padded with identity layers): a random orthogonal matrix,
    one acting on the first m / 2 wires, one 2 x 2 rotation.  Returns
    the stack on the CPU and the three depths."""
    import numpy as np
    from repro_torch.photonics import mesh, mzi
    rng = np.random.default_rng(seed)
    half = np.eye(m)
    half[:m // 2, :m // 2] = np.linalg.qr(rng.normal(size=(m // 2,) * 2))[0]
    few = np.eye(m)
    few[:2, :2] = [[0.6, -0.8], [0.8, 0.6]]
    meshes = [mesh.MZIMesh.compile(mzi.givens_decompose(q)) for q in (
        np.linalg.qr(rng.normal(size=(m, m)))[0], half, few)]
    return mesh._stack_meshes(meshes), [mh.depth for mh in meshes]


def check_mesh_case(st, label, x, blocked, transpose, blk_b, post, g):
    """One phase-2d case: the kernel bit for bit against its plain
    version without noise; with the theta drift (std 0.05) within
    MESH_THETA_TOL of max|y|, and moved by the drift.  Returns that
    error."""
    import torch
    from repro_torch.kernels import mesh_scan, ref
    blocks = st.perm.shape[0]
    kw = dict(x_block_axis=blocked, transpose=transpose, post_scale=post)
    args = (st.signs, st.perm, st.ca, st.sa, x)
    got = mesh_scan.mesh_scan_blocks(*args, blk_b=blk_b, **kw)
    want = ref.mesh_scan_blocks_ref(*args, **kw)
    seeds = torch.randint(0, 2 ** 32, (blocks,), generator=g).cuda()
    got_t = mesh_scan.mesh_scan_blocks(*args, blk_b=blk_b, theta_std=0.05,
                                       seeds=seeds, **kw)
    want_t = ref.mesh_scan_blocks_ref(*args, theta_std=0.05, seeds=seeds,
                                      **kw)
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    rel = ((got_t - want_t).abs().max() / want_t.abs().max()).item()
    moved = (got_t - got).abs().max().item()
    rows = x.shape[0]
    print(f"mesh_scan_blocks {label} transpose={transpose} "
          f"x_blocked={blocked} blk_b={blk_b} (tile "
          f"{mesh_scan.row_tile(st.dim, rows, blk_b)}) post_scale="
          f"{post is not None}: {rows} rows bit-equal {same}; theta_std "
          f"0.05: max_abs_err / max|y| {rel:.3e} (tol {MESH_THETA_TOL:.0e}), "
          f"drift moved the output by {moved:.3e}", flush=True)
    if not (same and rel <= MESH_THETA_TOL and moved > 0):
        raise AssertionError(f"mesh_scan_blocks {label} disagrees with its "
                             f"plain version")
    return rel


def check_mesh_kernel(card: str) -> dict:
    """mesh_scan_blocks vs its plain version on the card: every width of
    the mesh path and widths that are not a multiple of 32 (9, 33, 100)
    or above 256 (512, 600), both transposes, shared and blocked x, a
    post_scale, row counts ragged against the block's rows, two row
    tiles, a stack of meshes of different depths and an x the kernel
    cannot load in vectors, with and without the theta drift; then timed at the main path's two
    largest launches, and once with the drift."""
    import torch
    from repro_torch.kernels import mesh_scan, ref

    g = torch.Generator().manual_seed(SEED + 5)
    # (m, B): the widths and block counts of the approx and svd layers
    shapes = [(4, 16), (64, 2), (128, 2), (64, 1), (256, 1)]
    # (m, B) not on the path: widths not a multiple of 32, and above 256
    # (600: 32 wires a lane, the widest form)
    more = [(9, 3), (33, 2), (100, 1), (512, 1), (600, 1)]
    stacks = {}                          # label -> (stack, on the path)
    for i, (m, blocks) in enumerate(shapes + more):
        st, _ = random_stack(m, blocks, SEED + 10 + i)
        stacks[f"m={m} B={blocks} L={st.depth}"] = (st.to("cuda"),
                                                    (m, blocks) in shapes)
        print(f"mesh_scan program m={m} B={blocks}: L={st.depth}, "
              f"{st.n_rot} rotations, W={mesh_scan.lane_wires(m)} wires a "
              f"lane, {mesh_scan.warp_rows(m)} rows a warp", flush=True)
    mixed, depths = mixed_depth_stack(64, SEED + 30)
    stacks[f"m=64 B=3 L={mixed.depth} (depths {depths})"] = (
        mixed.to("cuda"), False)
    worst = 0.0
    n_cases = 0
    for label, (st, on_path) in stacks.items():
        m, blocks = st.dim, st.perm.shape[0]
        # the path's cases: 1000 rows, tiles default and 24; the others:
        # 777 rows (a multiple of no tile), tiles default and 8
        rows, small = (1000, 24) if on_path else (777, 8)
        ps = (torch.randn((blocks, m), generator=g) + 1.0).cuda()
        for transpose in (False, True):
            for blocked in ((False, True) if blocks > 1 else (False,)):
                shape = (rows, blocks, m) if blocked else (rows, m)
                x = torch.randn(shape, generator=g).cuda()
                for blk_b in (0, small):
                    worst = max(worst, check_mesh_case(
                        st, label, x, blocked, transpose, blk_b,
                        ps if blk_b else None, g))
                    n_cases += 1
    # x 4 bytes off the 16-byte alignment of a vector load
    st = stacks[f"m=256 B=1 L={2 * 256 - 3}"][0]
    for transpose in (False, True):
        buf = torch.randn(777 * 256 + 1, generator=g).cuda()
        x = buf[1:].view(777, 256)
        worst = max(worst, check_mesh_case(
            st, f"m=256 B=1 L={st.depth} x unaligned", x, False, transpose,
            0, None, g))
        n_cases += 1
    print(f"mesh_scan_blocks: {n_cases} cases bit-equal without noise; "
          f"theta drift worst {worst:.3e} of max|y|", flush=True)

    records = {}
    # the main path's largest launches over one bucket of rows: the V
    # mesh of the 256 -> 128 svd layer (o^T, B = 1), and the blocked
    # approx layer 256 -> 128 (B = 2 meshes of 128, its Sigma_a fused)
    for label, m, blocks, blocked, transpose in (
            ("svd V 256, transpose", 256, 1, False, True),
            ("approx 128 x 2, blocked", 128, 2, True, False)):
        st, qs = random_stack(m, blocks, SEED + 20 + m)
        st = st.to("cuda")
        shape = (BUCKET_ROWS, blocks, m) if blocked else (BUCKET_ROWS, m)
        x = torch.randn(shape, generator=g).cuda()
        ps = (torch.rand((blocks, m), generator=g) + 0.5).cuda()
        post = ps if blocked else None
        kw = dict(x_block_axis=blocked, transpose=transpose, post_scale=post)
        args = (st.signs, st.perm, st.ca, st.sa, x)
        got = mesh_scan.mesh_scan_blocks(*args, **kw)
        # the one plain call is checked against and timed
        want, plain_ms = once_ms(lambda: ref.mesh_scan_blocks_ref(*args,
                                                                  **kw))
        same = torch.equal(got, want)
        # yardstick: the same linear map as one dense product, f32 with
        # TF32 off: y = x o_b^T (o_b with transpose), Sigma_a folded in
        mats = torch.stack([torch.from_numpy(q.T if transpose else q)
                            .float() for q in qs]).cuda()
        if post is not None:
            mats = mats * post[:, :, None]
        dense = torch.einsum("rbi,bji->rbj",
                             x if blocked else x[:, None, :].expand(
                                 -1, blocks, -1), mats)
        lib_err = ((dense - got).abs().max() / got.abs().max()).item()
        print(f"mesh_scan_blocks {label}: {BUCKET_ROWS} rows, L={st.depth}: "
              f"bit-equal to the plain version {same}; the dense product "
              f"agrees within {lib_err:.3e} of max|y|", flush=True)
        if not same:
            raise AssertionError(f"mesh_scan_blocks {label} disagrees with "
                                 f"its plain version")
        ins = copies_for([x])
        ms, host_ms = time_ms(lambda a: mesh_scan.mesh_scan_blocks(
            st.signs, st.perm, st.ca, st.sa, a, **kw), ins, iters=5)
        if blocked:
            lib_ms, _ = time_ms(lambda a: torch.einsum("rbi,bji->rbj", a,
                                                       mats), ins, iters=5)
        else:
            lib_ms, _ = time_ms(lambda a: torch.matmul(a, mats[0].T), ins,
                                iters=5)
        bound, by = mesh_bound(BUCKET_ROWS, st, blocked, transpose, post)
        floor = mesh_instruction_floor(BUCKET_ROWS, st, transpose, post)
        print(f"mesh_scan_blocks {label} timing: kernel {ms:.3f} ms (host "
              f"{host_ms:.3f} ms), plain {plain_ms:.3f} ms, dense f32 "
              f"product ({'einsum' if blocked else 'matmul'}, TF32 off, "
              f"the same linear map in other arithmetic) {lib_ms:.3f} ms, "
              f"bound {bound:.3f} ms ({by}); kernel at "
              f"{100 * bound / ms:.1f}% of its bound, {100 * floor / ms:.1f}% "
              f"of the {floor:.3f} ms instruction-rate floor of its "
              f"rotations ({2 * st.n_rot} wire updates a row, "
              f"{100 * 2 * st.n_rot / st.perm.numel():.1f}% of the B L m "
              f"slots the kernel updates) [{card}]", flush=True)
        if label.startswith("svd"):
            seeds = torch.randint(0, 2 ** 32, (blocks,), generator=g).cuda()
            drift_ms, _ = time_ms(lambda a: mesh_scan.mesh_scan_blocks(
                st.signs, st.perm, st.ca, st.sa, a, theta_std=0.05,
                seeds=seeds, **kw), ins, iters=3)
            d_bound, d_by = mesh_bound(BUCKET_ROWS, st, blocked, transpose,
                                       post, drift=True)
            print(f"mesh_scan_blocks {label} with the theta drift (std "
                  f"0.05): kernel {drift_ms:.3f} ms, bound {d_bound:.3f} ms "
                  f"({d_by}; the rotations and {DRIFT_OPS} operations a "
                  f"layer, wire and block for the drift); kernel at "
                  f"{100 * d_bound / drift_ms:.1f}% of its bound [{card}]",
                  flush=True)
            records["mesh_scan_blocks"] = dict(
                name="mesh_scan_blocks", route="cuda",
                source="src/repro_torch/csrc/mesh_scan.cu",
                replaces="src/repro/kernels/mesh_scan.py:194",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib_ms)
        del ins, got, want, dense
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


def short_kernel(name: str) -> str:
    """``flash_fwd_mma_kernel<48>`` of a demangled kernel name such as
    ``void (anonymous namespace)::flash_fwd_mma_kernel<(int)48>(
    __nv_bfloat16 const*, ...)`` (``<unnamed>::`` for cu++filt)."""
    for part in ("(anonymous namespace)::", "<unnamed>::", "(int)",
                 "(bool)"):
        name = name.replace(part, "")
    return name.removeprefix("void ").split("(")[0].strip()


def kernel_name(key: str) -> str:
    """``flash_fwd_mma_kernel`` of a profiler key such as ``void
    (anonymous namespace)::flash_fwd_mma_kernel<48>(__nv_bfloat16 const*,
    ...)``."""
    return short_kernel(key).split("<")[0]


def device_profile(prof, wall_s: float, card: str,
                   what: str = "serve window") -> dict:
    """Print the device's busy share of a profiled window (device time of
    every kernel and copy CUPTI saw, over the window's wall time) and the
    device time of its heaviest kernels; returns {name: device us}."""
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
        return {}
    print(f"profiled {what}: {wall_s * 1e3:.3f} ms wall, device busy "
          f"{busy_us / 1e3:.3f} ms = {100 * busy_us / (wall_s * 1e6):.2f}% "
          f"[{card}]", flush=True)
    for e in sorted(rows, key=dev_us, reverse=True)[:10]:
        print(f"  device {dev_us(e):10.1f} us {e.count:5d} calls "
              f"{dev_us(e) / e.count:8.2f} us/call "
              f"{100 * dev_us(e) / busy_us:5.1f}%  {e.key[:90]}", flush=True)
    return {e.key: dev_us(e) for e in rows}


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
    dev = device_profile(prof, w, card)
    paged = [(kernel_name(ev.key), ev.count, dev[ev.key])
             for ev in prof.key_averages()
             if "paged_" in ev.key and dev.get(ev.key)]
    if paged:
        us = sum(u for _, _, u in paged)
        print(f"paged_attention in the profiled serve window: device "
              f"{us / 1e3:.3f} ms = {100 * us / sum(dev.values()):.2f}% of "
              f"the device time, {100 * us / (w * 1e6):.2f}% of the wall ("
              + ", ".join(f"{name} {n} calls {u / n:.2f} us/call"
                          for name, n, u in paged) + f") [{card}]",
              flush=True)

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


# ----------------------------------------------------- phase 4: train
def _train_counters():
    from repro_torch.kernels import attention, pam4
    return {"flash_attention": attention.flash_attention,
            "flash_attention_bwd": attention.flash_attention_bwd,
            "pam4_quantize_encode": pam4.pam4_quantize_encode,
            "pam4_decode_dequantize": pam4.pam4_decode_dequantize}


def train_run(argv, steps: int, callbacks=()):
    """``steps`` steps of the training entry point on TRAIN_ARGV + argv:
    its records (checked against the printed lines) and its losses whole
    (the records round them to 5 digits)."""
    from repro_torch.api.callbacks import Callback
    from repro_torch.launch import train

    class WholeLosses(Callback):
        def __init__(self):
            self.losses = []

        def on_step(self, session, record):
            self.losses.append(session.losses[record["step"]])

    buf, whole = io.StringIO(), WholeLosses()
    recs = train.run(train.parse_args(TRAIN_ARGV + argv
                                      + ["--steps", str(steps)]), out=buf,
                     callbacks=[whole, *callbacks])
    if [json.loads(line) for line in buf.getvalue().splitlines()] != recs:
        raise AssertionError("the printed step records differ")
    return recs, whole.losses


def train_full_width(card: str):
    """Returns the launch count of each training kernel in the run, the
    run's losses and its p50 step time in ms."""
    import torch
    from repro_torch import configs
    from repro_torch.collectives.bucketizer import expected_buckets
    from repro_torch.collectives.engine import SyncConfig
    from repro_torch.models import lm
    from repro_torch.tree import leaves

    cfg = configs.get("paper_llama")
    n_params = sum(math.prod(s) for s in leaves(lm.param_shapes(cfg)))
    counters = _train_counters()
    for fn in counters.values():
        fn.launches = 0
    encode = counters["pam4_quantize_encode"]
    decode = counters["pam4_decode_dequantize"]
    for fn in (encode, decode):
        fn.forms = dict.fromkeys(fn.forms, 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    recs, full = train_run([], 30)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    print(f"pam4 forms over the run's buckets: encode {encode.forms}, "
          f"decode {decode.forms}", flush=True)
    if encode.forms["scalar"] or decode.forms["aligned"] != decode.launches:
        raise AssertionError(f"a bucket of block 2048 left the aligned "
                             f"form: encode {encode.forms}, decode "
                             f"{decode.forms}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [r["loss"] for r in recs]
    times = [r["time_s"] for r in recs[5:]]
    tokens = 32 * 512
    n_buckets = expected_buckets(4 * n_params)
    print(f"train paper_llama bf16 ({n_params} params, {n_buckets} buckets "
          f"of 4 MiB), --sync optinc --bits 8 --mesh 4x1, 32 x 512 tokens, "
          f"30 steps in {wall:.3f} s: loss {losses[0]} -> {losses[-1]}; "
          f"launches {launches}; peak memory {peak_gb:.3f} GB", flush=True)
    p50 = pct(times, 0.5)
    print(f"train step time over steps 5-29: p50 {p50 * 1e3:.3f} ms p99 "
          f"{pct(times, 0.99) * 1e3:.3f} ms; {tokens / p50:.1f} tokens/s at "
          f"p50; first step {recs[0]['time_s'] * 1e3:.3f} ms [{card}]",
          flush=True)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was not launched by the run")
    want_pam4 = 30 * n_buckets
    if (launches["pam4_quantize_encode"] != want_pam4
            or launches["pam4_decode_dequantize"] != want_pam4):
        raise AssertionError(f"pam4 launches {launches}: want one encode and "
                             f"one decode per bucket, {want_pam4}")
    want_flash = 30 * 4 * cfg.n_layers             # a layer and peer a step
    if (launches["flash_attention"] != want_flash
            or launches["flash_attention_bwd"] != want_flash):
        raise AssertionError(f"flash launches {launches}: want one forward "
                             f"and one backward per layer and peer, "
                             f"{want_flash}")

    psum, psum_full = train_run(["--sync", "psum"], 10)
    ptimes = [r["time_s"] for r in psum[3:]]
    print(f"yardstick --sync psum, same config, 10 steps: step p50 "
          f"{pct(ptimes, 0.5) * 1e3:.3f} ms p99 {pct(ptimes, 0.99) * 1e3:.3f}"
          f" ms over steps 3-9; loss {psum[0]['loss']} -> {psum[-1]['loss']}"
          f" [{card}]", flush=True)

    dev = profile_train_step(card, SyncConfig(mode="optinc", bits=8,
                                              block=2048), "train step")
    busy = sum(dev.values())
    flash = {key: us for key, us in dev.items() if "flash" in key}
    if busy:
        print(f"flash kernels in the profiled train step: "
              f"{sum(flash.values()) / 1e3:.3f} ms = "
              f"{100 * sum(flash.values()) / busy:.2f}% of the device time ("
              + ", ".join(f"{kernel_name(key)} {100 * us / busy:.2f}%"
                          for key, us in sorted(flash.items()))
              + f") [{card}]", flush=True)
        pam4_us = {short_kernel(key): us for key, us in dev.items()
                   if "pam4" in key}
        print(f"pam4 kernels in the profiled train step: "
              f"{sum(pam4_us.values()):.1f} us = "
              f"{100 * sum(pam4_us.values()) / busy:.2f}% of the device time"
              f" (" + ", ".join(f"{key} {us:.1f} us" for key, us in
                                sorted(pam4_us.items()))
              + f") [{card}]", flush=True)
    return launches, losses, p50 * 1e3, {"optinc": full[:10],
                                          "psum": psum_full}


def profile_train_step(card: str, sync, what: str) -> dict:
    """One steady full-width training step (after two warm-up steps) under
    the profiler: prints the device's busy share and the device time of
    each kernel; returns {kernel: device us}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    cfg = configs.get("paper_llama")
    opt = AdamWConfig()
    params = lm.init_params(cfg, SEED, "cuda")
    ostate = adamw_init(opt, params)
    step = tsteps.make_train_step(cfg, 4, sync, opt, "cuda")
    g = torch.Generator().manual_seed(SEED)
    tok = torch.randint(0, cfg.vocab, (32, 513), generator=g).cuda()
    for _ in range(2):
        params, ostate, _, m = step(params, ostate, {}, tok)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, ostate, _, m = step(params, ostate, {}, tok)
        float(m["loss"])
        w = time.perf_counter() - t0
    return device_profile(prof, w, card, what)


def first_bucket_codes():
    """The 4 peers' B-bit codes of the first bucket of phase 4's step-0
    gradients (paper_llama, seed SEED, --bits 8 --block 2048): (4,
    1,048,576) int32 on the card."""
    import torch
    from repro_torch import configs
    from repro_torch.collectives import backends
    from repro_torch.collectives.bucketizer import make_layout
    from repro_torch.collectives.engine import SyncConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import lm
    from repro_torch.tree import leaves

    cfg = configs.get("paper_llama")
    sync = SyncConfig(mode="optinc", bits=8, block=2048)
    layout = make_layout([(shape, lm.torch_dtype(cfg)) for shape in
                          leaves(lm.param_shapes(cfg))], sync.bucket_bytes)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=512,
                                  global_batch=32, seed=SEED))
    _, flat = tsteps.peer_grad_stack(
        cfg, lm.init_params(cfg, SEED, "cuda"),
        torch.from_numpy(data.batch(0)).cuda(), 4, layout.total)
    s, e = layout.bounds[0]
    x = flat[:, s:e].contiguous()
    return backends._encode(x, backends._shared_scale(x, sync),
                            sync).reshape(4, -1)


def codes_off_behavioral(module, u, fidelity, backend="xla") -> float:
    """Share of the averaged codes of ``u`` (first_bucket_codes) that the
    pipeline through ``module`` gives other than behavioral Q(mean)."""
    from repro_torch.photonics import encoding, pipeline
    got = pipeline.level_pipeline(module, 8, fidelity=fidelity,
                                  mesh_backend=backend).run(u).data
    return (got != encoding.qmean(u)).float().mean().item()


def train_onn_full_width(card: str, behavioral8, onn):
    """Phase 4b: the onn fidelity at full width; returns the launch
    counts of the bits-8 run through the trained ONN (phase 4d's pick,
    ``onn``) and the losses of the behavioral bits-2 run."""
    import torch
    from repro_torch import configs
    from repro_torch.collectives.bucketizer import expected_buckets
    from repro_torch.collectives.engine import SyncConfig
    from repro_torch.kernels import onn_layer
    from repro_torch.models import lm
    from repro_torch.photonics import PhotonicsConfig, runtime
    from repro_torch.tree import leaves

    cfg = configs.get("paper_llama")
    n_buckets = expected_buckets(4 * sum(
        math.prod(s) for s in leaves(lm.param_shapes(cfg))))
    counters = dict(_train_counters(), onn_layer=onn_layer.onn_layer)
    decode = counters["pam4_decode_dequantize"]

    def run(argv, steps):
        for fn in counters.values():
            fn.launches = 0
        decode.forms = dict.fromkeys(decode.forms, 0)
        recs = train_run(argv, steps)[0]
        launches = {name: fn.launches for name, fn in counters.items()}
        print(f"  {' '.join(argv)}: pam4 decode forms {decode.forms}",
              flush=True)
        idle = [name for name, n in launches.items()
                if n == 0 and name != "onn_layer"]
        if (idle or launches["pam4_quantize_encode"] != n_buckets * steps
                or launches["pam4_decode_dequantize"] != n_buckets * steps
                or decode.forms["aligned"] != n_buckets * steps):
            raise AssertionError(f"launches {launches} of {argv}: every "
                                 f"training kernel, pam4 encode and decode "
                                 f"once per bucket, aligned: "
                                 f"{decode.forms}")
        return recs, launches

    runs = {fid: run(["--bits", "2", "--fidelity", fid], 10)
            for fid in ("behavioral", "onn")}
    for fid, (recs, launches) in runs.items():
        times = [r["time_s"] for r in recs[3:]]
        print(f"train paper_llama bf16 --sync optinc --bits 2 --fidelity "
              f"{fid} --mesh 4x1, 10 steps: loss {recs[0]['loss']} -> "
              f"{recs[-1]['loss']}; step p50 {pct(times, 0.5) * 1e3:.3f} ms "
              f"p99 {pct(times, 0.99) * 1e3:.3f} ms over steps 3-9; "
              f"launches {launches} [{card}]", flush=True)
    losses = {fid: [r["loss"] for r in recs] for fid, (recs, _) in
              runs.items()}
    if losses["onn"] != losses["behavioral"]:
        raise AssertionError(f"--fidelity onn --bits 2 losses differ from "
                             f"behavioral: {losses}")
    want = 2 * n_buckets * 10
    if (runs["onn"][1]["onn_layer"] != want
            or runs["behavioral"][1]["onn_layer"] != 0):
        raise AssertionError(f"onn_layer launches {runs['onn'][1]} and "
                             f"{runs['behavioral'][1]}: want {want} and 0")

    ph = PhotonicsConfig(fidelity="onn")
    runtime.put_module(ph, 8, 4, onn["module"])
    torch.cuda.reset_peak_memory_stats()
    recs, launches = run(["--bits", "8", "--fidelity", "onn"], 10)
    got = [r["loss"] for r in recs]
    times = [r["time_s"] for r in recs[1:]]
    share = codes_off_behavioral(onn["module"], onn["codes"], "onn")
    dl = max(abs(a - b) for a, b in zip(got, behavioral8))
    print(f"train paper_llama bf16 --sync optinc --bits 8 --fidelity onn "
          f"(the trained {onn['label']} ONN, onn_layer accuracy "
          f"{onn['onn_acc']:.7f}) --mesh 4x1, 10 steps: loss {got}; phase "
          f"4 behavioral {behavioral8[:10]}; max |dloss| {dl:.5f}; codes of "
          f"one bucket (step 0, bucket 0) off behavioral Q(mean) "
          f"{100 * share:.4f}%; step p50 {pct(times, 0.5) * 1e3:.3f} ms p99 "
          f"{pct(times, 0.99) * 1e3:.3f} ms over steps 1-9; first step "
          f"{recs[0]['time_s'] * 1e3:.3f} ms; launches {launches}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB "
          f"[{card}]", flush=True)
    if not all(math.isfinite(x) for x in got):
        raise AssertionError(f"non-finite losses at bits 8: {got}")
    if onn["onn_acc"] == 1.0 and (got != behavioral8[:10] or share):
        raise AssertionError("an ONN exact on the whole input grid must "
                             "give behavioral's losses bit for bit")
    if launches["onn_layer"] != 6 * n_buckets * 10:
        raise AssertionError(f"onn_layer launches {launches['onn_layer']}: "
                             f"want {6 * n_buckets * 10}")
    for bits in (2, 8):
        dev = profile_train_step(
            card, SyncConfig(mode="optinc", bits=bits, block=2048,
                             photonics=ph), f"train step --fidelity onn "
            f"--bits {bits}")
        onn_us = sum(us for k, us in dev.items() if "onn_layer" in k)
        print(f"  onn_layer: {onn_us:.1f} us of the step's device time, "
              f"{100 * onn_us / max(sum(dev.values()), 1e-9):.2f}% "
              f"[{card}]", flush=True)
    return launches, losses["behavioral"]


def seeded_onn(ph, approx_layers, seed: int, peers: int = 4):
    """A seeded bits-8 ONN of ONN8_STRUCTURE for ``peers`` servers, its
    ``approx_layers`` projected onto Sigma_a U_a (random weights: the
    kernels at the paper's widths, not a trained ONN)."""
    from repro_torch.photonics import onn, runtime
    from repro_torch.photonics.module import ONNModule
    cfg = dataclasses.replace(runtime.onn_config(ph, 8, peers),
                              approx_layers=tuple(approx_layers))
    module = ONNModule.init(cfg, seed)
    return ONNModule.from_params(cfg, onn.project_approx(module.params, cfg))


def mesh_launches(programs) -> list:
    """Per ONN layer, (blocks, wires, depth) of each mesh_scan launch it
    makes: one for a Sigma_a U_a layer's stacked meshes, two (V^T, then
    U) for an SVD layer."""
    return [[(st.signs.shape[0] if st.signs.ndim > 1 else 1, st.dim,
              st.depth)
             for st in ([p.meshes] if hasattr(p, "meshes") else [p.v, p.u])]
            for p in programs]


def mesh_run(card: str, argv, steps: int, label: str = ""):
    """Records of ``steps`` steps of ``--fidelity mesh`` + argv, with each
    training kernel's launches and the mesh kernel's branches counted
    from 0 over the run; raises unless pam4 encodes and decodes once a
    bucket (decode aligned), every training kernel ran and onn_layer did
    not.  Returns (losses, step seconds, launches, branches)."""
    from repro_torch import configs
    from repro_torch.collectives.bucketizer import expected_buckets
    from repro_torch.kernels import mesh_scan, onn_layer
    from repro_torch.models import lm
    from repro_torch.tree import leaves

    cfg = configs.get("paper_llama")
    n_buckets = expected_buckets(4 * sum(
        math.prod(s) for s in leaves(lm.param_shapes(cfg))))
    counters = dict(_train_counters(), onn_layer=onn_layer.onn_layer,
                    mesh_scan_blocks=mesh_scan.mesh_scan_blocks)
    decode = counters["pam4_decode_dequantize"]
    blocks = mesh_scan.mesh_scan_blocks
    for fn in counters.values():
        fn.launches = 0
    decode.forms = dict.fromkeys(decode.forms, 0)
    blocks.branches = dict.fromkeys(blocks.branches, 0)
    recs = train_run(["--fidelity", "mesh"] + argv, steps)[0]
    launches = {name: fn.launches for name, fn in counters.items()}
    branches = dict(blocks.branches)
    print(f"  --fidelity mesh {' '.join(argv)}: pam4 decode forms "
          f"{decode.forms}; mesh_scan branches {branches}", flush=True)
    idle = [name for name, n in launches.items()
            if n == 0 and name not in ("onn_layer", "mesh_scan_blocks")]
    if (idle or launches["pam4_quantize_encode"] != n_buckets * steps
            or launches["pam4_decode_dequantize"] != n_buckets * steps
            or decode.forms["aligned"] != n_buckets * steps
            or launches["onn_layer"]):
        raise AssertionError(f"launches {launches} of {argv}: every "
                             f"training kernel, pam4 encode and decode "
                             f"once per bucket (decode aligned: "
                             f"{decode.forms}), no onn_layer")
    losses = [r["loss"] for r in recs]
    times = [r["time_s"] for r in recs]
    print(f"train paper_llama bf16 --sync optinc --fidelity mesh "
          f"{' '.join(argv)} --mesh 4x1{label}, {steps} steps: loss "
          f"{losses}; step times ms {[round(t * 1e3, 3) for t in times]}; "
          f"launches {launches} [{card}]", flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses: {losses}")
    return losses, times, launches, branches


def train_mesh_full_width(card: str, behavioral_bits2, behavioral8,
                          onn) -> tuple:
    """Phase 4c: the mesh fidelity at full width; returns the launch
    counts and the losses and step times of the bits-8 pallas run
    through the trained Table I row 1 ONN (phase 4d's pick)."""
    import torch
    from repro_torch import configs
    from repro_torch.collectives.bucketizer import expected_buckets
    from repro_torch.collectives.engine import SyncConfig
    from repro_torch.models import lm
    from repro_torch.photonics import PhotonicsConfig, runtime
    from repro_torch.tree import leaves

    cfg = configs.get("paper_llama")
    n_buckets = expected_buckets(4 * sum(
        math.prod(s) for s in leaves(lm.param_shapes(cfg))))
    losses, times, launches, _ = mesh_run(card, ["--bits", "2"], 10)
    print(f"  --fidelity mesh --bits 2: step p50 "
          f"{pct(times[3:], 0.5) * 1e3:.3f} ms p99 "
          f"{pct(times[3:], 0.99) * 1e3:.3f} ms over steps 3-9 [{card}]",
          flush=True)
    if losses != behavioral_bits2 or launches["mesh_scan_blocks"]:
        raise AssertionError(f"--fidelity mesh --bits 2: losses {losses} vs "
                             f"behavioral {behavioral_bits2}, "
                             f"{launches['mesh_scan_blocks']} mesh_scan "
                             f"launches (want equal losses and 0)")

    ph = PhotonicsConfig(fidelity="mesh")
    trained = onn["module"]
    label = f"trained {onn['label']} Table I row 1 (approx 1-6)"
    results = {}
    # the seeded default ONN (no approximated layer) is kept for its
    # timing: two SVD meshes a layer, up to 256 wires and 509 layers
    for what, module, backend, steps in (
            (label, trained, "pallas", 3),
            (label, trained, "xla", 1),
            ("seeded default (no approx)",
             seeded_onn(ph, (), SEED + 6), "pallas", 2)):
        t = time.perf_counter()
        launches_of = mesh_launches(module.programs)
        print(f"mesh ONN {what}: Givens programming "
              f"{time.perf_counter() - t:.3f} s on the host (0 if done "
              f"before); per layer, (blocks, wires, depth) of each launch "
              f"{launches_of} [{card}]", flush=True)
        per_bucket = sum(len(layer) for layer in launches_of)
        runtime.put_module(ph, 8, 4, module)
        torch.cuda.reset_peak_memory_stats()
        losses, times, launches, _ = mesh_run(
            card, ["--bits", "8", "--mesh-backend", backend], steps,
            f" ({what})")
        peak = torch.cuda.max_memory_allocated() / 1e9
        rest = times[1:] or times
        print(f"  {what}, --mesh-backend {backend}: first step "
              f"{times[0] * 1e3:.3f} ms, p50 of the rest "
              f"{pct(rest, 0.5) * 1e3:.3f} ms; peak memory {peak:.3f} GB; "
              f"phase 4 behavioral losses {behavioral8[:steps]} [{card}]",
              flush=True)
        want = per_bucket * n_buckets * steps
        if launches["mesh_scan_blocks"] != want:
            raise AssertionError(f"{what} {backend}: mesh_scan launches "
                                 f"{launches['mesh_scan_blocks']} (want "
                                 f"{want})")
        results[what, backend] = losses, times, launches
    pallas, xla = (results[label, b][0] for b in ("pallas", "xla"))
    share = codes_off_behavioral(trained, onn["codes"], "mesh", "pallas")
    print(f"  {label}: codes of one bucket (step 0, bucket 0) off "
          f"behavioral Q(mean) through the meshes {100 * share:.4f}%; max "
          f"|dloss| against phase 4 behavioral over 3 steps "
          f"{max(abs(a - b) for a, b in zip(pallas, behavioral8)):.5f} "
          f"[{card}]", flush=True)
    if xla[0] != pallas[0]:
        raise AssertionError(f"step-0 loss xla {xla[0]} != pallas "
                             f"{pallas[0]}")

    runtime.put_module(ph, 8, 4, trained)
    dev = profile_train_step(
        card, SyncConfig(mode="optinc", bits=8, block=2048,
                         photonics=PhotonicsConfig(fidelity="mesh",
                                                   mesh_backend="pallas")),
        f"train step --fidelity mesh --bits 8 ({label})")
    mesh_us = sum(us for k, us in dev.items() if "mesh_scan" in k)
    print(f"  mesh_scan: {mesh_us:.1f} us of the step's device time, "
          f"{100 * mesh_us / max(sum(dev.values()), 1e-9):.2f}% [{card}]",
          flush=True)
    losses, times, launches = results[label, "pallas"]
    return launches, losses, times


# ---------------------------------------------------- phase 4f: sessions
# phase 4's config through repro_torch.api, with error feedback on
SESSION_ARGS = ["--arch", "paper_llama", "--sync", "optinc", "--bits", "8",
                "--block", "2048", "--mesh", "4x1", "--global-batch", "32",
                "--seq-len", "512", "--error-feedback", "--ckpt-every", "5"]


def _session_spec(ckpt_dir, steps: int, *extra):
    from repro_torch.api import RunSpec
    return RunSpec.from_args(SESSION_ARGS + ["--ckpt-dir", str(ckpt_dir),
                                             "--steps", str(steps),
                                             *extra])


def _quiet_session(spec):
    """A TrainSession on the card that checkpoints every ckpt.every steps
    and prints nothing a step."""
    from repro_torch import api
    return api.TrainSession(spec, [api.PeriodicCheckpoint(spec.ckpt.every)],
                            device="cuda")


def _npz_bytes(direc, step: int) -> int:
    return (Path(direc) / f"step_{step}" / "arrays.npz").stat().st_size


def _serve_tokens(eng, prompts, new_tokens: int) -> list:
    """Each prompt's greedy tokens from ``eng``, drained in order."""
    rids = [eng.submit(p, new_tokens) for p in prompts]
    while eng.has_work():
        eng.step()
    return [eng.results[r] for r in rids]


def sessions_full_width(card: str, phase4_p50_ms=None) -> None:
    """Phase 4f: checkpoint, resume, ServeSession and hot reload of the
    full-width paper_llama run through ``repro_torch.api``, in a
    temporary checkpoint directory under build/ that is deleted after.

    (a) a TrainSession runs 10 steps of SESSION_ARGS (checkpoints at 4
    and 9); (b) a second directory runs 5, then a fresh TrainSession with
    --resume (and --sparse-residuals, so its checkpoints are block-sparse)
    must start at step 5 and give (a)'s losses for steps 5-9 bit for bit,
    launching the flash and pam4 kernels; the seconds of one save
    (waited on) and one load and the bytes of arrays.npz, dense and
    sparse; (c) a ServeSession with ckpt.resume serves (a)'s step-9
    checkpoint: generate on 8 seeded prompts x 32 new tokens must give
    the greedy tokens of a ServeEngine on the same parameters (prompts of
    8-128 tokens, powers of two, one at a time on both paths, so both pad
    and batch them alike: the bf16 results are the same bits) and launch
    flash and paged_attention; (d) a ServeEngine with reload_every=1
    serves from (b)'s directory while (b) trains step 10 and checkpoints
    it: the swap must be seen, and requests admitted after it must get a
    fresh engine's tokens on the step-10 parameters."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.api import RunSpec
    from repro_torch.kernels import attention, paged_attention
    from repro_torch.serving.engine import ServeEngine

    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="ckpt-4f-", dir=ROOT / "build"))
    counters = _train_counters()
    t_phase = time.perf_counter()
    try:
        t0 = time.perf_counter()
        sess_a = _quiet_session(_session_spec(root / "a", 10))
        recs_a = sess_a.run()
        times = [r["time_s"] for r in recs_a[1:]]
        print(f"4f (a) TrainSession paper_llama bf16, {' '.join(SESSION_ARGS)}"
              f": 10 steps in {time.perf_counter() - t0:.3f} s with its "
              f"construction, loss {recs_a[0]['loss']} -> "
              f"{recs_a[-1]['loss']}; step p50 {pct(times, 0.5) * 1e3:.3f} "
              f"ms p99 {pct(times, 0.99) * 1e3:.3f} ms over steps 1-9 "
              f"(phase 4, no error feedback: p50 "
              f"{'not run' if phase4_p50_ms is None else f'{phase4_p50_ms:.3f} ms'}"
              f"); step ms {[round(t * 1e3, 3) for t in times]} (a "
              f"background save runs over steps 5 on) [{card}]", flush=True)

        # (b) stop after 5 steps, resume in a fresh session
        _quiet_session(_session_spec(root / "b", 5)).run()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        sess_b = _quiet_session(_session_spec(root / "b", 11, "--resume",
                                              "--sparse-residuals"))
        resume_s = time.perf_counter() - t0
        if sess_b.step != 5:
            raise AssertionError(f"the resumed session starts at step "
                                 f"{sess_b.step}, not 5")
        sess_b.run(n_steps=5)
        launches = {name: fn.launches for name, fn in counters.items()}
        got = [sess_b.losses[s] for s in range(5, 10)]
        want = [sess_a.losses[s] for s in range(5, 10)]
        print(f"4f (b) resumed at step {min(sess_b.losses)}: losses 5-9 "
              f"{got}, uninterrupted {want}; launches in the resumed run "
              f"{launches} [{card}]", flush=True)
        if got != want:
            raise AssertionError(f"resumed losses {got} != uninterrupted "
                                 f"{want}")
        for name, n in launches.items():
            if n == 0:
                raise AssertionError(f"{name} was not launched by the "
                                     f"resumed run")

        # checkpoint costs: one save waited on, one load (the resume),
        # dense (a) and block-sparse (b)
        for label, sess, direc in (("dense", sess_a, root / "a"),
                                   ("sparse", sess_b, root / "b")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess.save_checkpoint(9)
            sess.mgr.wait()
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            _quiet_session(dataclasses.replace(
                sess.spec, ckpt=dataclasses.replace(sess.spec.ckpt,
                                                    resume=True)))
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            _quiet_session(dataclasses.replace(
                sess.spec, ckpt=dataclasses.replace(sess.spec.ckpt,
                                                    resume=False)))
            torch.cuda.synchronize()
            fresh_s = time.perf_counter() - t0
            print(f"4f checkpoint ({label} residuals) of step 9: save "
                  f"{save_s:.3f} s (waited on), arrays.npz "
                  f"{_npz_bytes(direc, 9)} bytes; a resuming TrainSession "
                  f"{load_s:.3f} s against a fresh one {fresh_s:.3f} s "
                  f"[{card}]", flush=True)
        print(f"4f the first resume (dense checkpoint of step 4) took "
              f"{resume_s:.3f} s [{card}]", flush=True)

        # (c) ServeSession from (a)'s step-9 checkpoint
        serve_args = ["--page-size", "16", "--max-active", "1",
                      "--max-seq", "256"]
        sspec = _session_spec(root / "a", 10, "--resume", *serve_args)
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, 32000, (int(n),)).tolist() for n in
                   rng.choice([8, 16, 32, 64, 128], size=8)]
        attention.flash_attention.launches = 0
        paged_attention.paged_attention.launches = 0
        t0 = time.perf_counter()
        serve = api.ServeSession(sspec, device="cuda")
        if serve.params_step != 9:
            raise AssertionError(f"ServeSession serves step "
                                 f"{serve.params_step}, not 9")
        tokens = [serve.generate(np.asarray([p]), 32, max_seq=256)[0]
                  .tolist() for p in prompts]
        gen_s = time.perf_counter() - t0
        slaunches = {"flash_attention": attention.flash_attention.launches,
                     "paged_attention":
                         paged_attention.paged_attention.launches}
        ref = _serve_tokens(ServeEngine.from_spec(sspec, params=serve.params,
                                                  device="cuda"), prompts, 32)
        same = sum(a == b for a, b in zip(tokens, ref))
        print(f"4f (c) ServeSession from checkpoint step 9: 8 prompts of "
              f"{[len(p) for p in prompts]} tokens x 32 in {gen_s:.3f} s "
              f"with its construction; launches {slaunches}; {same}/8 token "
              f"streams equal to the ServeEngine's [{card}]", flush=True)
        if same != 8:
            raise AssertionError(f"ServeSession tokens {tokens} != the "
                                 f"engine's {ref}")
        for name, n in slaunches.items():
            if n == 0:
                raise AssertionError(f"{name} was not launched by the "
                                     f"ServeSession")

        # (d) hot reload while (b) trains step 10
        hspec = _session_spec(root / "b", 11, "--resume", "--page-size",
                              "16", "--max-seq", "256", "--reload-every",
                              "1")
        eng = ServeEngine.from_spec(hspec, device="cuda")
        before = eng.params_step
        first = eng.submit(prompts[0], 32)
        for _ in range(4):
            eng.step()
        sess_b.run(n_steps=1)                 # step 10, checkpointed
        while eng.has_work():
            eng.step()
        if len(eng.results[first]) != 32:
            raise AssertionError("the request in flight over the swap did "
                                 "not finish")
        after = _serve_tokens(eng, prompts[1:5], 32)
        fresh = ServeEngine.from_spec(hspec, device="cuda")
        ref = _serve_tokens(fresh, prompts[1:5], 32)
        print(f"4f (d) hot reload: params step {before} -> "
              f"{eng.params_step} mid-serve (fresh engine: step "
              f"{fresh.params_step}); {sum(a == b for a, b in zip(after, ref))}"
              f"/4 post-swap token streams equal to the fresh engine's "
              f"[{card}]", flush=True)
        if (before, eng.params_step, fresh.params_step) != (9, 10, 10):
            raise AssertionError(f"hot reload saw steps {before} -> "
                                 f"{eng.params_step} (fresh "
                                 f"{fresh.params_step}), want 9 -> 10")
        if after != ref:
            raise AssertionError(f"post-swap tokens {after} != the fresh "
                                 f"engine's {ref}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"4f took {time.perf_counter() - t_phase:.3f} s [{card}]",
          flush=True)


# ------------------------------------------------- phase 4g: sync modes
# the Table-II hits of a step's draws lie within this many binomial
# standard deviations of p_error times the codes drawn
INJECT_SIGMAS = 5


def sync_modes_full_width(card: str, base=None) -> dict:
    """Phase 4g: every --sync mode of the JAX package on phase 4's config
    (paper_llama bf16, global batch 32 x 512).  ``base``: phase 4's
    {"optinc": its first 10 losses, "psum": its 10 psum losses}, run
    here when None.  Returns the runs' launch counts by label."""
    import torch
    from repro_torch.api.callbacks import Callback
    from repro_torch.collectives.bucketizer import expected_buckets
    from repro_torch.kernels import mesh_scan, onn_layer
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.photonics import error_model
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    spec = train.parse_args(TRAIN_ARGV).spec
    nb = expected_buckets(4 * sum(math.prod(s) for s in leaves(
        lm.param_shapes(spec.model_config()))), spec.sync.bucket_bytes)
    counters = dict(_train_counters(), onn_layer=onn_layer.onn_layer,
                    mesh_scan_blocks=mesh_scan.mesh_scan_blocks)
    if base is None:
        base = {"optinc": train_run([], 10)[1],
                "psum": train_run(["--sync", "psum"], 10)[1]}
    out = {}

    def run(label, argv, steps, ef=False, callbacks=()):
        gc.collect()                 # the earlier runs' tensors, for the peak
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        recs, losses = train_run(argv, steps, callbacks)
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        times = [r["time_s"] for r in recs[1:]]
        p50 = pct(times, 0.5) * 1e3
        peak = torch.cuda.max_memory_allocated() / 1e9
        print(f"4g {label} ({' '.join(argv)}): {steps} steps in {wall:.3f} "
              f"s, step p50 {p50:.3f} ms over steps 1-{steps - 1}, peak "
              f"memory {peak:.3f} GB; losses {losses}; launches {launches} "
              f"[{card}]", flush=True)
        want = (steps * nb, steps * nb * (2 if ef else 1))
        got = (launches["pam4_quantize_encode"],
               launches["pam4_decode_dequantize"])
        if "ring" not in label and got != want:
            raise AssertionError(f"{label}: pam4 encode/decode {got}, want "
                                 f"{want} (one encode and one decode a "
                                 f"bucket, two decodes with feedback)")
        for name in ("flash_attention", "flash_attention_bwd"):
            if launches[name] == 0:
                raise AssertionError(f"{label}: {name} was not launched")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{label}: non-finite losses {losses}")
        out[label] = launches
        return losses, launches, p50

    # the ring, the paper's baseline, beside psum.  The two sum each f32
    # gradient in another order, but the last-bit differences do not reach
    # the bf16 weights: the losses are psum's bit for bit (every run on
    # the H100 so far), which a ring that gets 1/N or a chunk wrong would
    # break.  Phase 5 holds the ring's own f32 arithmetic against the
    # CPU plain path bit for bit, and the CPU tests against JAX.
    ring, launches, ring_p50 = run("ring", ["--sync", "ring"], 10)
    err = max(abs(a - b) for a, b in zip(ring, base["psum"]))
    print(f"4g ring vs psum losses: max_abs_err {err:.3e}, bit-equal "
          f"{ring == base['psum']}", flush=True)
    if ring != base["psum"] or launches["pam4_quantize_encode"]:
        raise AssertionError("4g: the ring's losses are not psum's, or it "
                             "ran a pam4 kernel")

    # the behavioral cascade over 2 pods of 2: optinc over 4, bit for bit
    casc, _, _ = run("cascade pods 2", ["--sync", "cascade", "--pods", "2",
                                        "--mesh", "2x1"], 10)
    print(f"4g cascade --pods 2 --mesh 2x1 losses bit-equal to phase 4's "
          f"optinc --mesh 4x1: {casc == base['optinc']}", flush=True)
    if casc != base["optinc"]:
        raise AssertionError("4g: the cascade's losses are not optinc's")

    # the paper's 16-server scenario: 4 pods of 4, 2 rows a peer
    c16, _, c16_p50 = run("cascade pods 4", ["--sync", "cascade", "--pods",
                                             "4", "--mesh", "4x1"], 5)
    if not c16[-1] < c16[0]:
        raise AssertionError(f"4g: the 16-peer cascade's loss did not fall: "
                             f"{c16}")

    # the photonic cascade at bits 2 (exact identity ONN at both levels)
    pods2 = ["--sync", "cascade", "--pods", "2", "--mesh", "2x1", "--bits",
             "2"]
    beh2, _, _ = run("cascade bits 2", pods2, 10)
    for fid in ("onn", "mesh"):
        got, launches, _ = run(f"cascade {fid} bits 2",
                               pods2 + ["--fidelity", fid], 10)
        want_onn = 4 * nb * 10 if fid == "onn" else 0
        print(f"4g cascade --fidelity {fid} --bits 2: losses bit-equal to "
              f"behavioral {got == beh2}; onn_layer {launches['onn_layer']} "
              f"(want {want_onn}), mesh_scan_blocks "
              f"{launches['mesh_scan_blocks']} (want 0)", flush=True)
        if (got != beh2 or launches["onn_layer"] != want_onn
                or launches["mesh_scan_blocks"]):
            raise AssertionError(f"4g: the photonic cascade at {fid}")

    # Table II row (3, 4, 5, 6) injected into the averaged codes
    tally = {"hits": 0, "drawn": 0, "codes": 0, "changed": 0}
    inject_with = error_model.inject_with

    def counting(u_avg, hit, which, spec, bits):
        got = inject_with(u_avg, hit, which, spec, bits)
        tally["hits"] += int(hit.sum())
        tally["drawn"] += hit.numel()
        tally["codes"] += int(hit.sum()) * u_avg.shape[0]
        tally["changed"] += int((got != u_avg).sum())
        return got

    inj_argv = ["--error-layers", "3,4,5,6"]
    error_model.inject_with = counting
    try:
        inj, _, inj_p50 = run("injection", inj_argv, 10)
        per_step = {k: v / 10 for k, v in tally.items()}
        inj2, _, _ = run("injection again", inj_argv, 10)
    finally:
        error_model.inject_with = inject_with
    p = error_model.TABLE_II[(3, 4, 5, 6)].p_error
    mean = p * per_step["drawn"] * 10
    sd = (per_step["drawn"] * 10 * p * (1 - p)) ** 0.5
    hits = per_step["hits"] * 10
    err = max(abs(a - b) for a, b in zip(inj, base["optinc"]))
    print(f"4g injection (Table II (3, 4, 5, 6), p_error {p:.7f}): "
          f"{per_step['hits']:.1f} hits a step in {per_step['drawn']:.0f} "
          f"codes drawn (one draw of a quarter bucket for its 4 shards), "
          f"{per_step['codes']:.1f} codes injected a step of "
          f"{4 * per_step['drawn']:.0f}, {per_step['changed']:.1f} changed "
          f"after the clip; 10 steps: {hits:.0f} hits against "
          f"{mean:.1f} +- {INJECT_SIGMAS} x {sd:.1f}; losses beside phase "
          f"4's: max_abs_diff {err:.3e}; the same seed again gives the same "
          f"losses {inj == inj2}", flush=True)
    if abs(hits - mean) > INJECT_SIGMAS * sd or inj != inj2 or hits == 0:
        raise AssertionError("4g: Table-II injection")

    # streaming overlap against the barrier path, error feedback on
    class Early(Callback):
        def __init__(self):
            self.early, self.order = [], None

        def on_step_end(self, session, record):
            stream = session._step_fn.last_stream
            self.early.append(stream.early)
            self.order = list(stream.order)

    # in turns (barrier, overlap, overlap, barrier), so both see the host
    # alike
    runs, early = {}, Early()
    for label in ("barrier", "overlap", "overlap again", "barrier again"):
        over = label.startswith("overlap")
        runs[label] = run(label, ["--error-feedback"]
                          + (["--overlap"] if over else []), 10, ef=True,
                          callbacks=[early] if over else [])
    bar, _, bar_p50 = runs["barrier"]
    ovl, _, ovl_p50 = runs["overlap"]
    same = all(r[0] == bar for r in runs.values())
    print(f"4g overlap: losses of all four runs bit-equal {same}; buckets "
          f"launched before the last peer's backward ended, per step "
          f"{early.early} of {nb}; the last step's launch order "
          f"{early.order}; step p50 (ms) barrier "
          f"{runs['barrier'][2]:.3f}, overlap {runs['overlap'][2]:.3f}, "
          f"overlap {runs['overlap again'][2]:.3f}, barrier "
          f"{runs['barrier again'][2]:.3f} [{card}]", flush=True)
    if not same or min(early.early) <= 0:
        raise AssertionError("4g: overlap")
    print(f"4g step p50 (ms): ring {ring_p50:.3f}, 16-peer cascade "
          f"{c16_p50:.3f}, injection {inj_p50:.3f}, barrier+feedback "
          f"{bar_p50:.3f}, overlap+feedback {ovl_p50:.3f}; phase 4g took "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return out


def sync_modes_alone(card: str) -> None:
    """Phase 4g alone, the kernels built first."""
    from repro_torch.kernels import _build
    _build.build()
    sync_modes_full_width(card)


# ----------------------------------------- phase 4h: peers as processes
# 4 ranks, one a card, each mode against the stacked 4-peer run of the
# same spec on one card (argv over TRAIN_ARGV)
PROC_MODES = {
    "optinc bits 8 + feedback": ["--error-feedback"],
    "ring": ["--sync", "ring"],
    "cascade pods 2": ["--sync", "cascade", "--pods", "2", "--mesh", "2x1"],
    "onn bits 2": ["--bits", "2", "--fidelity", "onn"],
    "overlap + feedback": ["--overlap", "--error-feedback"],
    "psum": ["--sync", "psum"],
}
PROC_STEPS = 10
PROC_TIMEOUT_S = 600
# psum over NCCL against the stacked f32 sum, elementwise: two orders of
# an f32 sum of N values differ by at most 2 (N - 1) u sum|x_i| and the
# division by N rounds once; in units of spacing(sum|x_i| / N) that is
# 2N - 1 = 7 at N = 4
PSUM_ULPS = 7


def torchrun(nproc: int, args, timeout: int = PROC_TIMEOUT_S):
    """``python -m torch.distributed.run --standalone`` with ``nproc``
    ranks on ``args`` (a module run with ``-m`` or this script), from the
    checkout; its process group is killed if it outlives ``timeout``.
    Returns (returncode, stdout, stderr, seconds)."""
    import os
    import signal
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), *args]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        err += f"\n[killed after {timeout} s]"
    return proc.returncode, out, err, time.perf_counter() - t0


def process_run(nproc: int, argv, steps: int | None = None):
    """``steps`` steps of the training entry point on TRAIN_ARGV + argv
    as ``nproc`` processes: rank 0's step records and its rank report
    (each rank's device, collective bytes and kernel launches; the whole
    losses)."""
    steps = PROC_STEPS if steps is None else steps
    rc, out, err, wall = torchrun(nproc, [
        "-m", "repro_torch.launch.train", *TRAIN_ARGV, *argv,
        "--steps", str(steps)])
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    if rc != 0 or not lines:
        raise AssertionError(f"torchrun {nproc} x {' '.join(argv)}: exit "
                             f"{rc}\n{out[-3000:]}\n{err[-6000:]}")
    recs = [x for x in lines if "step" in x]
    [report] = [x for x in lines if "ranks" in x]
    if [r["step"] for r in recs] != list(range(steps)):
        raise AssertionError(f"rank 0 printed steps {recs}")
    return recs, report, wall


def step_stats(recs, tokens: int = 32 * 512) -> str:
    times = [r["time_s"] for r in recs[1:]]
    p50 = pct(times, 0.5)
    return (f"p50 {p50 * 1e3:.3f} ms p99 {pct(times, 0.99) * 1e3:.3f} ms, "
            f"{tokens / p50:.1f} tokens/s")


def wire_codes(spec) -> int:
    """The B-bit codes one step's buckets carry (``bucket_codes`` of the
    spec's layout)."""
    from repro_torch.collectives.bucketizer import make_layout
    from repro_torch.models import lm
    from repro_torch.tree import leaves
    cfg = spec.model_config()
    layout = make_layout([(s, lm.torch_dtype(cfg)) for s in leaves(
        lm.param_shapes(cfg))], spec.sync.bucket_bytes)
    return bucket_codes(layout.bounds, spec.mesh.peers, spec.sync.block)


def check_process_wire(label: str, spec, report, steps: int) -> None:
    """Per rank and step, the bytes handed to each collective beside the
    modeled optical bytes; for optinc at bits 8 over 4 ranks, 2 bytes a
    code into the reduce-scatter (16-bit lanes) and 1 byte a code out of
    the all-gather (uint8)."""
    from repro_torch.api import build
    ranks = report["ranks"]
    per_step = [{k: v / steps for k, v in r["collective_bytes"].items()}
                for r in ranks]
    modeled = build.modeled_bytes_on_wire(spec)
    print(f"4h {label}: bytes a rank hands each collective a step "
          f"{per_step[0]} (all {len(ranks)} ranks alike "
          f"{all(p == per_step[0] for p in per_step)}); bytes_on_wire "
          f"(modeled optical) {modeled:.0f}", flush=True)
    if any(p != per_step[0] for p in per_step):
        raise AssertionError(f"4h {label}: the ranks sent different bytes")
    if spec.sync.mode == "optinc" and spec.sync.bits == 8:
        codes = wire_codes(spec)
        got = (per_step[0]["psum_scatter:int32"],
               per_step[0]["all_gather:uint8"])
        print(f"4h {label}: {codes} codes a step; reduce-scatter "
              f"{got[0] / codes:.4f} B a code, all-gather "
              f"{got[1] / codes:.4f} B a code", flush=True)
        if got != (2 * codes, codes):
            raise AssertionError(f"4h {label}: wire bytes {got}, want "
                                 f"{(2 * codes, codes)}")


def check_process_launches(label: str, spec, report, steps: int) -> None:
    """Each rank ran its own peer: one flash forward and backward a layer
    a step, and (optinc and cascade) one pam4 encode a bucket."""
    from repro_torch.collectives.bucketizer import expected_buckets
    from repro_torch.models import lm
    from repro_torch.tree import leaves
    cfg = spec.model_config()
    nb = expected_buckets(4 * sum(math.prod(s) for s in leaves(
        lm.param_shapes(cfg))), spec.sync.bucket_bytes)
    for r in report["ranks"]:
        got = r["launches"]
        print(f"4h {label}: rank {r['rank']} on {r['device']} launched "
              f"{ {k: v for k, v in got.items() if v} }", flush=True)
        want = {"flash_attention": steps * cfg.n_layers,
                "flash_attention_bwd": steps * cfg.n_layers}
        if spec.sync.mode in ("optinc", "cascade"):
            want["pam4_quantize_encode"] = steps * nb
        if spec.sync.photonics.fidelity == "onn":
            want["onn_layer"] = 2 * steps * nb
        bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
        if bad or r["device"] != f"cuda:{r['rank']}":
            raise AssertionError(f"4h {label}: rank {r['rank']} on "
                                 f"{r['device']}: launches (got, want) {bad}")


def psum_grads_rank(out_path: str) -> None:
    """One rank of the psum gradient check (run under torchrun by phase
    4h): this rank's first-step gradient row of the 4-peer config synced
    by the process psum (NCCL's all-reduce), and on rank 0 the same four
    rows synced by the stacked psum; rank 0 writes both and each
    element's bound to ``out_path``."""
    import torch
    from repro_torch.api import TrainSession
    from repro_torch.collectives.bucketizer import make_layout
    from repro_torch.collectives.engine import get_backend, sync_flat
    from repro_torch.launch import distributed, steps, train
    from repro_torch.models import lm
    from repro_torch.tree import leaves
    opts = train.parse_args(TRAIN_ARGV + ["--sync", "psum", "--steps", "1"])
    sess = TrainSession(opts.spec, callbacks=[], device=opts.device)
    world, n = sess.world, sess.peers
    layout = make_layout([(s, lm.torch_dtype(sess.cfg)) for s in leaves(
        lm.param_shapes(sess.cfg))], sess.sync.bucket_bytes)
    tokens = torch.from_numpy(sess.data.batch(0)).to(sess.device)
    per = tokens.shape[0] // n
    _, row = steps.peer_grad_stack(
        sess.cfg, sess.params, tokens[world.rank * per:(world.rank + 1) * per],
        1, layout.total)
    synced, _ = sync_flat(row, layout.bounds, sess.sync, world=world)
    rows = world.gather_rows(row)
    if world.rank == 0:
        backend = get_backend("psum")
        want = torch.cat([backend.sync(rows[:, s:e], sess.sync)[0]
                          for s, e in layout.bounds])
        mag = rows.abs().sum(0) / n
        bound = PSUM_ULPS * (torch.nextafter(mag, torch.full_like(
            mag, math.inf)) - mag)
        torch.save({"process": synced.cpu(), "stacked": want.cpu(),
                    "bound": bound.cpu()}, out_path)
    distributed.shutdown()
    distributed.exit_rank(0)


def processes_full_width(card: str) -> None:
    """Phase 4h: the data-parallel peers as processes, one a card,
    launched through ``torch.distributed.run -m repro_torch.launch.train``
    (NCCL), each run against the stacked run of the same spec on one
    card.  A world of one always; 4 ranks when the machine has 4 cards."""
    import torch
    from repro_torch.launch import train

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    one = ["--mesh", "1x1", "--error-feedback"]
    _, stacked = train_run(one, PROC_STEPS)
    srecs = train_run(one, PROC_STEPS)[0]
    recs, report, wall = process_run(1, one)
    print(f"4h world of one (NCCL, --mesh 1x1 --error-feedback, "
          f"{PROC_STEPS} steps, {wall:.1f} s of torchrun): losses bit-equal "
          f"to the stacked 1-peer run {report['losses'] == stacked}; "
          f"process {step_stats(recs)}, stacked {step_stats(srecs)} "
          f"[{card}]", flush=True)
    if report["losses"] != stacked:
        raise AssertionError(f"4h world of one: {report['losses']} vs "
                             f"stacked {stacked}")
    check_process_launches("world of one", train.parse_args(
        TRAIN_ARGV + one).spec, report, PROC_STEPS)
    cards = torch.cuda.device_count()
    if cards < 4:
        print(f"4h: the 4-rank runs need 4 cards; this machine has {cards} "
              f"(on a 4-card host, processes_alone runs them) [{card}]",
              flush=True)
        print(f"phase 4h took {time.perf_counter() - t_phase:.1f} s "
              f"[{card}]", flush=True)
        return
    for label, argv in PROC_MODES.items():
        gc.collect()
        torch.cuda.empty_cache()
        srecs, stacked = train_run(argv, PROC_STEPS)
        recs, report, wall = process_run(4, argv)
        same = report["losses"] == stacked
        err = max(abs(a - b) for a, b in zip(report["losses"], stacked))
        print(f"4h {label} ({' '.join(argv)}), 4 ranks vs 4 stacked peers, "
              f"{PROC_STEPS} steps ({wall:.1f} s of torchrun): losses "
              f"bit-equal {same}, max_abs_diff {err:.3e}; process "
              f"{step_stats(recs)}; stacked {step_stats(srecs)} [{card}]",
              flush=True)
        spec = train.parse_args(TRAIN_ARGV + argv).spec
        check_process_wire(label, spec, report, PROC_STEPS)
        check_process_launches(label, spec, report, PROC_STEPS)
        if label != "psum" and not same:
            raise AssertionError(f"4h {label}: {report['losses']} vs "
                                 f"stacked {stacked}")
    out = ROOT / "build" / "psum_grads.pt"
    rc, o, e, _ = torchrun(4, [str(ROOT / "chip_smoke.py"), "--psum-grads",
                               str(out)])
    if rc != 0:
        raise AssertionError(f"4h psum gradients: exit {rc}\n{e[-6000:]}")
    got = torch.load(out)
    out.unlink()
    check_psum_grads("4h", got, card)
    print(f"phase 4h took {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)


def processes_alone(card: str) -> None:
    """Phase 4h alone, the kernels built first."""
    from repro_torch.kernels import _build
    _build.build()
    processes_full_width(card)


# --------------------------- phase 4i: FSDP, tensor parallelism, remat
# deepseek_coder_33b at its published widths, depth cut (one card: 2
# layers; 4 cards: 8), one sequence of 4096 tokens a data peer.  lr 1e-5:
# at the CLI's 3e-4 (paper_llama's) AdamW's first, sign-like step moves
# each of the 7168 or 19200 inputs of an output by lr and the loss went
# 11.821 -> 22.602 at step 1 (NVIDIA H100 80GB HBM3, 700 W)
DSC_ARGV = ["--arch", "deepseek_coder_33b", "--sync", "optinc", "--bits",
            "8", "--fsdp", "--remat-groups", "2", "--seq-len", "4096",
            "--lr", "1e-5", "--device", "cuda"]
DSC_STEPS = 5
DSC_LAYERS = 1         # the one-card world of one
SHARD_STEPS = 3        # the one-card paper_llama checks
TP_STEPS = 10          # (b): paper_llama --mesh 2x2
# (b) bf16: the step-0 loss at tp 2 against the stacked dp 2 run (the
# vocab-sharded log-sum-exp and the row-parallel psums add in another
# order; the loss is O(10)), and each model-sharded leaf's local
# gradient against 2 x its tp-1 shard, relative to the leaf's largest
# entry (bf16 products rounded at other points of the sums).  Set from
# the H100 readings (loss 4.96e-5, gradients 7.25e-3; PERF.md section 2)
# with room on each side; the step-0 loss is about ln(vocab) + 0.05, so
# a forward that loses a 'model' psum moves it by far less than 1e-2
TP_LOSS_TOL = 1e-3
TP_GRAD_RTOL = 2e-2
# The flash forward at a 4096-long row, each (head, row) against its own
# scale: a late row's outputs average thousands of values (|o| ~ 0.03),
# so an absolute bound at the bf16 spacing of O(1) outputs would be as
# large as they are.  max |o - ref| over a row <= FLASH_ROW_TOL * max
# |ref| over it (one bf16 spacing at a row's largest value is 2^-8 to
# 2^-7 of it; each side rounds once, and the kernel rounds P to bf16 for
# the PV product), and mean |o - ref| <= FLASH_MEAN_TOL * mean |ref|,
# beside the absolute KERNEL_TOL bound of every bf16 case
FLASH_ROW_TOL = 2 ** -6
FLASH_MEAN_TOL = 2 ** -8


def train_layers_rank(layers: int, argv) -> None:
    """One rank of a phase-4i or 4k run (under torchrun): the training
    entry point's session on ``argv`` with the model's depth cut to
    ``layers``; rank 0 prints the step lines and the rank report, and
    for a MoE model first a line {"loss0", "aux0"}: step 0's loss and
    summed aux loss on its peer's rows, a forward of the seeded weights
    before the run (collective: every rank runs it; the report's launch
    counts and peak memory start after it)."""
    import torch
    from repro_torch.api import TrainSession
    from repro_torch.api.callbacks import default_callbacks
    from repro_torch.launch import distributed, train
    from repro_torch.models import lm
    opts = train.parse_args(argv)
    cfg = dataclasses.replace(opts.spec.model_config(), n_layers=layers)
    session = TrainSession(opts.spec, default_callbacks(opts.spec),
                           device=opts.device, cfg=cfg)
    if cfg.moe:
        tokens = torch.from_numpy(session.data.batch(0))
        per = tokens.shape[0] // session.peers
        pod, d, _ = session.world.coords
        p = pod * session.ctx.dp + d
        rows = tokens[p * per:(p + 1) * per].to(session.device)
        args = (session.ctx, session.world)
        with torch.no_grad():
            loss, _ = lm.loss_fn(cfg, session.params, {"tokens": rows}, *args)
            aux = lm.forward_lm(cfg, session.params, rows[:, :-1], *args)[1]
        if session.rank == 0:
            print(json.dumps({"loss0": loss.item(), "aux0": aux.item()}),
                  flush=True)
    session.run()
    session.close()
    distributed.exit_rank(0)


def layers_run(nproc: int, layers: int, argv, steps: int):
    """``steps`` steps of ``argv`` with ``layers`` layers as ``nproc``
    processes (``train_layers_rank``): rank 0's records and report."""
    rc, out, err, wall = torchrun(nproc, [
        str(ROOT / "chip_smoke.py"), "--train-layers", str(layers), *argv,
        "--steps", str(steps)], timeout=900)
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    recs = [x for x in lines if "step" in x]
    reports = [x for x in lines if "ranks" in x]
    if rc != 0 or not reports or [r["step"] for r in recs] != list(
            range(steps)):
        raise AssertionError(f"torchrun {nproc} x {layers} layers "
                             f"{' '.join(argv)}: exit {rc}\n{out[-3000:]}"
                             f"\n{err[-6000:]}")
    report = reports[0]
    for x in lines:
        if "aux0" in x:
            report.update(x)
    return recs, report, wall


def derived_shard_bytes(cfg, ctx, b: int, t: int, layer_runs: float) -> dict:
    """The bytes a rank hands each collective of the model in one step,
    from the shapes ("axis/op:dtype"): the FSDP all-gathers of every
    forward run of a layer (``layer_runs`` layer forwards a step, remat
    recomputes included) plus the embedding and head once, their
    reduce-scatters once; the 'model' psums of the attention and MLP
    outputs (b, t, d) a layer forward and again a backward, and of the
    embedding; the loss's two (b, t) f32 psums both ways, its (b, t)
    pmax, and the clip's scalar."""
    from repro_torch.models import lm
    from repro_torch.tree import leaves_with_paths
    dt = str(lm.torch_dtype(cfg)).removeprefix("torch.")
    e = 2 if dt == "bfloat16" else 4
    out = {}
    if ctx.fsdp and ctx.dp > 1:
        local = dict(leaves_with_paths(lm.local_param_shapes(cfg, ctx)))
        masks = lm.fsdp_leaves(cfg, ctx)
        once = layer = 0
        for (path, shp), m in zip(local.items(), masks):
            if not m:
                continue
            n = math.prod(shp) * ctx.dp * e
            if len(path) == 2:          # a stacked per-layer leaf
                layer += n // shp[0]
            else:
                once += n
        out[f"data/all_gather:{dt}"] = once + layer * layer_runs
        out[f"data/psum_scatter:{dt}"] = once + layer * cfg.n_layers
    if ctx.tp > 1:
        act = b * t * cfg.d_model * e
        out[f"model/psum:{dt}"] = act * (2 * layer_runs + 2 * cfg.n_layers
                                         + 2)
        out["model/psum:float32"] = 16 * b * t + 4
        out["model/pmax:float32"] = 4 * b * t
        if cfg.moe:     # the router's f32 logits (b t, E) joined over 'model'
            logits = 4 * b * t * cfg.n_experts
            out["model/all_gather:float32"] = logits * layer_runs
            out["model/psum_scatter:float32"] = logits * cfg.n_layers
    return out


def check_shard_bytes(label: str, cfg, spec, report, steps: int,
                      layer_runs: float, card: str) -> None:
    """Per rank and step, the bytes handed to each collective by axis, op
    and dtype beside ``derived_shard_bytes``; the derived ones must
    match."""
    ctx = spec.mesh.ctx()
    b = spec.data.global_batch // spec.mesh.peers
    want = derived_shard_bytes(cfg, ctx, b, spec.data.seq_len, layer_runs)
    for r in report["ranks"]:
        got = {k: v / steps for k, v in r["axis_bytes"].items()}
        print(f"{label}: rank {r['rank']} bytes a step by axis/op:dtype "
              f"{got}; derived from the shapes {want} [{card}]", flush=True)
        bad = {k: (got.get(k), v) for k, v in want.items()
               if got.get(k) != v}
        if bad:
            raise AssertionError(f"{label}: rank {r['rank']} bytes "
                                 f"(measured, derived) {bad}")


def tp_grads_rank(out_dir: str) -> None:
    """One rank of phase 4i (b)'s gradient check (paper_llama --mesh 2x2
    under torchrun): its local step-0 gradients before the sync; rank 0
    also the tp-1 gradients of each data peer's rows on the whole
    weights.  Each written to ``out_dir``."""
    import torch
    from repro_torch.api import TrainSession
    from repro_torch.launch import distributed, train
    from repro_torch.models import lm
    from repro_torch.tree import leaves, unflatten
    opts = train.parse_args(TRAIN_ARGV + ["--mesh", "2x2", "--steps", "1"])
    sess = TrainSession(opts.spec, callbacks=[], device=opts.device)
    world, ctx = sess.world, sess.ctx
    tokens = torch.from_numpy(sess.data.batch(0)).to(sess.device)
    per = tokens.shape[0] // sess.peers
    _, d, _ = world.coords
    rows = lambda p: {"tokens": tokens[p * per:(p + 1) * per]}
    train_ = [t.detach().requires_grad_() for t in leaves(sess.params)]
    loss, _ = lm.loss_fn(sess.cfg, unflatten(sess.params, train_),
                         rows(d), ctx, world)
    grads = torch.autograd.grad(loss, train_)
    torch.save([g.cpu() for g in grads], Path(out_dir) / f"r{world.rank}.pt")
    if world.rank == 0:
        whole = lm.init_params(sess.cfg, opts.spec.seed, sess.device)
        one = []
        for p in range(sess.peers):
            ps = [t.detach().requires_grad_() for t in leaves(whole)]
            loss1, _ = lm.loss_fn(sess.cfg, unflatten(whole, ps), rows(p))
            one.append([g.cpu() for g in torch.autograd.grad(loss1, ps)])
        torch.save(one, Path(out_dir) / "tp1.pt")
    distributed.shutdown()
    distributed.exit_rank(0)


def check_tp_grads(card: str) -> None:
    """(b)'s property of the reference: every model-sharded leaf's local
    pre-sync gradient is 2 x the tp-1 gradient's shard (JAX transposes
    psum into psum under check_vma=False)."""
    import shutil
    import torch
    from repro_torch.launch import train
    from repro_torch.models import lm
    out = ROOT / "build" / "tp_grads"
    out.mkdir(parents=True, exist_ok=True)
    rc, o, e, _ = torchrun(4, [str(ROOT / "chip_smoke.py"), "--tp-grads",
                               str(out)])
    if rc != 0:
        raise AssertionError(f"4i tp gradients: exit {rc}\n{e[-6000:]}")
    spec = train.parse_args(TRAIN_ARGV + ["--mesh", "2x2"]).spec
    cfg, ctx = spec.model_config(), spec.mesh.ctx()
    one = torch.load(out / "tp1.pt")
    specs = lm.spec_leaves(cfg, ctx)
    worst = 0.0
    for r in range(4):
        got = torch.load(out / f"r{r}.pt")
        pod, d, m = r // 4, r // 2 % 2, r % 2
        for i, sp in enumerate(specs):
            if "model" not in sp:
                continue
            want = 2 * lm.shard_leaf(one[d][i].float(), sp, ctx, (pod, 0, m))
            rel = float((got[i].float() - want).abs().max()
                        / want.abs().max())
            worst = max(worst, rel)
    shutil.rmtree(out)
    print(f"4i (b) model-sharded leaves' step-0 local gradients at tp 2 "
          f"against 2 x the tp-1 shards, 4 ranks: max |diff| / max|grad| "
          f"{worst:.3e} (tol {TP_GRAD_RTOL}) [{card}]", flush=True)
    if not worst <= TP_GRAD_RTOL:
        raise AssertionError(f"4i (b) tp gradients: {worst}")


def row_and_mean_errs(o, want) -> tuple:
    """(max over (head, row) of max |o - want| / max |want| on the row,
    mean |o - want| / mean |want|): the forward's readings against
    FLASH_ROW_TOL and FLASH_MEAN_TOL."""
    err, mag = (o.float() - want.float()).abs(), want.float().abs()
    return ((err.amax(-1) / mag.amax(-1).clamp_min(1e-30)).max().item(),
            (err.mean() / mag.mean()).item())


def flash_dropped_tile(q, k, v, rows_from: int, keys: tuple):
    """The plain forward with keys [keys[0], keys[1]) left out of every
    row from ``rows_from`` on: what a kernel that skips or misplaces one
    KV tile of the long rows would give."""
    import torch
    from repro_torch.kernels import ref
    s, _ = ref._masked_scores(q, k, True)
    s[..., rows_from:, keys[0]:keys[1]] = ref.NEG_INF
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float()) / p.sum(
        dim=-1, keepdim=True)
    return out.reshape(q.shape).to(q.dtype)


def check_flash_hd128(card: str) -> dict:
    """The flash forward and backward at deepseek_coder_33b's shape (56
    heads, 8 KV heads, hd 128, one sequence of 4096, bf16) against their
    plain versions, timed beside SDPA (GQA) and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import attention, ref
    shape = (1, 56, 8, 128, 4096, 4096, torch.bfloat16)
    q, k, v = flash_case(*shape, SEED)
    g = torch.Generator().manual_seed(SEED + 1)
    do = torch.randn((1, 56, 4096, 128), generator=g).bfloat16().cuda()
    o, lse = attention.flash_attention(q, k, v, return_lse=True)
    wo, wl = ref.attention_fwd_ref(q, k, v)
    f_err = (o.float() - wo.float()).abs().max().item()
    f_row, f_mean = row_and_mean_errs(o, wo)
    # two planted faults through the plain version: the limits must
    # tell them from the kernel
    faults = [row_and_mean_errs(flash_dropped_tile(q, k, v, r0, ks), wo)
              for r0, ks in ((3000, (1024, 1088)), (4032, (3968, 4032)))]
    l_err = (lse - wl).abs().max().item()
    got = attention.flash_attention_bwd(q, k, v, o, lse, do)
    want = ref.attention_bwd_ref(q, k, v, o, lse, do)
    rel = max(((a.float() - w.float()).abs().max() / w.float().abs().max())
              .item() for a, w in zip(got, want))
    del wo, wl, want
    torch.cuda.synchronize()
    ins = copies_for([q, k, v, o, lse, do])
    fwd = time_ms(lambda q, k, v, *_: attention.flash_attention(
        q, k, v, return_lse=True), ins, iters=20)[0]
    fwd_plain = time_ms(lambda q, k, v, *_: ref.attention_fwd_ref(q, k, v),
                        ins, iters=3)[0]
    sdpa = time_ms(lambda q, k, v, *_: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), ins, iters=20)[0]
    bwd = time_ms(attention.flash_attention_bwd, ins, iters=20)[0]
    bwd_plain = time_ms(ref.attention_bwd_ref, ins, iters=3)[0]
    sdpa_bwd = sdpa_bwd_ms(ins, gqa=True)
    f_bound, b_bound = flash_bounds(*shape, True), flash_bwd_bounds(*shape)
    print(f"4i flash at deepseek_coder_33b's shape b=1 h=56 hkv=8 hd=128 "
          f"t=4096 bf16: forward max over rows of max|err| / max|ref| "
          f"{f_row:.3e} (tol {FLASH_ROW_TOL:.3e}), mean|err| / mean|ref| "
          f"{f_mean:.3e} (tol {FLASH_MEAN_TOL:.3e}), max_abs_err "
          f"{f_err:.3e} (tol {KERNEL_TOL['bfloat16']}) (planted: keys 1024-1087 left out of rows >= "
          f"3000 read {faults[0][0]:.3e} / {faults[0][1]:.3e}, keys "
          f"3968-4031 out of rows >= 4032 {faults[1][0]:.3e} / "
          f"{faults[1][1]:.3e}), lse {l_err:.3e}, {fwd:.3f} ms "
          f"(plain {fwd_plain:.3f} ms, sdpa {sdpa:.3f} ms, bound "
          f"{f_bound[0]:.3f} ms {f_bound[1]}); backward max_abs_err / "
          f"max|grad| {rel:.3e} (tol {BWD_TOL['bfloat16']}), {bwd:.3f} ms "
          f"(plain {bwd_plain:.3f} ms, sdpa backward (GQA) {sdpa_bwd:.3f} "
          f"ms, bound {b_bound[0]:.3f} ms {b_bound[1]}) [{card}]",
          flush=True)
    if not (f_err <= KERNEL_TOL["bfloat16"]
            and f_row <= FLASH_ROW_TOL and f_mean <= FLASH_MEAN_TOL
            and all(r > FLASH_ROW_TOL for r, _ in faults)
            and l_err <= KERNEL_TOL["float32"]
            and rel <= BWD_TOL["bfloat16"]):
        raise AssertionError(f"4i flash hd 128: {f_row}, {f_mean}, {l_err}, "
                             f"{rel}, planted {faults}")
    return {"fwd_ms": fwd, "bwd_ms": bwd, "sdpa_bwd_ms": sdpa_bwd}


def dsc_stats(recs, report, tokens: int) -> str:
    times = [r["time_s"] for r in recs[1:]]
    p50 = pct(times, 0.5)
    peak = max(r["peak_bytes"] for r in report["ranks"])
    return (f"losses {report['losses']}; step p50 {p50 * 1e3:.1f} ms p99 "
            f"{pct(times, 0.99) * 1e3:.1f} ms, {tokens / p50:.1f} tokens/s; "
            f"peak memory a rank {[r['peak_bytes'] for r in report['ranks']]}"
            f" bytes (max {peak / 2 ** 30:.2f} GiB)")


def check_falling(label: str, losses) -> None:
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"4i {label}: losses {losses}")


def fsdp_pods_vs_stacked(card: str) -> None:
    """Phase 4i (a): FSDP over 2 pods of 2 as 4 ranks against 4 stacked
    peers, bit for bit, saving a checkpoint (rank 0 gathers the global
    state) every PROC_STEPS // 2 steps; then the run resumed on 4 ranks
    from the middle checkpoint gives the last steps' losses bit for
    bit."""
    import shutil
    from repro_torch.checkpoint import latest_step
    from repro_torch.launch import train
    argv = ["--pods", "2", "--mesh", "2x1", "--fsdp", "--error-feedback"]
    srecs, stacked = train_run(argv, PROC_STEPS)
    ck = ROOT / "build" / "ckpt_4i_a"
    shutil.rmtree(ck, ignore_errors=True)
    half = PROC_STEPS // 2
    save = ["--ckpt-dir", str(ck), "--ckpt-every", str(half)]
    recs, report, wall = process_run(4, argv + save)
    spec = train.parse_args(TRAIN_ARGV + argv).spec
    print(f"4i (a) paper_llama {' '.join(argv)}, 4 ranks vs 4 stacked "
          f"peers, {PROC_STEPS} steps ({wall:.1f} s of torchrun): losses "
          f"bit-equal {report['losses'] == stacked}; process "
          f"{step_stats(recs)}; stacked {step_stats(srecs)} [{card}]",
          flush=True)
    check_shard_bytes("4i (a)", spec.model_config(), spec, report, PROC_STEPS,
                      spec.model_config().n_layers, card)
    if report["losses"] != stacked:
        raise AssertionError(f"4i (a): {report['losses']} vs {stacked}")
    last = latest_step(ck)
    size = _npz_bytes(ck, last)
    shutil.rmtree(ck / f"step_{last}")
    rc, out, err, rwall = torchrun(4, [
        "-m", "repro_torch.launch.train", *TRAIN_ARGV, *argv, *save,
        "--resume", "--steps", str(PROC_STEPS)])
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    steps_run = [x["step"] for x in lines if "step" in x]
    resumed = [x["losses"] for x in lines if "ranks" in x]
    shutil.rmtree(ck)
    print(f"4i (a) the 4 ranks' checkpoint of step {half - 1} ({size} bytes "
          f"of arrays.npz, written by rank 0 from the gathered shards) "
          f"resumed on 4 ranks ({rwall:.1f} s of torchrun): steps "
          f"{steps_run}, losses bit-equal to the uninterrupted run "
          f"{resumed == [report['losses'][half:]]} [{card}]", flush=True)
    if (rc != 0 or steps_run != list(range(half, PROC_STEPS))
            or resumed != [report["losses"][half:]]):
        raise AssertionError(f"4i (a) resume: exit {rc}, steps {steps_run}, "
                             f"{resumed}\n{out[-3000:]}\n{err[-6000:]}")


def sharded_full_width(card: str) -> dict:
    """Phase 4i: FSDP, tensor parallelism and remat groups over a (pod,
    data, model) mesh of processes.  One card: deepseek_coder_33b at its
    published widths (DSC_LAYERS layer) as a world of one with --fsdp
    --remat-groups 2; paper_llama --fsdp as a world of one against the
    stacked 1-peer --fsdp run, bit for bit; --remat-groups 2 against
    none; the flash kernels at hd 128.  4 cards: (a) --pods 2 --mesh 2x1
    --fsdp --error-feedback against 4 stacked peers, bit for bit; (b)
    --mesh 2x2 against the stacked dp 2 run and the x2 gradients; (c)
    deepseek_coder_33b at 8 layers on a 2 x 2 mesh with FSDP.  Returns
    the launch counts of the world-of-one deepseek run."""
    import torch
    from repro_torch.configs import get
    from repro_torch.launch import train

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    dsc = get("deepseek_coder_33b")
    argv = DSC_ARGV + ["--mesh", "1x1", "--global-batch", "1"]
    recs, report, wall = layers_run(1, DSC_LAYERS, argv, DSC_STEPS)
    launches = report["ranks"][0]["launches"]
    print(f"4i deepseek_coder_33b (d 7168, 56/8 heads, d_ff 19200, vocab "
          f"32256; {DSC_LAYERS} layer) world of one on NCCL, --fsdp "
          f"--remat-groups 2 "
          f"--sync optinc --bits 8, seq 4096, {DSC_STEPS} steps "
          f"({wall:.1f} s of torchrun): {dsc_stats(recs, report, 4096)}; "
          f"launches { {k: v for k, v in launches.items() if v} } [{card}]",
          flush=True)
    check_falling("deepseek_coder_33b world of one", report["losses"])
    idle = [k for k in _train_counters() if not launches.get(k)]
    if idle:
        raise AssertionError(f"4i: the deepseek run launched no {idle}")
    one = ["--mesh", "1x1", "--fsdp"]
    _, stacked = train_run(one, SHARD_STEPS)
    _, rep1, _ = process_run(1, one, SHARD_STEPS)
    print(f"4i paper_llama --fsdp --mesh 1x1, world of one vs the stacked "
          f"1-peer --fsdp run, {SHARD_STEPS} steps: losses bit-equal "
          f"{rep1['losses'] == stacked} ({rep1['losses']}) [{card}]",
          flush=True)
    if rep1["losses"] != stacked:
        raise AssertionError(f"4i fsdp world of one: {rep1['losses']} vs "
                             f"{stacked}")
    _, plain = train_run(["--mesh", "1x1"], SHARD_STEPS)
    _, remat = train_run(["--mesh", "1x1", "--remat-groups", "2"],
                         SHARD_STEPS)
    print(f"4i paper_llama (8 layers) --remat-groups 2 vs none, stacked "
          f"1 peer, {SHARD_STEPS} steps: losses bit-equal {remat == plain} "
          f"({remat}) [{card}]", flush=True)
    if remat != plain:
        raise AssertionError(f"4i remat: {remat} vs {plain}")
    flash = check_flash_hd128(card)
    print(f"4i one-card part took {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]", flush=True)
    cards = torch.cuda.device_count()
    if cards < 4:
        print(f"4i: (a), (b) and (c) need 4 cards; this machine has {cards} "
              f"(on a 4-card host, sharded_alone runs them) [{card}]",
              flush=True)
        return {"launches": launches, "flash": flash}
    fsdp_pods_vs_stacked(card)
    # (b) tensor parallelism 2 x data 2
    _, stacked = train_run(["--mesh", "2x1"], 1)
    recs, report, wall = process_run(4, ["--mesh", "2x2"], TP_STEPS)
    spec = train.parse_args(TRAIN_ARGV + ["--mesh", "2x2"]).spec
    d0 = abs(report["losses"][0] - stacked[0])
    print(f"4i (b) paper_llama --mesh 2x2, 4 ranks, {TP_STEPS} steps "
          f"({wall:.1f} s of torchrun): step-0 loss {report['losses'][0]} "
          f"vs the stacked dp 2 run's {stacked[0]} (|diff| {d0:.3e}, tol "
          f"{TP_LOSS_TOL}); losses {report['losses']}; "
          f"{step_stats(recs)} [{card}]", flush=True)
    check_shard_bytes("4i (b)", spec.model_config(), spec, report, TP_STEPS,
                      spec.model_config().n_layers, card)
    check_falling("(b)", report["losses"])
    if d0 > TP_LOSS_TOL:
        raise AssertionError(f"4i (b) step-0 loss {d0}")
    check_tp_grads(card)
    # (c) deepseek_coder_33b at full width, 8 layers, 2 x 2 with FSDP
    argv = DSC_ARGV + ["--mesh", "2x2", "--global-batch", "2"]
    recs, report, wall = layers_run(4, 8, argv, DSC_STEPS)
    spec = train.parse_args(argv).spec
    cfg = dataclasses.replace(spec.model_config(), n_layers=8)
    runs = report["ranks"][0]["launches"]["flash_attention"] / DSC_STEPS
    print(f"4i (c) deepseek_coder_33b (8 layers) --mesh 2x2 --fsdp "
          f"--remat-groups 2 --sync optinc --bits 8, seq 4096, "
          f"{DSC_STEPS} steps ({wall:.1f} s of torchrun): "
          f"{dsc_stats(recs, report, 2 * 4096)}; layer forwards a step "
          f"{runs} [{card}]", flush=True)
    check_falling("(c)", report["losses"])
    check_shard_bytes("4i (c)", cfg, spec, report, DSC_STEPS, runs, card)
    print(f"phase 4i took {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    return {"launches": launches, "flash": flash}


def sharded_alone(card: str) -> None:
    """Phase 4i alone, the kernels built first."""
    from repro_torch.kernels import _build
    _build.build()
    sharded_full_width(card)


# ------------------------------------------------- phase 4k: the MoE family
# phi35_moe_42b at its published widths (d 4096, 32/8 heads, hd 128, 16
# experts top-2, moe_d_ff 6400, vocab 32064), depth cut (one card: 1
# layer; 4 cards: 4), one sequence of 4096 tokens a data peer, lr 1e-5 as
# phase 4i's deepseek_coder_33b
PHI_ARGV = ["--arch", "phi35_moe_42b", "--sync", "optinc", "--bits", "8",
            "--seq-len", "4096", "--lr", "1e-5", "--device", "cuda"]
PHI_STEPS = 5
PHI_LAYERS = 1          # one card
PHI_LAYERS_4 = 4        # --mesh 2x2 --fsdp on 4 cards
# the bytes a parameter of phase 4i's deepseek_coder_33b world of one
# (40.80 GB peak over 1.523 B parameters, NVIDIA H100 80GB HBM3, 700 W):
# the reckoning the depth cuts were sized by
RECKON_BYTES_PER_PARAM = 40.80e9 / 1.523e9
# the run's step-0 loss against a forward of the same weights in the same
# rank before it (the same kernels; the loss is O(10))
PHI_LOSS_TOL = 1e-3
# (d): |g_tp2| / |g_tp1 shard| of each model-sharded leaf within this of 2.
# It tells the reference's factor tp = 2 from 1 (a transpose that loses
# the reduce-scatter sum) or 4; bf16 routing that flips between tp 1 and
# tp 2 moves a data peer's router and expert gradients: on the H100
# (NVIDIA H100 80GB HBM3, 700 W) the ratios read 1.8862 (the router) to
# 2.0334, the largest entry errors up to 0.32 of the leaf's largest
MOE_RATIO_TOL = 0.1


def n_params(cfg) -> int:
    from repro_torch.models import lm
    from repro_torch.tree import leaves
    return sum(math.prod(s) for s in leaves(lm.param_shapes(cfg)))


def phi_full_width(card: str) -> dict:
    """(a) phi35_moe_42b at its published widths, PHI_LAYERS layers, a
    world of one on NCCL: finite losses, step p50/p99, tokens/s, the
    peak memory beside the reckoning, the capacity and aux loss, and the
    launches of the flash and pam4 kernels (reset before the run, read
    after)."""
    from repro_torch.configs import get
    from repro_torch.models import blocks
    argv = PHI_ARGV + ["--mesh", "1x1", "--global-batch", "1"]
    recs, report, wall = layers_run(1, PHI_LAYERS, argv, PHI_STEPS)
    launches = report["ranks"][0]["launches"]
    cfg = dataclasses.replace(get("phi35_moe_42b"), n_layers=PHI_LAYERS)
    n = n_params(cfg)
    peak = report["ranks"][0]["peak_bytes"]
    loss0, aux0 = report["loss0"], report["aux0"]
    print(f"4k (a) phi35_moe_42b (d 4096, 32/8 heads, hd 128, 16 experts "
          f"top-2, moe_d_ff 6400, vocab 32064; {PHI_LAYERS} layer, {n} "
          f"parameters) world of one on NCCL, --sync optinc --bits 8 --lr "
          f"1e-5, seq 4096, {PHI_STEPS} steps ({wall:.1f} s of torchrun): "
          f"{dsc_stats(recs, report, 4096)}; peak {peak / 1e9:.2f} GB "
          f"against the reckoning {n * RECKON_BYTES_PER_PARAM / 1e9:.2f} GB "
          f"({RECKON_BYTES_PER_PARAM:.1f} B a parameter), {peak / n:.1f} B "
          f"a parameter measured; 2 layers ({n_params(dataclasses.replace(cfg, n_layers=2))} "
          f"parameters) would take {n_params(dataclasses.replace(cfg, n_layers=2)) * peak / n / 1e9:.2f} "
          f"GB at that rate; capacity {blocks.capacity(cfg, 4096)} tokens "
          f"an expert of 4096; step 0 by a forward of the seeded weights "
          f"before the run: loss {loss0} (the run's {report['losses'][0]}), "
          f"aux {aux0}; launches "
          f"{ {k: v for k, v in launches.items() if v} } [{card}]",
          flush=True)
    losses = report["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"4k (a) losses {losses}")
    if abs(loss0 - losses[0]) > PHI_LOSS_TOL:
        raise AssertionError(f"4k (a) step-0 loss {loss0} vs {losses[0]}")
    idle = [k for k in _train_counters() if not launches.get(k)]
    if idle:
        raise AssertionError(f"4k (a): the phi35 run launched no {idle}")
    return launches


def smoke_card_vs_cpu(card: str, label: str, arch: str) -> None:
    """``arch``'s SMOKE config in f32: one step of 2 peers (8 rows of 129
    tokens) on the card and on the CPU from the same seeded weights and
    tokens (the losses and the pre-sync gradients within phase 5's
    tolerances, each leaf against its own largest entry), and the card's
    gradient stack synced (optinc bits 8, error feedback) on the card
    and on the CPU, bit for bit."""
    import torch
    from repro_torch.collectives.bucketizer import make_layout
    from repro_torch.collectives.engine import SyncConfig, sync_flat
    from repro_torch.configs import get_smoke
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import lm
    from repro_torch.tree import leaves, tree_map

    sync = SyncConfig(mode="optinc", bits=8, block=2048, error_feedback=True,
                      bucket_bytes=2 ** 20)
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    params_cpu = lm.init_params(cfg, SEED, "cpu")
    params_gpu = tree_map(lambda t: t.cuda(), params_cpu)
    layout = make_layout([(s, torch.float32) for s in
                          leaves(lm.param_shapes(cfg))], sync.bucket_bytes)
    g = torch.Generator().manual_seed(SEED + 3)
    tok = torch.randint(0, cfg.vocab, (8, 129), generator=g)
    l_cpu, f_cpu = tsteps.peer_grad_stack(cfg, params_cpu, tok, 2,
                                          layout.total)
    l_gpu, f_gpu = tsteps.peer_grad_stack(cfg, params_gpu, tok.cuda(), 2,
                                          layout.total)
    loss_err = (l_gpu.cpu() - l_cpu).abs().max().item()
    grad_err, start = 0.0, 0
    for size in layout.sizes:          # each leaf against its own max
        want = f_cpu[:, start:start + size]
        got = f_gpu[:, start:start + size].cpu()
        grad_err = max(grad_err, ((got - want).abs().max()
                                  / want.abs().max().clamp_min(1e-30)).item())
        start += size
    res = torch.zeros_like(f_gpu)
    out_gpu, res_gpu = sync_flat(f_gpu, layout.bounds, sync, res)
    out_cpu, res_cpu = sync_flat(f_gpu.cpu(), layout.bounds, sync, res.cpu())
    same = (torch.equal(out_gpu.cpu(), out_cpu),
            torch.equal(res_gpu.cpu(), res_cpu))
    print(f"{label} card vs plain, {cfg.name} f32, 2 peers, {layout.total} "
          f"params: losses {l_gpu.tolist()} (CPU {l_cpu.tolist()}), "
          f"max_abs_err {loss_err:.3e} (tol {TRAIN_LOSS_TOL:.0e}); pre-sync "
          f"gradients max_abs_err / max|leaf| {grad_err:.3e} (tol "
          f"{TRAIN_GRAD_TOL:.0e}); the card's stack synced on the CPU: "
          f"synced bit-equal {same[0]}, residuals bit-equal {same[1]} "
          f"[{card}]", flush=True)
    if not (loss_err <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL
            and all(same)):
        raise AssertionError(f"{label} {arch}: card vs plain disagrees")


def card_vs_plain_moe(card: str) -> dict:
    """(b) phi35_moe_42b's and deepseek_v3_671b's SMOKE configs in f32,
    card vs CPU (``smoke_card_vs_cpu``).  deepseek's step runs MLA's
    (24, 16) flash instantiation.  Returns the launches of each (hd,
    hdv) pair of the flash kernels in these steps."""
    from repro_torch.kernels import attention

    counters = (attention.flash_attention, attention.flash_attention_bwd)
    for fn in counters:
        fn.launches_by_dims = {}
    for arch in ("phi35_moe_42b", "deepseek_v3_671b"):
        smoke_card_vs_cpu(card, "4k (b)", arch)
    moe_bf16_repeats(card)
    by_dims = {fn.__name__: dict(fn.launches_by_dims) for fn in counters}
    print(f"4k (b) flash launches by (hd x hdv) in these steps: {by_dims} "
          f"[{card}]", flush=True)
    if not all(by_dims[fn.__name__].get("24x16") for fn in counters):
        raise AssertionError(f"4k (b): deepseek's step ran no (24, 16) "
                             f"flash kernel: {by_dims}")
    return by_dims


def moe_bf16_repeats(card: str) -> None:
    """(b) deepseek_v3's SMOKE config in bf16 (its routed experts end in
    ``index_add``, whose CUDA kernel adds with atomics): the 2-peer
    gradient stack twice from the same weights and tokens, and two
    optinc steps with error feedback twice from the same state, each
    pair bit for bit."""
    import torch
    from repro_torch.collectives.bucketizer import make_layout
    from repro_torch.collectives.engine import SyncConfig
    from repro_torch.configs import get_smoke
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.tree import leaves
    cfg = get_smoke("deepseek_v3_671b")
    sync = SyncConfig(mode="optinc", bits=8, block=2048, error_feedback=True,
                      bucket_bytes=2 ** 20)
    opt = AdamWConfig()
    layout = make_layout([(s, lm.torch_dtype(cfg)) for s in
                          leaves(lm.param_shapes(cfg))], sync.bucket_bytes)
    g = torch.Generator().manual_seed(SEED + 6)
    tok = torch.randint(0, cfg.vocab, (8, 129), generator=g).cuda()
    stacks, runs = [], []
    for _ in range(2):
        params = lm.init_params(cfg, SEED, "cuda")
        stacks.append(tsteps.peer_grad_stack(cfg, params, tok, 2,
                                             layout.total))
        ostate = adamw_init(opt, params)
        sstate = tsteps.init_sync_state(cfg, 2, sync, "cuda")
        step = tsteps.make_train_step(cfg, 2, sync, opt, "cuda")
        losses = []
        for _ in range(2):
            params, ostate, sstate, m = step(params, ostate, sstate, tok)
            losses.append(m["loss"])
        runs.append([*losses, *leaves(params), *leaves(ostate["m"]),
                     *leaves(ostate["v"]), sstate["rep"]])
    grads_same = all(torch.equal(a, b) for a, b in zip(*stacks))
    steps_same = all(torch.equal(a, b) for a, b in zip(*runs))
    print(f"4k (b) deepseek_v3 SMOKE bf16 (top-{cfg.top_k} of "
          f"{cfg.n_experts} experts, index_add back): the 2-peer gradient "
          f"stack twice bit-equal {grads_same}; two optinc steps twice "
          f"(losses {[float(x) for x in runs[0][:2]]}, parameters, moments, "
          f"residuals) bit-equal {steps_same} [{card}]", flush=True)
    if not (grads_same and steps_same):
        raise AssertionError("4k (b) deepseek_v3's bf16 step does not "
                             "repeat bit for bit")


def mla_block_launches(card: str) -> dict:
    """deepseek_v3_671b's MLA block at its published widths (d 7168, 128
    heads, q_lora 1536, kv_lora 512, QK 192 = 128 + 64 rope, V 128), one
    sequence of 4096, forward and backward on the card through
    ``blocks.mla_attention`` (seeded bf16 weights), with the flash
    counts reset before and read after: the (192, 128) instantiation on
    the model's path (the whole model does not fit the card)."""
    import torch
    from repro_torch.configs import get
    from repro_torch.kernels import attention
    from repro_torch.models import blocks, lm
    cfg = get("deepseek_v3_671b")
    spec, shapes = lm.mla_param_specs(cfg, lm.NO_SHARD,
                                      lm.ArchDims.build(cfg))
    g = torch.Generator().manual_seed(SEED + 4)
    p = {k: (torch.ones(s) if k.endswith("norm") else
             torch.randn(s, generator=g) * 0.02).bfloat16().cuda()
         .requires_grad_() for k, s in shapes.items()}
    x = (torch.randn((1, 4096, cfg.d_model), generator=g)).bfloat16().cuda()
    x.requires_grad_()
    pos = torch.arange(4096, device="cuda")
    counters = (attention.flash_attention, attention.flash_attention_bwd)
    for fn in counters:
        fn.launches_by_dims = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = blocks.mla_attention(cfg, p, x, pos)
    grads = torch.autograd.grad(out.float().square().mean(), [x, *p.values()])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_dims = {fn.__name__: dict(fn.launches_by_dims) for fn in counters}
    finite = all(bool(torch.isfinite(t).all()) for t in (out, *grads))
    print(f"4k (c) deepseek_v3_671b's MLA block at its published widths, "
          f"seq 4096, bf16, forward and backward through "
          f"blocks.mla_attention: {wall * 1e3:.1f} ms (first call), output "
          f"{tuple(out.shape)}, finite {finite}; flash launches by (hd x "
          f"hdv) {by_dims} [{card}]", flush=True)
    if not finite or not all(by_dims[fn.__name__].get("192x128")
                             for fn in counters):
        raise AssertionError(f"4k (c) MLA block: finite {finite}, {by_dims}")
    return {fn.__name__: by_dims[fn.__name__]["192x128"] for fn in counters}


def check_flash_pair(card: str, label: str, b: int, h: int, hd: int,
                     hdv: int, sq: int, skv: int, dtype,
                     causal: bool = True, hkv: int | None = None) -> dict:
    """The flash forward and backward at one shape against their plain
    versions (bf16: under check_flash_hd128's limits, each (head, row)
    against its own scale too; f32: the f32 limits), each timed beside
    its plain version, SDPA (which takes a V head dim of its own, and
    GQA) and the bound; ``hkv`` KV heads (h by default).  Returns
    {kernel: its record's numbers}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import attention, ref
    dt = str(dtype).split(".")[-1]
    big = b * h * sq * skv > 1 << 28
    hkv = h if hkv is None else hkv
    shape = (b, h, hkv, hd, sq, skv, dtype)
    q, k, v = flash_case(*shape, SEED, hdv=hdv)
    g = torch.Generator().manual_seed(SEED + 1)
    do = torch.randn((b, h, sq, hdv), generator=g).to(dtype).cuda()
    o, lse = attention.flash_attention(q, k, v, return_lse=True,
                                       causal=causal)
    wo, wl = ref.attention_fwd_ref(q, k, v, causal)
    f_err = (o.float() - wo.float()).abs().max().item()
    f_row, f_mean = row_and_mean_errs(o, wo)
    l_err = (lse - wl).abs().max().item()
    del wo, wl
    got = attention.flash_attention_bwd(q, k, v, o, lse, do, causal)
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal)
    rel = max(((a.float() - w.float()).abs().max() / w.float().abs().max())
              .item() for a, w in zip(got, want))
    b_err = max((a.float() - w.float()).abs().max().item()
                for a, w in zip(got, want))
    del want, got
    gc.collect()
    torch.cuda.empty_cache()
    ins = copies_for([q, k, v, o, lse, do])
    fast, slow = (20, 3) if big else (50, 10)
    fwd = time_ms(lambda q, k, v, *_: attention.flash_attention(
        q, k, v, return_lse=True, causal=causal), ins, iters=fast)[0]
    fwd_plain = time_ms(lambda q, k, v, *_: ref.attention_fwd_ref(
        q, k, v, causal), ins, iters=slow)[0]
    sdpa = time_ms(lambda q, k, v, *_: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=hkv != h), ins,
        iters=fast)[0]
    bwd = time_ms(lambda *a: attention.flash_attention_bwd(*a, causal),
                  ins, iters=fast)[0]
    bwd_plain = time_ms(lambda *a: ref.attention_bwd_ref(*a, causal), ins,
                        iters=slow)[0]
    sdpa_bwd = sdpa_bwd_ms(ins, gqa=hkv != h, causal=causal)
    f_bound = flash_bounds(*shape, True, hdv=hdv, causal=causal)
    b_bound = flash_bwd_bounds(*shape, hdv=hdv, causal=causal)
    rows = dt == "bfloat16"
    print(f"{label}: b={b} h={h} hkv={hkv} hd={hd} hdv={hdv} sq={sq} "
          f"skv={skv} {dt}"
          f"{'' if causal else ' non-causal'}: forward max_abs_err "
          f"{f_err:.3e} (tol {KERNEL_TOL[dt]})"
          + (f", max over rows of max|err| / max|ref| {f_row:.3e} (tol "
             f"{FLASH_ROW_TOL:.3e}), mean|err| / mean|ref| {f_mean:.3e} "
             f"(tol {FLASH_MEAN_TOL:.3e})" if rows else "")
          + f", lse {l_err:.3e}, {fwd:.4f} ms (plain {fwd_plain:.4f} ms, "
          f"sdpa {sdpa:.4f} ms, bound {f_bound[0]:.4g} ms {f_bound[1]}); "
          f"backward max_abs_err / max|grad| {rel:.3e} (tol {BWD_TOL[dt]}), "
          f"{bwd:.4f} ms (plain {bwd_plain:.4f} ms, sdpa backward "
          f"{sdpa_bwd:.4f} ms, bound {b_bound[0]:.4g} ms {b_bound[1]}) "
          f"[{card}]", flush=True)
    if not (f_err <= KERNEL_TOL[dt] and l_err <= KERNEL_TOL["float32"]
            and rel <= BWD_TOL[dt] and (not rows or (
                f_row <= FLASH_ROW_TOL and f_mean <= FLASH_MEAN_TOL))):
        raise AssertionError(f"{label}: {f_err}, {f_row}, {f_mean}, "
                             f"{l_err}, {rel}")
    return {fn: dict(route="cuda", source=f"src/repro_torch/csrc/{fn}.cu",
                     replaces="src/repro/kernels/attention.py:63",
                     max_abs_err=err, ms=ms, plain_ms=plain,
                     bound_ms=bound[0], bound_by=bound[1], library_ms=lib)
            for fn, err, ms, plain, bound, lib in (
                ("flash_attention", f_err, fwd, fwd_plain, f_bound, sdpa),
                ("flash_attention_bwd", b_err, bwd, bwd_plain, b_bound,
                 sdpa_bwd))}


def check_mla_flash(card: str, label: str, b: int, h: int, hd: int,
                    hdv: int, t: int, dtype) -> dict:
    """``check_flash_pair`` at one of MLA's (hd, hdv) instantiations,
    causal, t long.  Returns the two kernels' records."""
    recs = check_flash_pair(card, f"4k {label} flash", b, h, hd, hdv, t, t,
                            dtype)
    return {f"{fn} mla {hd}x{hdv}": dict(
        name=f"{fn} (MLA, hd {hd}, hdv {hdv})", **rec)
        for fn, rec in recs.items()}


def moe_grads_rank(out_dir: str) -> None:
    """One rank of phase 4k (d)'s gradient check (phi35_moe_42b at its
    published widths, PHI_LAYERS_4 layers, --mesh 2x2 under torchrun):
    its local step-0 loss and gradients on its seeded shards, then the
    tp-1 loss and gradients of its data peer's rows on the whole weights
    on its own card; per model-sharded leaf the ratio of the norms of
    its local gradient and the tp-1 gradient's shard, and the largest
    entry error against 2x that shard, written to ``out_dir`` as JSON."""
    import torch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import distributed, train
    from repro_torch.models import lm
    from repro_torch.tree import leaves, leaves_with_paths, unflatten
    opts = train.parse_args(PHI_ARGV + ["--mesh", "2x2", "--global-batch",
                                        "2"])
    spec = opts.spec
    cfg = dataclasses.replace(spec.model_config(), n_layers=PHI_LAYERS_4)
    ctx = spec.mesh.ctx()
    world = distributed.init(1, 2, 2, opts.device)
    dev = world.device
    _, d, m = world.coords
    tokens = torch.from_numpy(SyntheticLM(spec.resolved_data(cfg)).batch(0))
    rows = {"tokens": tokens[d:d + 1].to(dev)}
    mine = [t.requires_grad_() for t in leaves(lm.init_params(
        cfg, spec.seed, dev, ctx, world.coords))]
    loss, _ = lm.loss_fn(cfg, unflatten(lm.param_shapes(cfg, ctx), mine),
                         rows, ctx, world)
    grads = [g.float().cpu() for g in torch.autograd.grad(loss, mine)]
    del mine
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    whole = [t.requires_grad_() for t in leaves(lm.init_params(
        cfg, spec.seed, dev))]
    loss1, _ = lm.loss_fn(cfg, unflatten(lm.param_shapes(cfg), whole), rows)
    one = torch.autograd.grad(loss1, whole)
    out = {"rank": world.rank, "loss": loss.item(), "loss_tp1": loss1.item(),
           "leaves": [], "ratios": [], "errs": []}
    for (path, _), g, g1, sp in zip(
            leaves_with_paths(lm.param_shapes(cfg)), grads, one,
            lm.spec_leaves(cfg, ctx)):
        if "model" not in sp:
            continue
        out["leaves"].append("/".join(path))
        want = lm.shard_leaf(g1.float(), sp, ctx, (0, 0, m)).cpu()
        out["ratios"].append((g.norm() / want.norm()).item())
        out["errs"].append(((g - 2 * want).abs().max()
                            / (2 * want).abs().max()).item())
    (Path(out_dir) / f"r{world.rank}.json").write_text(json.dumps(out))
    distributed.shutdown()
    distributed.exit_rank(0)


def check_moe_grads(card: str, loss0: float) -> None:
    """(d)'s factor: every model-sharded leaf's (the routed experts, the
    router, attention, the vocabulary) local pre-sync gradient at tp 2 is
    2x the tp-1 gradient's shard, as the CPU tests pin against JAX:
    held by the ratio of norms within MOE_RATIO_TOL (a token whose bf16
    routing flips between tp 1 and 2 moves single entries much more
    than the norm), with each leaf's ratios and largest entry error
    printed; and the 2 x 2 --fsdp run's step-0 loss ``loss0`` against
    the mean of the two data peers' tp-1 losses (the stacked dp-2 run's
    step 0) within TP_LOSS_TOL."""
    import shutil
    out = ROOT / "build" / "moe_grads"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    rc, o, e, wall = torchrun(4, [str(ROOT / "chip_smoke.py"), "--moe-grads",
                                  str(out)], timeout=900)
    if rc != 0:
        raise AssertionError(f"4k (d) gradients: exit {rc}\n{e[-6000:]}")
    ranks = [json.loads((out / f"r{r}.json").read_text()) for r in range(4)]
    shutil.rmtree(out)
    ratios = [x for r in ranks for x in r["ratios"]]
    worst = max(x for r in ranks for x in r["errs"])
    by_leaf = {n: ([round(r["ratios"][i], 4) for r in ranks],
                   max(r["errs"][i] for r in ranks))
               for i, n in enumerate(ranks[0]["leaves"])}
    stacked0 = (ranks[0]["loss_tp1"] + ranks[2]["loss_tp1"]) / 2
    d0 = abs(loss0 - stacked0)
    lo, hi = min(ratios), max(ratios)
    print(f"4k (d) phi35_moe_42b ({PHI_LAYERS_4} layers) --mesh 2x2 "
          f"step-0 local gradients of the {len(ranks[0]['ratios'])} "
          f"model-sharded leaves a rank against the tp-1 shards "
          f"({wall:.1f} s of torchrun): |g_tp2| / |g_tp1| in [{lo:.4f}, "
          f"{hi:.4f}] (want 2 within {MOE_RATIO_TOL} of it), max entry "
          f"|g_tp2 - 2 g_tp1| / max|2 g_tp1| {worst:.3e}; by leaf (ratios "
          f"of ranks 0-3, max entry error) {by_leaf}; step-0 losses: the "
          f"--fsdp "
          f"run's {loss0} vs the stacked dp-2 run's {stacked0} (|diff| "
          f"{d0:.3e}, tol {TP_LOSS_TOL}); the tp-2 ranks' local losses "
          f"{[r['loss'] for r in ranks]} [{card}]", flush=True)
    if not (abs(lo / 2 - 1) <= MOE_RATIO_TOL and abs(hi / 2 - 1)
            <= MOE_RATIO_TOL and d0 <= TP_LOSS_TOL):
        raise AssertionError(f"4k (d): ratios [{lo}, {hi}], loss {d0}")


def moe_full_width(card: str) -> dict:
    """Phase 4k: the MoE family.  One card: (a) phi35_moe_42b at its
    published widths as a world of one; (b) the two MoE SMOKE configs
    card vs CPU; (c) deepseek_v3's MLA block and flash kernels at its
    published shape.  4 cards: (d) phi35_moe_42b with PHI_LAYERS_4
    layers on --mesh 2x2 --fsdp (8 experts a rank over 'model'): finite
    losses, the bytes a rank a step against the shapes, the step-0 loss
    against the stacked dp-2 run's and the x2 gradients.  Returns the
    launch counts of (a), the (hd x hdv) launches of (b) and (c) and
    (c)'s records."""
    import torch
    from repro_torch.launch import train
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    launches = phi_full_width(card)
    smoke_dims = card_vs_plain_moe(card)
    mla_launches = mla_block_launches(card)
    # deepseek_v3's published MLA shape; (b)'s deepseek step: a peer's 4
    # rows of 128 tokens, 4 heads, f32
    records = check_mla_flash(card, "(c)", 1, 128, 192, 128, 4096,
                              torch.bfloat16)
    records.update(check_mla_flash(card, "(b)", 4, 4, 24, 16, 128,
                                   torch.float32))
    for fn in ("flash_attention", "flash_attention_bwd"):
        records[f"{fn} mla 192x128"]["launches"] = mla_launches[fn]
        records[f"{fn} mla 24x16"]["launches"] = smoke_dims[fn]["24x16"]
    print(f"4k one-card part took {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]", flush=True)
    cards = torch.cuda.device_count()
    if cards < 4:
        print(f"4k: (d) needs 4 cards; this machine has {cards} (on a "
              f"4-card host, moe_processes_alone runs it) [{card}]",
              flush=True)
    else:
        phi_four_cards(card)
    print(f"phase 4k took {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    return {"launches": launches, "smoke_dims": smoke_dims,
            "records": records}


def phi_four_cards(card: str) -> None:
    """(d) phi35_moe_42b with PHI_LAYERS_4 layers on --mesh 2x2 --fsdp
    (8 experts a rank over 'model'), 4 ranks on NCCL: finite losses, the
    bytes a rank a step against the shapes, the step-0 loss against the
    stacked dp-2 run's and the x2 gradients (``check_moe_grads``)."""
    import torch
    from repro_torch.launch import train
    gc.collect()
    torch.cuda.empty_cache()
    argv = PHI_ARGV + ["--mesh", "2x2", "--fsdp", "--global-batch", "2"]
    recs, report, wall = layers_run(4, PHI_LAYERS_4, argv, PHI_STEPS)
    spec = train.parse_args(argv).spec
    cfg = dataclasses.replace(spec.model_config(), n_layers=PHI_LAYERS_4)
    runs = report["ranks"][0]["launches"]["flash_attention"] / PHI_STEPS
    n = n_params(cfg)
    peak = max(r["peak_bytes"] for r in report["ranks"])
    print(f"4k (d) phi35_moe_42b ({PHI_LAYERS_4} layers, {n} parameters, 8 "
          f"experts a rank) --mesh 2x2 --fsdp --sync optinc --bits 8, seq "
          f"4096, {PHI_STEPS} steps ({wall:.1f} s of torchrun): "
          f"{dsc_stats(recs, report, 2 * 4096)}; peak a rank "
          f"{peak / 1e9:.2f} GB against the reckoning "
          f"{n / 4 * RECKON_BYTES_PER_PARAM / 1e9:.2f} GB; layer forwards a "
          f"step {runs} [{card}]", flush=True)
    if not all(math.isfinite(x) for x in report["losses"]):
        raise AssertionError(f"4k (d) losses {report['losses']}")
    check_shard_bytes("4k (d)", cfg, spec, report, PHI_STEPS, runs, card)
    check_moe_grads(card, report["losses"][0])


def moe_alone(card: str) -> None:
    """Phase 4k alone, the kernels built first."""
    from repro_torch.kernels import _build
    _build.build()
    moe_full_width(card)


def moe_processes_alone(card: str) -> None:
    """Phase 4k's 4-card part (d) alone, on a 4-card host."""
    from repro_torch.kernels import _build
    _build.build()
    phi_four_cards(card)


# ------------------------------------- phase 4l: the encoder-decoder family
# whisper_tiny at its published widths (4 encoder and 4 decoder layers, d
# 384, 6 heads of 64, d_ff 1536, vocab 51865, 1500 stub frames), trained
# through launch/steps.make_train_step on batches that carry enc_frames:
# 4 stacked peers x 8 rows (global batch 32), 449 tokens a row (t 448,
# whisper's text context), --sync optinc --bits 8 --block 2048 and the
# CLI's default lr
WHISPER_PEERS, WHISPER_ROWS, WHISPER_T = 4, 8, 448
WHISPER_STEPS = 10
# (a)'s cases: (label, b, h, hd, sq, skv, dtype name): the encoder's
# self-attention, the decoder's cross-attention over the encoder's 1500
# frames, and SMOKE's ragged cross shape with more queries than keys
WHISPER_FLASH = (("encoder", 8, 6, 64, 1500, 1500, "bfloat16"),
                 ("cross", 8, 6, 64, 448, 1500, "bfloat16"),
                 ("ragged sq > skv", 2, 2, 32, 37, 32, "float32"))


def whisper_flash(card: str) -> dict:
    """(a) The flash pair's non-causal mode (``check_flash_pair``) at
    WHISPER_FLASH's shapes.  Returns the encoder shape's records (the
    non-causal mode's launches are set by (b))."""
    import torch
    records = {}
    for label, b, h, hd, sq, skv, dt in WHISPER_FLASH:
        recs = check_flash_pair(card, f"4l (a) {label}", b, h, hd, hd, sq,
                                skv, getattr(torch, dt), causal=False)
        if label == "encoder":
            records.update({f"{fn} full": dict(
                name=f"{fn} (non-causal, whisper encoder)", **rec)
                for fn, rec in recs.items()})
    return records


def whisper_batches(cfg, steps: int, seed: int) -> list:
    """``steps`` global batches: SyntheticLM tokens (B, WHISPER_T + 1) and
    enc_frames (B, frames, d) f32 from numpy's default_rng(seed), on the
    card."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    b = WHISPER_PEERS * WHISPER_ROWS
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=WHISPER_T,
                                  global_batch=b, seed=seed))
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(data.batch(i)).cuda(),
             torch.from_numpy(rng.standard_normal(
                 (b, cfg.enc_frames, cfg.d_model), dtype=np.float32)).cuda())
            for i in range(steps)]


def whisper_run(cfg, sync, batches, profile_card: str | None = None):
    """One training run of whisper on 4 stacked peers from the seeded
    init, a step a batch: (losses, step seconds, and with
    ``profile_card`` the last step run under the profiler, its {kernel:
    device us}, else None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    opt = AdamWConfig()
    params = lm.init_params(cfg, SEED, "cuda")
    ostate = adamw_init(opt, params)
    sstate = tsteps.init_sync_state(cfg, WHISPER_PEERS, sync, "cuda")
    step = tsteps.make_train_step(cfg, WHISPER_PEERS, sync, opt, "cuda")
    losses, times, dev = [], [], None
    torch.cuda.synchronize()
    for i, (tok, frames) in enumerate(batches):
        prof = None
        if profile_card and i == len(batches) - 1:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        params, ostate, sstate, m = step(params, ostate, sstate, tok,
                                         enc_frames=frames)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
        if prof is not None:
            prof.__exit__(None, None, None)
            dev = device_profile(prof, times[-1], profile_card,
                                 "whisper_tiny step")
    return losses, times, dev


def whisper_full_width(card: str) -> dict:
    """(b) whisper_tiny at its published widths: WHISPER_STEPS optinc
    steps (launch counts reset just before, read just after, each split
    by mask and held to the layers' count; pam4 once a bucket), then as
    many psum steps as a yardstick, a profiled step; losses, step
    p50/p99, tokens/s and frames/s, peak memory.  Returns the run's
    launches {name: count} with the flash pair's by mode."""
    import torch
    from repro_torch.collectives.bucketizer import make_layout
    from repro_torch.collectives.engine import SyncConfig
    from repro_torch.configs import get
    from repro_torch.models import lm
    from repro_torch.tree import leaves
    cfg = get("whisper_tiny")
    n = n_params(cfg)
    sync = SyncConfig(mode="optinc", bits=8, block=2048)
    layout = make_layout([(s, lm.torch_dtype(cfg)) for s in
                          leaves(lm.param_shapes(cfg))], sync.bucket_bytes)
    batches = whisper_batches(cfg, WHISPER_STEPS, SEED)
    counters = _train_counters()
    for fn in counters.values():
        fn.launches = 0
    flash = (counters["flash_attention"], counters["flash_attention_bwd"])
    for fn in flash:
        fn.launches_by_mode = {}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, times, dev = whisper_run(cfg, sync, batches, card)
    peak = torch.cuda.max_memory_allocated()
    launches = {name: fn.launches for name, fn in counters.items()}
    modes = {fn.__name__: dict(fn.launches_by_mode) for fn in flash}
    p50, p99 = pct(times[1:-1], 0.5), pct(times[1:-1], 0.99)
    b = WHISPER_PEERS * WHISPER_ROWS
    print(f"4l (b) whisper_tiny (4 + 4 layers, d 384, 6 heads of 64, d_ff "
          f"1536, vocab 51865, {n} parameters in "
          f"{len(leaves(lm.param_shapes(cfg)))} leaves, {layout.n_buckets} "
          f"buckets), {WHISPER_PEERS} stacked peers x {WHISPER_ROWS} rows, t "
          f"{WHISPER_T}, {cfg.enc_frames} frames, --sync optinc --bits 8 "
          f"--block 2048, {WHISPER_STEPS} steps: losses {losses}; step p50 "
          f"{p50 * 1e3:.3f} ms p99 {p99 * 1e3:.3f} ms over steps 1-"
          f"{WHISPER_STEPS - 2} (first {times[0] * 1e3:.3f} ms, the last "
          f"profiled), "
          f"{b * WHISPER_T / p50:.1f} tokens/s and "
          f"{b * cfg.enc_frames / p50:.1f} frames/s at p50; peak memory "
          f"{peak} bytes ({peak / 2 ** 30:.2f} GiB); launches {launches}, "
          f"flash by mode {modes} [{card}]", flush=True)
    check_falling("4l (b) whisper_tiny", losses)
    per_step = WHISPER_STEPS * WHISPER_PEERS
    want = {"full": per_step * (cfg.n_enc_layers + cfg.n_layers),
            "causal": per_step * cfg.n_layers}
    for name in modes:
        if modes[name] != want:
            raise AssertionError(f"4l (b) {name} launches by mode "
                                 f"{modes[name]}, want {want}")
    want_pam4 = WHISPER_STEPS * layout.n_buckets
    if (launches["pam4_quantize_encode"] != want_pam4
            or launches["pam4_decode_dequantize"] != want_pam4):
        raise AssertionError(f"4l (b) pam4 launches {launches}: want one "
                             f"encode and one decode a bucket, {want_pam4}")
    if dev:
        busy = sum(dev.values())
        share = {}
        for key, us in dev.items():
            if "flash" in key or "pam4" in key:
                name = kernel_name(key)
                share[name] = share.get(name, 0.0) + 100 * us / busy
        print(f"4l (b) the flash and pam4 kernels in the profiled step: "
              + ", ".join(f"{k} {v:.2f}%" for k, v in sorted(share.items()))
              + f" of the device time [{card}]", flush=True)
    psum, ptimes, _ = whisper_run(cfg, SyncConfig(mode="psum"), batches)
    print(f"4l (b) yardstick --sync psum, the same batches: losses {psum}; "
          f"step p50 {pct(ptimes[1:], 0.5) * 1e3:.3f} ms p99 "
          f"{pct(ptimes[1:], 0.99) * 1e3:.3f} ms over steps 1-"
          f"{WHISPER_STEPS - 1} [{card}]", flush=True)
    check_falling("4l (b) whisper_tiny psum", psum)
    return {"launches": launches, "modes": modes}


def whisper_card_vs_plain(card: str) -> None:
    """(c) whisper's SMOKE config in f32: one step of 2 peers x 2 rows, t
    37 (ragged), 32 frames, on the card and on the CPU from the same
    weights, tokens and frames (the loss and the pre-sync gradients
    within phase 5's tolerances), and the card's gradient stack synced
    on the card and on the CPU, bit for bit.  The card's step runs the
    f32 non-causal kernels at sq 37 > skv 32 (the cross-attention)."""
    import numpy as np
    import torch
    from repro_torch.collectives.bucketizer import make_layout
    from repro_torch.collectives.engine import SyncConfig, sync_flat
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import attention
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import lm
    from repro_torch.tree import leaves, tree_map
    cfg = dataclasses.replace(get_smoke("whisper_tiny"), dtype="float32")
    params_cpu = lm.init_params(cfg, SEED, "cpu")
    params_gpu = tree_map(lambda t: t.cuda(), params_cpu)
    sync = SyncConfig(mode="optinc", bits=8, block=2048, error_feedback=True,
                      bucket_bytes=2 ** 20)
    layout = make_layout([(s, torch.float32) for s in
                          leaves(lm.param_shapes(cfg))], sync.bucket_bytes)
    rng = np.random.default_rng(SEED + 3)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 38)))
    frames = torch.from_numpy(rng.standard_normal(
        (4, cfg.enc_frames, cfg.d_model), dtype=np.float32))
    flash = (attention.flash_attention, attention.flash_attention_bwd)
    for fn in flash:
        fn.launches_by_mode = {}
    l_cpu, f_cpu = tsteps.peer_grad_stack(cfg, params_cpu, tok, 2,
                                          layout.total, enc_frames=frames)
    l_gpu, f_gpu = tsteps.peer_grad_stack(cfg, params_gpu, tok.cuda(), 2,
                                          layout.total,
                                          enc_frames=frames.cuda())
    modes = {fn.__name__: dict(fn.launches_by_mode) for fn in flash}
    loss_err = (l_gpu.cpu() - l_cpu).abs().max().item()
    grad_err, start = 0.0, 0
    for size in layout.sizes:          # each leaf against its own max
        want = f_cpu[:, start:start + size]
        got = f_gpu[:, start:start + size].cpu()
        grad_err = max(grad_err, ((got - want).abs().max()
                                  / want.abs().max().clamp_min(1e-30)).item())
        start += size
    res = torch.zeros_like(f_gpu)
    out_gpu, res_gpu = sync_flat(f_gpu, layout.bounds, sync, res)
    out_cpu, res_cpu = sync_flat(f_gpu.cpu(), layout.bounds, sync, res.cpu())
    same = (torch.equal(out_gpu.cpu(), out_cpu),
            torch.equal(res_gpu.cpu(), res_cpu))
    print(f"4l (c) card vs plain, {cfg.name} f32, 2 peers x 2 rows, t 37, "
          f"{cfg.enc_frames} frames, {layout.total} params: losses "
          f"{l_gpu.tolist()} (CPU {l_cpu.tolist()}), max_abs_err "
          f"{loss_err:.3e} (tol {TRAIN_LOSS_TOL:.0e}); pre-sync gradients "
          f"max_abs_err / max|leaf| {grad_err:.3e} (tol "
          f"{TRAIN_GRAD_TOL:.0e}); the card's stack synced on the CPU: "
          f"synced bit-equal {same[0]}, residuals bit-equal {same[1]}; "
          f"flash launches by mode {modes} [{card}]", flush=True)
    want = {"full": 2 * (cfg.n_enc_layers + cfg.n_layers),
            "causal": 2 * cfg.n_layers}
    if not (loss_err <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL
            and all(same) and all(m == want for m in modes.values())):
        raise AssertionError(f"4l (c) whisper SMOKE card vs plain: "
                             f"{loss_err}, {grad_err}, {same}, {modes}")


def whisper_phase(card: str) -> dict:
    """Phase 4l: the encoder-decoder family on one card.  (a) the flash
    pair's non-causal mode against its plain versions, timed; (b)
    whisper_tiny at its published widths; (c) its SMOKE step card vs
    CPU.  Returns (a)'s records with (b)'s non-causal launches."""
    import torch
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    records = whisper_flash(card)
    run = whisper_full_width(card)
    for fn in ("flash_attention", "flash_attention_bwd"):
        records[f"{fn} full"]["launches"] = run["modes"][fn]["full"]
    whisper_card_vs_plain(card)
    print(f"phase 4l took {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)
    return records


def whisper_alone(card: str) -> None:
    """Phase 4l alone, the kernels built first."""
    from repro_torch.kernels import _build
    _build.build()
    whisper_phase(card)


# ------------------------ phase 4m: qk-norm and the Mamba-2 hybrid
HYBRID_STEPS = 5
# (c)'s steps: step 0 warms up, steps 1 to ZAMBA_STEPS - 2 are timed and
# the last is profiled
ZAMBA_STEPS = 8
# the trainers of (b) and (c): one peer on the card, one sequence of 4096
QWEN_ARGV = ["--arch", "qwen3_32b", "--sync", "optinc", "--bits", "8",
             "--fsdp", "--mesh", "1x1", "--global-batch", "1", "--seq-len",
             "4096", "--lr", "1e-5", "--device", "cuda"]
ZAMBA_ARGV = ["--arch", "zamba2_7b", "--sync", "optinc", "--bits", "8",
              "--mesh", "1x1", "--global-batch", "1", "--seq-len", "4096",
              "--lr", "1e-5", "--device", "cuda"]
QWEN_LAYERS = 1         # 2.01 B parameters, 1.56 B of them the vocabulary's
ZAMBA_LAYERS = 7        # 6 mamba2 layers and one use of the shared block
# the bytes a parameter of phi35_moe_42b's world of one, whose every leaf
# goes through the f32 sync stack (54.09 GB, NVIDIA H100 80GB HBM3,
# 700 W): the reckoning of (c); (b)'s FSDP run is reckoned at
# RECKON_BYTES_PER_PARAM, deepseek_coder_33b's FSDP world of one
SYNCED_BYTES_PER_PARAM = 34.6
# (a)'s flash cases: (label, b, h, hkv, hd, sq, skv, dtype name)
HYBRID_FLASH = (("qwen3_32b", 1, 64, 8, 80, 4096, 4096, "bfloat16"),
                ("zamba2_7b", 1, 32, 32, 112, 4096, 4096, "bfloat16"),
                ("ragged hd 80", 2, 4, 2, 80, 37, 45, "float32"),
                ("ragged hd 112", 2, 4, 4, 112, 37, 45, "float32"))


def hybrid_flash(card: str) -> dict:
    """(a) The ptxas lines of the (80, 80) and (112, 112) flash
    instantiations; the flash pair at HYBRID_FLASH's shapes
    (``check_flash_pair``) and the paged kernel at hd 80.  Returns the
    bf16 cases' records and the paged one's (their launches are set by
    (b) and (c))."""
    import re
    import torch
    from repro_torch.kernels import _build, paged_attention, ref
    paths = _build.build(["flash_attention", "flash_attention_bwd"])
    for name, path in sorted(paths.items()):
        for short, _, st in ptxas_stats(path):
            if re.search(r"<(80, 80|112, 112)>", short):
                spill = st["spill"]
                print(f"  4m (a) {name}: {short}: {st.get('regs')} "
                      f"registers, {spill[0]} bytes spill stores, "
                      f"{spill[1]} bytes spill loads, {st.get('smem', 0)} "
                      f"bytes static smem", flush=True)
    records = {}
    for label, b, h, hkv, hd, sq, skv, dt in HYBRID_FLASH:
        recs = check_flash_pair(card, f"4m (a) {label}", b, h, hd, hd, sq,
                                skv, getattr(torch, dt), hkv=hkv)
        if dt == "bfloat16":
            records.update({f"{fn} {hd}x{hd}": dict(
                name=f"{fn} (hd {hd}, {label})", **rec)
                for fn, rec in recs.items()})
    b, h, hkv, hd, ps = 8, 64, 8, 80, 16
    lengths = [1, 15, 16, 17, 100, 128, 255, 256]
    args = paged_case(b, h, hkv, hd, ps, lengths, torch.bfloat16, SEED)
    got = paged_attention.paged_attention(*args).float()
    err = (got - ref.paged_attention_ref(*args).float()).abs().max().item()
    p = paged_attention.plan(
        b, h, hkv, ps, hd, args[3].shape[1], 2, 16,
        torch.cuda.get_device_properties(0).multi_processor_count)
    ins = copies_for(args)
    ms = time_ms(paged_attention.paged_attention, ins)[0]
    plain_ms = time_ms(ref.paged_attention_ref, ins, iters=20)[0]
    lib_ms = time_ms(gather_sdpa, ins)[0]
    bound, by = paged_bounds(b, h, hkv, hd, ps, lengths, torch.bfloat16)
    print(f"4m (a) paged_attention at qwen3's heads: b={b} h={h} hkv={hkv} "
          f"hd={hd} page={ps} lengths={lengths} bf16: max_abs_err "
          f"{err:.3e} (tol {KERNEL_TOL['bfloat16']:.0e}); split {p.split} x "
          f"{p.n_splits}, {p.vec_bytes}-byte loads, {p.rows} rows a block; "
          f"kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, gather "
          f"+ sdpa (GQA) {lib_ms * 1e3:.2f} us, bound {bound * 1e3:.3f} us "
          f"({by}) [{card}]", flush=True)
    if not err <= KERNEL_TOL["bfloat16"]:
        raise AssertionError(f"4m (a) paged_attention hd 80: {err}")
    records["paged_attention hd 80"] = dict(
        name="paged_attention (hd 80, qwen3_32b)", route="cuda",
        source="src/repro_torch/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:108",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=by, library_ms=lib_ms)
    return records


def profile_step(at: int, cpu: bool = True):
    """A TrainSession callback that runs step ``at`` under torch.profiler
    (started when step at - 1 ends, stopped when step at ends); its
    ``prof`` and the step's ``wall_s`` afterwards.  ``cpu`` False traces
    the device alone (the host's ops of a loop-bound step are too many to
    trace cheaply)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api.callbacks import Callback

    class ProfileStep(Callback):
        prof = wall_s = None

        def on_step(self, session, record):
            if record["step"] == at - 1:
                self.prof = profile(activities=[ProfilerActivity.CUDA]
                                    + [ProfilerActivity.CPU] * cpu)
                self.prof.__enter__()
            elif record["step"] == at and self.prof is not None:
                self.prof.__exit__(None, None, None)
                self.wall_s = record["time_s"]

    return ProfileStep()


def hybrid_session(argv, cfg, steps: int, callbacks=(), draw=None):
    """A TrainSession on ``argv`` with ``cfg`` (the depth cut) and the
    weights ``draw()`` gives (None: the host's seeded init) run for
    ``steps`` steps, the flash and pam4 counts reset before its init and
    the peak memory after it: (session, records, whole losses, seconds
    of the init, launches {name: count}, flash launches by (hd x hdv),
    peak bytes)."""
    import torch
    from repro_torch.api import TrainSession
    from repro_torch.api.callbacks import default_callbacks
    from repro_torch.launch import train
    counters = _train_counters()
    for fn in counters.values():
        fn.launches = 0
        fn.launches_by_dims = {}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opts = train.parse_args(argv + ["--steps", str(steps)])
    t = time.perf_counter()
    session = TrainSession(opts.spec, default_callbacks(opts.spec,
                                                        io.StringIO())
                           + list(callbacks), device=opts.device,
                           params=None if draw is None else draw(), cfg=cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    recs = session.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    losses = [session.losses[i] for i in range(steps)]
    launches = {name: fn.launches for name, fn in counters.items()}
    dims = {name: dict(counters[name].launches_by_dims)
            for name in ("flash_attention", "flash_attention_bwd")}
    return session, recs, losses, init_s, launches, dims, peak


def step_line(recs, losses, tokens: int) -> str:
    times = [r["time_s"] for r in recs[1:]]
    p50 = pct(times, 0.5)
    return (f"losses {losses}; step p50 {p50 * 1e3:.1f} ms p99 "
            f"{pct(times, 0.99) * 1e3:.1f} ms over steps 1-{len(recs) - 1} "
            f"(first {recs[0]['time_s'] * 1e3:.1f} ms), {tokens / p50:.1f} "
            f"tokens/s at p50")


def device_params(cfg, seed: int, ctx=None, device="cuda") -> dict:
    """Seeded weights of ``cfg`` (at the padded global shapes of ``ctx``)
    drawn on the card by ``lm.init_leaf``, the init_params recipe, from a
    CUDA generator: a session's or an engine's weights in a fraction of
    a second, where the host's seeded init of billions of parameters
    takes tens."""
    import torch
    from repro_torch.models import lm
    from repro_torch.tree import leaves_with_paths, set_path
    g = torch.Generator(device=device).manual_seed(seed)
    dt = lm.torch_dtype(cfg)
    shapes = lm.param_shapes(cfg) if ctx is None else lm.param_shapes(cfg,
                                                                      ctx)
    out = {}
    for path, shp in leaves_with_paths(shapes):
        set_path(out, path, lm.init_leaf(
            path, shp, dt, lambda s: torch.randn(s, generator=g,
                                                 device=device),
            device=device))
    return out


class world_of_one:
    """The launch environment of a world of one in this process (rank 0
    of 1, card 0, NCCL on a free localhost port) inside the ``with``
    block: a TrainSession made there starts its process group and
    ``session.close()`` ends it; the environment is restored after."""
    KEYS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
            "MASTER_ADDR", "MASTER_PORT")

    def __enter__(self):
        import os
        import socket
        self.saved = {k: os.environ.get(k) for k in self.KEYS}
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        os.environ.update(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                          LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(port))
        return self

    def __exit__(self, *exc):
        import os
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def qwen_full_width(card: str) -> dict:
    """(b) qwen3_32b at its published widths (d 5120, 64/8 heads of 80
    with qk-norm, d_ff 25600, vocab 151936) cut to QWEN_LAYERS layer, a
    world of one on NCCL in this process with --fsdp (as phase 4i's
    deepseek_coder_33b: the sync takes the replicated leaves only; the
    stacked --fsdp step keeps a second copy of the state while it
    restacks, which does not fit), the seeded weights drawn on the card
    (``device_params``), seq 4096, HYBRID_STEPS steps and one more traced
    on the device: finite falling losses, step p50/p99 (the untraced
    steps after the first), tokens/s, peak memory beside the reckoning,
    the launches (flash, all at 80 x 80, once a layer a step; pam4 once
    a bucket of the replicated leaves: FSDP leaves skip the sync at pods
    1), the traced step's busy share and heaviest kernels; then
    ServeEngine at the same widths on seeded weights drawn on
    the card, 8 requests (the paged kernel at hd 80).  Returns the flash
    and paged launches."""
    import torch
    from repro_torch.collectives.bucketizer import make_layout
    from repro_torch.configs import get
    from repro_torch.kernels import attention, paged_attention
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.serving.config import ServeConfig
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(get("qwen3_32b"), n_layers=QWEN_LAYERS)
    n = n_params(cfg)
    spec = train.parse_args(QWEN_ARGV).spec
    ctx = spec.mesh.ctx()
    rep_buckets = make_layout(
        [(s, lm.torch_dtype(cfg)) for s, m in zip(
            leaves(lm.local_param_shapes(cfg, ctx)), lm.fsdp_leaves(cfg, ctx))
         if not m], spec.resolved_sync().bucket_bytes).n_buckets
    steps = HYBRID_STEPS + 1                 # the last one profiled
    prof = profile_step(HYBRID_STEPS, cpu=False)
    with world_of_one():
        session, recs, losses, init_s, launches, _, peak = hybrid_session(
            QWEN_ARGV, cfg, steps, [prof],
            draw=lambda: device_params(cfg, spec.seed, ctx))
        session.close()
    del session
    logits = 2 * 4096 * cfg.vocab * 4          # f32 logits and gradient
    reckon = n * RECKON_BYTES_PER_PARAM + logits
    print(f"4m (b) qwen3_32b (d 5120, 64/8 heads of 80, qk-norm, d_ff "
          f"25600, vocab 151936; {QWEN_LAYERS} layer, {n} parameters) world "
          f"of one on NCCL in process, --fsdp --sync optinc --bits 8 --lr "
          f"1e-5, seq 4096, {steps} steps (session init with the "
          f"weights drawn on the card {init_s:.2f} s; the last step "
          f"profiled): {step_line(recs[:-1], losses[:-1], 4096)}; last "
          f"loss {losses[-1]}; peak {peak / 1e9:.2f} GB "
          f"against the reckoning {reckon / 1e9:.2f} GB "
          f"({RECKON_BYTES_PER_PARAM:.1f} B a parameter + {logits / 1e9:.2f}"
          f" GB of f32 logits and their gradient), {peak / n:.1f} B a "
          f"parameter measured; {rep_buckets} bucket(s) of replicated "
          f"leaves a step; launches "
          f"{ {k: v for k, v in launches.items() if v} } (the flash pair's "
          f"all at 80 x 80: qwen3 has no other head dim) [{card}]",
          flush=True)
    check_falling("4m (b) qwen3_32b", losses)
    want = steps * QWEN_LAYERS
    if not (launches["flash_attention"] == want
            and launches["flash_attention_bwd"] == want
            and launches["pam4_quantize_encode"] == steps * rep_buckets
            and launches["pam4_decode_dequantize"] == steps * rep_buckets):
        raise AssertionError(f"4m (b) launches {launches}: want {want} of "
                             f"each flash kernel, {steps} x "
                             f"{rep_buckets} of each pam4")
    if prof.prof is not None:
        device_profile(prof.prof, prof.wall_s, card, "qwen3_32b step")
    gc.collect()
    torch.cuda.empty_cache()
    serve = ServeConfig(page_size=16, max_active=8, max_seq=512)
    eng = ServeEngine(cfg, serve, device_params(cfg, SEED + 6),
                      device="cuda")
    prompts = make_prompts(8, cfg.vocab, 64, 256, SEED + 5)
    drive(eng, prompts[:1], 2, stagger=False)            # warm
    for fn in (attention.flash_attention, paged_attention.paged_attention):
        fn.launches = 0
    torch.cuda.synchronize()
    _, times, wall = drive(eng, prompts, 32, stagger=True)
    served = {"flash_attention": attention.flash_attention.launches,
              "paged_attention": paged_attention.paged_attention.launches}
    print(f"4m (b) qwen3_32b ({QWEN_LAYERS} layer, bf16) served by "
          f"ServeEngine: 8 staggered requests of 64-256 prompt tokens x 32 "
          f"new in {len(times)} engine steps, {wall:.3f} s, "
          f"{8 * 32 / wall:.1f} tokens/s, step p50 "
          f"{pct([t for t, _ in times], 0.5) * 1e3:.2f} ms; launches "
          f"{served} [{card}]", flush=True)
    if not all(served.values()):
        raise AssertionError(f"4m (b) serving launched {served}")
    del eng
    return {"flash": launches["flash_attention"],
            "flash_bwd": launches["flash_attention_bwd"],
            "paged": served["paged_attention"]}


def ssd_scan_ms(cfg, t: int) -> float:
    """Device ms of one mamba2 layer's SSD scan, forward and backward,
    at the run's shapes (b 1, t, nh heads of 64, ssm_state N, chunk 128,
    f32), on seeded inputs: the scan's part of a step, measured alone."""
    import torch
    from repro_torch.models import blocks
    g = torch.Generator(device="cuda").manual_seed(SEED)
    nh, n = 2 * cfg.d_model // 64, cfg.ssm_state

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).requires_grad_()
    ins = [rand(1, t, nh, 64), (torch.rand((1, t, nh), generator=g,
                                           device="cuda") + 0.5
                                ).requires_grad_(),
           (-torch.ones(nh, device="cuda")).requires_grad_(),
           rand(1, t, n), rand(1, t, n)]

    def run():
        y, st = blocks.ssd_chunk_scan(*ins, 128)
        torch.autograd.grad(y.sum() + st.sum(), ins)
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 3


def zamba_full_width(card: str) -> dict:
    """(c) zamba2_7b at its published widths (d 3584, d_inner 7168 in 112
    SSD heads of 64, ssm_state 64; the shared block's 32 heads of 112,
    d_ff 14336; vocab 32000) cut to ZAMBA_LAYERS layers (6 mamba2 layers,
    one use of the shared block), one peer, every leaf synced, the seeded
    weights drawn on the card, seq 4096, ZAMBA_STEPS steps, the last
    profiled: finite falling losses, step p50/p99 over the unprofiled
    steps after the first, tokens/s, peak memory beside the reckoning,
    buckets a step, the flash launches at 112 x 112 (one use a step),
    pam4 once a bucket, the busy share and the SSD scan's share of the
    device time.
    Returns the flash launches by dims."""
    from repro_torch.collectives.bucketizer import make_layout
    from repro_torch.configs import get
    from repro_torch.models import lm
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(get("zamba2_7b"), n_layers=ZAMBA_LAYERS)
    n = n_params(cfg)
    prof = profile_step(ZAMBA_STEPS - 1)
    session, recs, losses, init_s, launches, dims, peak = hybrid_session(
        ZAMBA_ARGV, cfg, ZAMBA_STEPS, [prof],
        draw=lambda: device_params(cfg, SEED))
    buckets = make_layout([(s, lm.torch_dtype(cfg)) for s in
                           leaves(lm.param_shapes(cfg))],
                          session.sync.bucket_bytes).n_buckets
    session.close()
    del session
    n_attn = cfg.n_layers // cfg.attn_every
    n_mamba = cfg.n_layers - n_attn
    print(f"4m (c) zamba2_7b (d 3584, d_inner 7168 in 112 SSD heads of 64, "
          f"ssm_state 64, shared block 32 heads of 112, d_ff 14336, vocab "
          f"32000; {ZAMBA_LAYERS} layers: {n_mamba} mamba2 and {n_attn} "
          f"use(s) of the shared block, {n} parameters, {buckets} buckets) "
          f"one peer "
          f"--sync optinc --bits 8 --lr 1e-5, seq 4096, {ZAMBA_STEPS} steps "
          f"(session init with the weights drawn on the card {init_s:.2f} "
          f"s; the last step profiled): "
          f"{step_line(recs[:-1], losses[:-1], 4096)}; last loss "
          f"{losses[-1]}; peak memory {peak} bytes ({peak / 1e9:.2f} GB) "
          f"against the reckoning {n * SYNCED_BYTES_PER_PARAM / 1e9:.2f} GB "
          f"({SYNCED_BYTES_PER_PARAM} B a parameter), {peak / n:.1f} B a "
          f"parameter measured; launches {launches}, flash by (hd x hdv) "
          f"{dims} [{card}]", flush=True)
    check_falling("4m (c) zamba2_7b", losses)
    want = ZAMBA_STEPS * n_attn
    if not (all(d == {"112x112": want} for d in dims.values())
            and launches["pam4_quantize_encode"] == ZAMBA_STEPS * buckets
            and launches["pam4_decode_dequantize"] == ZAMBA_STEPS * buckets):
        raise AssertionError(f"4m (c) launches {launches}, {dims}: want "
                             f"{want} flash at 112 x 112 and "
                             f"{ZAMBA_STEPS * buckets} of each pam4")
    dev = (device_profile(prof.prof, prof.wall_s, card, "zamba2_7b step")
           if prof.prof is not None else {})
    if dev:
        busy_ms = sum(dev.values()) / 1e3
        ssd_ms = ssd_scan_ms(cfg, 4096)
        print(f"4m (c) the SSD scan alone, forward and backward at the "
              f"step's shapes: {ssd_ms:.3f} ms a layer, x {n_mamba} layers "
              f"= {n_mamba * ssd_ms:.3f} ms, "
              f"{100 * n_mamba * ssd_ms / busy_ms:.2f}% of the profiled "
              f"step's {busy_ms:.3f} ms of device time [{card}]", flush=True)
    return dims


def hybrid_card_vs_plain(card: str) -> None:
    """(d) The qwen3, chameleon and zamba2 SMOKE steps card vs CPU
    (``smoke_card_vs_cpu``), and qwen3's SMOKE serving card vs CPU
    (``serving_card_vs_cpu``)."""
    from repro_torch.configs import get_smoke
    for arch in ("qwen3_32b", "chameleon_34b", "zamba2_7b"):
        smoke_card_vs_cpu(card, "4m (d)", arch)
    serving_card_vs_cpu(card, "4m (d) serving", dataclasses.replace(
        get_smoke("qwen3_32b"), dtype="float32"))


def hybrid_phase(card: str) -> dict:
    """Phase 4m: qk-norm and the Mamba-2 hybrid on one card, (a)-(d).
    Returns (a)'s records with the launches of (b) and (c)."""
    import torch
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    parts = {}       # seconds of each part

    def part(key, fn):
        t = time.perf_counter()
        out = fn(card)
        parts[key] = time.perf_counter() - t
        return out
    records = part("a", hybrid_flash)
    qwen = part("b", qwen_full_width)
    zamba = part("c", zamba_full_width)
    records["flash_attention 80x80"]["launches"] = qwen["flash"]
    records["flash_attention_bwd 80x80"]["launches"] = qwen["flash_bwd"]
    for fn in ("flash_attention", "flash_attention_bwd"):
        records[f"{fn} 112x112"]["launches"] = zamba[fn]["112x112"]
    records["paged_attention hd 80"]["launches"] = qwen["paged"]
    part("d", hybrid_card_vs_plain)
    print(f"phase 4m took {time.perf_counter() - t_phase:.1f} s ("
          + ", ".join(f"({k}) {v:.1f} s" for k, v in parts.items())
          + f") [{card}]", flush=True)
    return records


def hybrid_alone(card: str) -> None:
    """Phase 4m alone, the kernels built first."""
    from repro_torch.kernels import _build
    _build.build()
    hybrid_phase(card)


# ------------------------------------------- phase 4o: the xLSTM family
# (a)'s steps: step 0 warms up, steps 1 to XLSTM_STEPS - 2 are timed and
# the last is profiled
XLSTM_STEPS = 7
# (a): xlstm_125m at its published widths and depth, the JAX CLI's
# defaults for the sync, mesh, batch and sequence (phase 4's), lr 3e-4
XLSTM_ARGV = ["--arch", "xlstm_125m", "--sync", "optinc", "--bits", "8",
              "--mesh", "4x1", "--global-batch", "32", "--seq-len", "512",
              "--lr", "3e-4", "--device", "cuda"]
XLSTM_PEERS, XLSTM_ROWS, XLSTM_T = 4, 8, 512
# (b): ServeSession, 8 prompts of 128 tokens, 32 new
XLSTM_SERVE = (8, 128, 32)
# the optimiser's and the sync's bytes a parameter of a stacked run:
# bf16 weights 2, f32 moments 8, the f32 gradient stack 4 a peer, and
# while AdamW updates: the new moments 8 and the synced and the clipped
# gradients 4 each
STATE_BYTES_PER_PARAM = 2 + 8 + 8 + 4 + 4


def xlstm_reckoning(cfg, peers: int, b: int, t: int) -> dict:
    """The peak bytes a stacked xLSTM step should take, from the shapes:
    the state (STATE_BYTES_PER_PARAM + 4 a peer for the gradient stack)
    and one peer's activations, which autograd keeps until its backward:
    the f32 logits, their softmax and gradient (3 b t V); per mLSTM layer
    about 16 f32 tensors of the sequence at d_inner (q, k, v, the gate,
    the scan's terms), the chunk terms C (b, chunks, nh, hp, hp) and the
    states before each chunk, and 4 (b, chunks, nh, Q, Q) decay and
    weight tensors; per sLSTM layer about 16 f32 tensors of (b, d) a
    step."""
    n = n_params(cfg)
    n_s = cfg.n_layers // cfg.slstm_every
    n_m = cfg.n_layers - n_s
    nh, d, q = cfg.n_heads, cfg.d_model, 128
    hp, nc = 2 * d // nh, -(-t // q)
    state = n * (STATE_BYTES_PER_PARAM + 4 * peers)
    logits = 3 * b * t * cfg.vocab * 4
    mlstm = n_m * 4 * (16 * b * t * 2 * d + 2 * b * nc * nh * hp * hp
                       + 4 * b * nc * nh * q * q)
    slstm = n_s * 4 * 16 * b * t * d
    return {"state": state, "logits": logits, "mlstm": mlstm,
            "slstm": slstm, "total": state + logits + mlstm + slstm}


def _timed_block(fn, device_time: bool) -> float:
    """ms of fn() (forward and backward of one block), warmed once: by
    CUDA events over 3 calls (the device's time), or with
    ``device_time`` False by the host's clock to a synchronize (the
    wall, which a host-bound loop sets)."""
    import torch
    fn()
    torch.cuda.synchronize()
    if device_time:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 3
    t = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / 3 * 1e3


def xlstm_block_ms(cfg) -> dict:
    """At one peer's shapes of the step (b 8, t 512): the device ms of one
    mLSTM layer's chunk scan (``mlstm_chunk_scan`` alone, forward and
    backward, f32, chunk 128), and the wall ms of one sLSTM layer's loop
    forward and backward, as training runs it (``SLSTMScan``: CUDA
    graphs) and dispatched op by op (its two loops called as written),
    with the two gradients held bit for bit.  Each timed over 3 calls
    after a warm one."""
    import torch
    from repro_torch.models import blocks
    g = torch.Generator(device="cuda").manual_seed(SEED)
    b, t, d, nh = XLSTM_ROWS, XLSTM_T, cfg.d_model, cfg.n_heads
    hp = 2 * d // nh

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).requires_grad_()
    scan_in = [rand(b, t, nh, hp, scale=hp ** -0.5), rand(b, t, nh, hp),
               rand(b, t, nh, hp), rand(b, t, nh, scale=0.1), rand(b, t, nh)]

    def scan():
        q, k, v, f, i = scan_in
        y, c, n = blocks.mlstm_chunk_scan(
            q, k, v, torch.nn.functional.logsigmoid(f), i, 128)
        torch.autograd.grad(y.sum() + c.sum() + n.sum(), scan_in)
    hs = d // nh
    gates, r = rand(t, nh, b, 4 * hs), rand(nh, hs, hs, scale=0.02)
    d_h = torch.randn((t, nh, b, hs), generator=g, device="cuda")
    zeros = torch.zeros((nh, b, hs), device="cuda")
    init = (zeros, zeros, zeros, zeros - 30.0)
    grads = {}

    def graphed():
        out = blocks.SLSTMScan.apply(gates, r, *init)
        grads["graphed"] = torch.autograd.grad(out[0], (gates, r), d_h)

    def dispatched():
        with torch.no_grad():
            out = blocks._slstm_forward(gates, r, *init)
            grads["dispatched"] = blocks._slstm_backward(
                d_h, None, None, None, r, *out, *init)
    times = {"mlstm_scan": _timed_block(scan, True),
             "slstm_graphed": _timed_block(graphed, False),
             "slstm_dispatched": _timed_block(dispatched, False)}
    times["slstm_equal"] = all(torch.equal(a, b_) for a, b_ in zip(
        grads["graphed"], grads["dispatched"]))
    blocks.clear_graphs()
    return times


def xlstm_grads_finite(cfg, session) -> int:
    """The non-finite leaves of one peer's gradient (8 rows of the step-0
    batch, t 512) at the run's last parameters."""
    import torch
    from repro_torch.launch import steps as tsteps
    from repro_torch.tree import leaves
    tokens = torch.from_numpy(session.data.batch(0)[:XLSTM_ROWS]).cuda()
    sizes = [t.numel() for t in leaves(session.params)]
    _, flat = tsteps.peer_grad_stack(cfg, session.params, tokens, 1,
                                     sum(sizes))
    return sum(not torch.isfinite(g).all().item()
               for g in flat[0].split(sizes))


def xlstm_train_full_width(card: str) -> dict:
    """(a) xlstm_125m at its published widths and depth (12 layers: 3 x (3
    mLSTM + 1 sLSTM); d 768, 4 heads, vocab 50304), bf16, 4 stacked
    peers x 8 rows, t 512, ``--sync optinc --bits 8 --mesh 4x1 --lr
    3e-4``, the seeded weights drawn on the card, XLSTM_STEPS steps, the
    last profiled: finite falling losses, every gradient of a peer finite
    at t 512 after the run, step p50/p99 over the unprofiled steps after
    the first, tokens/s, peak memory beside the reckoning, pam4 once a
    bucket, the busy share, the sLSTM loops' share of the wall and the
    mLSTM chunk scans' share of the device time.  Returns the launches."""
    from repro_torch.collectives.bucketizer import make_layout
    from repro_torch.configs import get
    from repro_torch.models import lm
    from repro_torch.tree import leaves
    cfg = get("xlstm_125m")
    n = n_params(cfg)
    n_s = cfg.n_layers // cfg.slstm_every
    n_m = cfg.n_layers - n_s
    prof = profile_step(XLSTM_STEPS - 1, cpu=False)
    session, recs, losses, init_s, launches, _, peak = hybrid_session(
        XLSTM_ARGV, cfg, XLSTM_STEPS, [prof],
        draw=lambda: device_params(cfg, SEED))
    buckets = make_layout([(s, lm.torch_dtype(cfg)) for s in
                           leaves(lm.param_shapes(cfg))],
                          session.sync.bucket_bytes).n_buckets
    bad = xlstm_grads_finite(cfg, session)
    n_leaves = len(leaves(session.params))
    session.close()
    del session
    reckon = xlstm_reckoning(cfg, XLSTM_PEERS, XLSTM_ROWS, XLSTM_T)
    tokens = XLSTM_PEERS * XLSTM_ROWS * XLSTM_T
    print(f"4o (a) xlstm_125m (d 768; {n_m} mLSTM layers of d_inner 1536 "
          f"in 4 heads of 384, {n_s} sLSTM layers of 4 heads of 192; vocab "
          f"50304; {n} parameters, {buckets} buckets) {XLSTM_PEERS} stacked "
          f"peers x {XLSTM_ROWS} rows, --sync optinc --bits 8 --lr 3e-4, "
          f"seq {XLSTM_T}, {XLSTM_STEPS} steps (session init with the "
          f"weights drawn on the card {init_s:.2f} s; the last step "
          f"profiled): {step_line(recs[:-1], losses[:-1], tokens)}; last "
          f"loss {losses[-1]}; non-finite gradient leaves of a peer at t "
          f"{XLSTM_T} after the run: {bad} of {n_leaves}; peak "
          f"memory {peak} bytes ({peak / 1e9:.2f} GB) against the "
          f"reckoning {reckon['total'] / 1e9:.2f} GB (state "
          f"{reckon['state'] / 1e9:.2f}, logits {reckon['logits'] / 1e9:.2f}"
          f", mLSTM {reckon['mlstm'] / 1e9:.2f}, sLSTM "
          f"{reckon['slstm'] / 1e9:.2f}); launches {launches} [{card}]",
          flush=True)
    check_falling("4o (a) xlstm_125m", losses)
    if bad:
        raise AssertionError(f"4o (a): {bad} non-finite gradient leaves")
    want = XLSTM_STEPS * buckets
    if not (launches["pam4_quantize_encode"] == want
            and launches["pam4_decode_dequantize"] == want):
        raise AssertionError(f"4o (a) launches {launches}: want {want} of "
                             f"each pam4 (once a bucket a step)")
    step_ms = pct([r["time_s"] for r in recs[1:-1]], 0.5) * 1e3
    ms = xlstm_block_ms(cfg)
    slstm_ms = XLSTM_PEERS * n_s * ms["slstm_graphed"]
    print(f"4o (a) the sLSTM loop alone, forward and backward at a peer's "
          f"shapes (b {XLSTM_ROWS}, t {XLSTM_T}): "
          f"{ms['slstm_graphed']:.3f} ms of wall a layer as CUDA graphs "
          f"(dispatched op by op from the host: "
          f"{ms['slstm_dispatched']:.3f} ms; gradients bit-equal "
          f"{ms['slstm_equal']}), x {n_s} layers x {XLSTM_PEERS} peers = "
          f"{slstm_ms:.3f} ms, {100 * slstm_ms / step_ms:.2f}% of the step's "
          f"p50 {step_ms:.3f} ms [{card}]", flush=True)
    if not ms["slstm_equal"]:
        raise AssertionError("4o (a): the graphed sLSTM loop's gradients "
                             "differ from the dispatched loop's")
    t = time.perf_counter()
    dev = (device_profile(prof.prof, prof.wall_s, card, "xlstm_125m step")
           if prof.prof is not None else {})
    print(f"4o (a) the profiler's report of the step took "
          f"{time.perf_counter() - t:.1f} s [{card}]", flush=True)
    if dev:
        busy_ms = sum(dev.values()) / 1e3
        scan_ms = XLSTM_PEERS * n_m * ms["mlstm_scan"]
        print(f"4o (a) the mLSTM chunk scan alone, forward and backward at "
              f"a peer's shapes: {ms['mlstm_scan']:.3f} ms of device time a "
              f"layer, x {n_m} layers x {XLSTM_PEERS} peers = "
              f"{scan_ms:.3f} ms, {100 * scan_ms / busy_ms:.2f}% of the "
              f"profiled step's {busy_ms:.3f} ms of device time [{card}]",
              flush=True)
    return launches


def xlstm_serve_full_width(card: str) -> None:
    """(b) ServeSession on xlstm_125m at its published widths (bf16,
    seeded weights drawn on the card): 8 prompts of 128 tokens, one
    prefill (the mLSTM's chunk scan, the sLSTM's loop) and 32 greedy
    tokens a prompt through the recurrent decode step: prefill ms, decode
    step p50/p99, output tokens/s over the prefill and the decodes."""
    import torch
    from repro_torch.api import RunSpec, ServeSession
    from repro_torch.configs import get
    cfg = get("xlstm_125m")
    b, t, new = XLSTM_SERVE
    sess = ServeSession(RunSpec(arch="xlstm_125m"),
                        params=device_params(cfg, SEED + 1), device="cuda")
    prompts = torch.randint(0, cfg.vocab, (b, t), device="cuda",
                            generator=torch.Generator(
                                device="cuda").manual_seed(SEED + 2))
    sess.generate(prompts[:1, :16], 2)                   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = sess.prefill(prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = logits.argmax(-1)[:, None]
    out, times = [tok], []
    for i in range(new - 1):
        t1 = time.perf_counter()
        logits, state = sess.decode(state, tok, t + i)
        tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        out.append(tok)
    wall = time.perf_counter() - t0
    gen = torch.cat(out, dim=1)
    same = torch.equal(gen, sess.generate(prompts, new))
    state_mb = sum(v.numel() * 4 for kind in state.values()
                   for v in kind.values()) / 1e6
    print(f"4o (b) xlstm_125m (bf16) served by ServeSession: {b} prompts "
          f"of {t} tokens x {new} new: prefill {prefill_s * 1e3:.2f} ms, "
          f"decode step p50 {pct(times, 0.5) * 1e3:.2f} ms p99 "
          f"{pct(times, 0.99) * 1e3:.2f} ms over {len(times)} steps, "
          f"{b * new / wall:.1f} output tokens/s ({wall:.3f} s); recurrent "
          f"state {state_mb:.1f} MB for the batch, whatever the length; "
          f"generate() gives the same tokens: {same} [{card}]", flush=True)
    if not (same and torch.isfinite(logits).all()):
        raise AssertionError("4o (b) serving disagrees with generate()")


def session_forced_logits(sess, prompts, forced, max_seq=None,
                          **frames) -> "torch.Tensor":
    """Logits of ServeSession's prefill and each decode step over the
    contiguous cache (the prefill's seeded into one of ``max_seq``, by
    default just long enough), feeding ``forced`` tokens (n, steps)
    instead of sampling: (n, steps, V) on the CPU.  ``frames``: the
    enc-dec family's ``enc_frames``."""
    import torch
    from repro_torch.api import build
    n, t = prompts.shape
    logits, pre = sess.prefill(prompts, **frames)
    cache = build.seed_cache(sess.new_cache(
        n, max_seq or t + forced.shape[1]), pre)
    out = [logits]
    for j in range(forced.shape[1] - 1):
        logits, cache = sess.decode(cache, forced[:, j:j + 1], t + j)
        out.append(logits)
    return torch.stack(out, dim=1).float().cpu()


def contiguous_serving_card_vs_cpu(card: str, label: str,
                                   arch: str) -> None:
    """``arch``'s SMOKE config (f32) served by ServeSession on its
    contiguous path on the card and on the CPU from the same seeded
    weights, 4 prompts of 40 tokens x 16 new: the teacher-forced logits
    within LOGIT_TOL, and the greedy tokens equal up to the first
    position where the plain top-2 margin is thinner than 2 LOGIT_TOL
    (phase 5's rule).  The enc-dec family takes 4 prompts of 16 tokens
    with seeded frames, over caches of its frame count (32)."""
    import numpy as np
    import torch
    from repro_torch.api import RunSpec, ServeSession
    from repro_torch.configs import get_smoke
    from repro_torch.models import lm
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    spec = RunSpec(arch=arch, smoke=True)
    params = lm.init_params(cfg, SEED, "cpu")
    cpu = ServeSession(spec, params, device="cpu", cfg=cfg)
    gpu = ServeSession(spec, tree_map(lambda t: t.cuda(), params),
                       device="cuda", cfg=cfg)
    g = torch.Generator().manual_seed(SEED)
    t, new = (16, 16) if cfg.enc_dec else (40, 16)
    prompts = torch.randint(0, cfg.vocab, (4, t), generator=g)
    kw, kw_gpu = {}, {}
    if cfg.enc_dec:
        frames = torch.randn((4, cfg.enc_frames, cfg.d_model), generator=g)
        kw = {"max_seq": cfg.enc_frames, "enc_frames": frames}
        kw_gpu = {**kw, "enc_frames": frames.cuda()}
    plain = cpu.generate(prompts, new, **kw)
    card_out = gpu.generate(prompts, new, **kw_gpu).cpu()
    lg_cpu = session_forced_logits(cpu, prompts, plain, **kw)
    lg_gpu = session_forced_logits(gpu, prompts.cuda(), plain.cuda(),
                                   **kw_gpu)
    err = (lg_cpu - lg_gpu).abs().max().item()
    print(f"{label} ({cfg.name} f32, ServeSession, 4 prompts of {t} tokens x "
          f"{new}): teacher-forced logits max_abs_err {err:.3e} (tol "
          f"{LOGIT_TOL:.0e}), |logits| max {lg_cpu.abs().max().item():.3f}",
          flush=True)
    if not err <= LOGIT_TOL:
        raise AssertionError(f"{label}: card logits disagree: {err}")
    top2 = lg_cpu.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).numpy()
    for i in range(len(prompts)):
        thin = np.nonzero(margin[i] < 2 * LOGIT_TOL)[0]
        upto = int(thin[0]) if thin.size else new
        if not torch.equal(card_out[i, :upto], plain[i, :upto]):
            raise AssertionError(
                f"{label} prompt {i}: card tokens {card_out[i].tolist()} != "
                f"plain {plain[i].tolist()} before position {upto}")
    equal = sum(torch.equal(card_out[i], plain[i]) for i in range(len(plain)))
    print(f"{label} greedy tokens: {equal}/{len(plain)} prompts identical on "
          f"card and plain [{card}]", flush=True)


def xlstm_card_vs_plain(card: str) -> None:
    """(c) The xLSTM SMOKE step in f32 card vs CPU (``smoke_card_vs_cpu``:
    t 128, the loss and the gradients within phase 5's tolerances, the
    synced gradients bit for bit) and its ServeSession card vs CPU."""
    smoke_card_vs_cpu(card, "4o (c)", "xlstm_125m")
    contiguous_serving_card_vs_cpu(card, "4o (c) serving", "xlstm_125m")


def xlstm_phase(card: str) -> dict:
    """Phase 4o: the xLSTM family on one card, (a)-(c).  Returns (a)'s
    launches."""
    import torch
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    parts = {}

    def part(key, fn):
        t = time.perf_counter()
        out = fn(card)
        parts[key] = time.perf_counter() - t
        return out
    launches = part("a", xlstm_train_full_width)
    part("b", xlstm_serve_full_width)
    part("c", xlstm_card_vs_plain)
    print(f"phase 4o took {time.perf_counter() - t_phase:.1f} s ("
          + ", ".join(f"({k}) {v:.1f} s" for k, v in parts.items())
          + f") [{card}]", flush=True)
    return launches


def xlstm_alone(card: str) -> None:
    """Phase 4o alone, the kernels built first."""
    from repro_torch.kernels import _build
    _build.build()
    xlstm_phase(card)


# ------------------- phase 4p: ServeSession on the MoE and hybrid families
# (b)-(d): the published widths, depth cut to fit one card (phi35 as 4k
# cuts it; deepseek_v3 to its 3 dense layers and 1 MoE layer; zamba2 as
# 4m cuts it: 6 mamba2 layers and one use of the shared block); weights
# drawn on the card; XLSTM_SERVE's traffic, 8 prompts of 128 x 32 new
SERVE_FAMILIES = (("b", "phi35_moe_42b", 1), ("c", "deepseek_v3_671b", 4),
                  ("d", "zamba2_7b", 7))
# (a): the paged kernel over a contiguous cache (b, hkv, S, hd) taken as
# b pages of S positions, one a row: (label, b, h, hkv, hd, S, lengths,
# dtype); the timed shape is each model's decode at 8 x (128 + 16)
PAGED_ROWS = (("phi35_moe_42b", 8, 32, 8, 128, 160,
               list(range(129, 161, 4)), "bfloat16"),
              ("zamba2_7b", 8, 32, 32, 112, 160,
               list(range(129, 161, 4)), "bfloat16"),
              ("ragged f32", 3, 4, 2, 48, 37, [1, 20, 37], "float32"))


def one_page_a_row(b, h, hkv, hd, s_len, lengths, dtype, seed):
    """q (b, h, 1, hd) and a contiguous cache (b, hkv, S, hd) on the card,
    with the table arange(b)[:, None] and the lengths: what
    ``blocks.gqa_decode`` hands the paged kernel."""
    import torch
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, h, 1, hd), generator=g).to(dtype)
    kc = torch.randn((b, hkv, s_len, hd), generator=g).to(dtype)
    vc = torch.randn((b, hkv, s_len, hd), generator=g).to(dtype)
    table = torch.arange(b, dtype=torch.int32)[:, None]
    ln = torch.tensor(lengths, dtype=torch.int32)
    return [t.cuda() for t in (q, kc, vc, table, ln)]


def sdpa_rows(q, kc, vc, tb, ln, n: int):
    """The yardstick of a decode over the contiguous cache: SDPA of the
    pending queries over the cache's first n = pos + 1 columns (every
    row's length; given on the host, as the model's step knows pos),
    GQA where the cache has fewer heads."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q, kc[:, :, :n], vc[:, :, :n], enable_gqa=q.shape[1] != kc.shape[1])


def paged_rows_check(card: str) -> dict:
    """(a) The paged kernel with one page a row against its plain version
    at PAGED_ROWS, its plan and the build report's lines for the
    instantiations it takes; the bf16 cases timed at all rows of length
    144 (decode step 16 after 128 prompt tokens) beside the plain
    version, SDPA and the bound.  Returns their records (launches set by
    (b)-(d))."""
    import re
    import torch
    from repro_torch.kernels import _build, paged_attention, ref
    path = _build.build(["paged_attention"])["paged_attention"]
    stats = ptxas_stats(path)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    records = {}
    for label, b, h, hkv, hd, s_len, lengths, dt in PAGED_ROWS:
        dtype = getattr(torch, dt)
        args = one_page_a_row(b, h, hkv, hd, s_len, lengths, dtype, SEED)
        got = paged_attention.paged_attention(*args).float()
        err = (got - ref.paged_attention_ref(*args).float()).abs().max().item()
        p = paged_attention.plan(b, h, hkv, s_len, hd, 1,
                                 args[1].element_size(), 16, sms)
        tol = KERNEL_TOL[dt]
        print(f"4p (a) paged_attention one page a row, {label}: b={b} h={h} "
              f"hkv={hkv} hd={hd} S={s_len} lengths={lengths} {dt}: "
              f"max_abs_err {err:.3e} (tol {tol:.0e}); split {p.split} x "
              f"{p.n_splits}, {p.vec_bytes}-byte loads, {p.rows} rows a "
              f"block", flush=True)
        if not err <= tol:
            raise AssertionError(f"4p (a) paged {label}: {err} > {tol}")
        tmpl = "bfloat16" if dt == "bfloat16" else "float"
        for short, _, st in stats:
            if re.search(rf"paged_split_kernel<[^,]*{tmpl}[^,]*, "
                         rf"{p.vec_bytes}, {p.rows}>", short):
                print(f"  4p (a) {short}: {st.get('regs')} registers, "
                      f"{st['spill'][0]} bytes spill stores, "
                      f"{st['spill'][1]} bytes spill loads", flush=True)
        if not any(re.search(rf"paged_split_kernel<[^,]*{tmpl}[^,]*, "
                             rf"{p.vec_bytes}, {p.rows}>", short)
                   for short, _, _ in stats):
            print("  4p (a) no demangled paged_split_kernel name matched: "
                  "phase 2's build report lists them all", flush=True)
        if dt != "bfloat16":
            continue
        timed = [144] * b
        args[4] = torch.full((b,), 144, dtype=torch.int32, device="cuda")
        ins = copies_for(args)
        ms = time_ms(paged_attention.paged_attention, ins)[0]
        plain_ms = time_ms(ref.paged_attention_ref, ins, iters=20)[0]
        lib_ms = time_ms(functools.partial(sdpa_rows, n=144), ins)[0]
        bound, by = paged_bounds(b, h, hkv, hd, s_len, timed, dtype)
        print(f"4p (a) paged_attention one page a row, {label}, all rows "
              f"at length 144 of S {s_len}: kernel {ms * 1e3:.2f} us, plain "
              f"{plain_ms * 1e3:.2f} us, SDPA over the first 144 columns "
              f"{lib_ms * 1e3:.2f} us, bound {bound * 1e3:.3f} us ({by}) "
              f"[{card}]", flush=True)
        records[f"paged_attention row {label}"] = dict(
            name=f"paged_attention (one page a row, hd {hd}, {label})",
            route="cuda", source="src/repro_torch/csrc/paged_attention.cu",
            replaces="src/repro/kernels/paged_attention.py:108",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=by, library_ms=lib_ms, launches=0)
    return records


def cache_bytes(tree) -> int:
    from repro_torch.tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def serve_family_full_width(card: str, part: str, arch: str,
                            layers: int) -> dict:
    """ServeSession on ``arch`` at its published widths cut to ``layers``
    (bf16, seeded weights drawn on the card): XLSTM_SERVE's 8 prompts of
    128 tokens, one prefill and 31 decode steps over the contiguous
    cache seeded to 160 positions: prefill ms, decode step p50/p99,
    output tokens/s, peak memory beside the reckoning (the weights and
    both caches), and the flash launches by head dims and the paged
    launches of that run (counts set to 0 just before it): one flash
    launch an attention layer for the prefill, one paged launch a GQA
    layer a decode step.  The tokens must equal ``generate``'s.  Returns
    {kernel: launches}."""
    import torch
    from repro_torch.api import RunSpec, ServeSession, build
    from repro_torch.configs import get
    from repro_torch.kernels import attention, paged_attention
    from repro_torch.models import lm
    cfg = dataclasses.replace(get(arch), n_layers=layers)
    b, t, new = XLSTM_SERVE
    gc.collect()
    torch.cuda.empty_cache()
    sess = ServeSession(RunSpec(arch=arch), params=device_params(
        cfg, SEED + 3), device="cuda", cfg=cfg)
    weights = cache_bytes(sess.params)
    prompts = torch.randint(0, cfg.vocab, (b, t), device="cuda",
                            generator=torch.Generator(
                                device="cuda").manual_seed(SEED + 4))
    sess.generate(prompts[:1, :16], 2)                   # warm
    flash, paged = attention.flash_attention, paged_attention.paged_attention
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.launches, flash.launches_by_dims = 0, {}
    paged.launches = 0
    t0 = time.perf_counter()
    logits, pre = sess.prefill(prompts)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    cache = build.seed_cache(sess.new_cache(b, t + new), pre)
    tok = logits.argmax(-1)[:, None]
    out, times = [tok], []
    for i in range(new - 1):
        t1 = time.perf_counter()
        logits, cache = sess.decode(cache, tok, t + i)
        tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        out.append(tok)
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash.launches,
                "paged_attention": paged.launches}
    dims = dict(flash.launches_by_dims)
    peak = torch.cuda.max_memory_allocated()
    reckon = weights + cache_bytes(pre) + cache_bytes(cache)
    gen = torch.cat(out, dim=1)
    same = torch.equal(gen, sess.generate(prompts, new))
    n_attn = (layers // cfg.attn_every if cfg.ssm else layers)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for i in range(4):               # positions 128-131 written again
            sess.decode(cache, tok, t + i)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t1
    n_gqa = 0 if cfg.mla else n_attn
    print(f"4p ({part}) {arch} ({layers} layers of {get(arch).n_layers}, "
          f"{n_params(cfg):,} parameters, bf16) served by ServeSession: {b} "
          f"prompts of {t} tokens x {new} new: prefill {prefill_s * 1e3:.2f} "
          f"ms, decode step p50 {pct(times, 0.5) * 1e3:.2f} ms p99 "
          f"{pct(times, 0.99) * 1e3:.2f} ms over {len(times)} steps, "
          f"{b * new / wall:.1f} output tokens/s ({wall:.3f} s); peak "
          f"{peak / 1e9:.2f} GB beside the reckoning {reckon / 1e9:.2f} GB "
          f"(weights {weights / 1e9:.2f}, the caches "
          f"{(reckon - weights) / 1e6:.1f} MB); flash launches by dims "
          f"{dims}, paged launches {launches['paged_attention']}; "
          f"generate() gives the same tokens: {same} [{card}]", flush=True)
    device_profile(prof, prof_s, card, f"4p ({part}) {arch}, 4 decode "
                   f"steps (after the counted run)")
    want = {"flash_attention": n_attn, "paged_attention": n_gqa * (new - 1)}
    if launches != want:
        raise AssertionError(f"4p ({part}) {arch}: launches {launches}, want "
                             f"{want}")
    if not (same and torch.isfinite(logits).all()):
        raise AssertionError(f"4p ({part}) {arch}: decode disagrees with "
                             f"generate() or the logits are not finite")
    del sess, pre, cache
    return launches


def serve_families_phase(card: str) -> dict:
    """Phase 4p: ServeSession on the MoE family and the Mamba-2 hybrid, on
    one card, (a)-(e).  Returns (a)'s records, their launches from
    (b)-(d)."""
    import torch
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    parts = {}
    t = time.perf_counter()
    records = paged_rows_check(card)
    parts["a"] = time.perf_counter() - t
    for part, arch, layers in SERVE_FAMILIES:
        t = time.perf_counter()
        launches = serve_family_full_width(card, part, arch, layers)
        parts[part] = time.perf_counter() - t
        for rec in records.values():
            if arch in rec["name"]:
                rec["launches"] = launches["paged_attention"]
    t = time.perf_counter()
    for arch in ("phi35_moe_42b", "deepseek_v3_671b", "zamba2_7b"):
        contiguous_serving_card_vs_cpu(card, "4p (e)", arch)
    parts["e"] = time.perf_counter() - t
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 4p took {time.perf_counter() - t_phase:.1f} s ("
          + ", ".join(f"({k}) {v:.1f} s" for k, v in parts.items())
          + f") [{card}]", flush=True)
    return records


def serve_families_alone(card: str) -> None:
    """Phase 4p alone, the kernels built first."""
    from repro_torch.kernels import _build
    _build.build()
    serve_families_phase(card)


# -------------------------- phase 4q: ServeSession on the enc-dec family
# whisper_tiny at its published widths and depth (4 + 4 layers, d 384, 6
# heads of 64, vocab 51865, 1500 frames), bf16, weights drawn on the
# card; XLSTM_SERVE's traffic (8 prompts of 128 x 32 new) over caches of
# WHISPER_MAX_SEQ = the frame count, the one length whose decode has no
# zero cross column
WHISPER_MAX_SEQ = 1500
# (a): the paged kernel one page a row at whisper's heads over S 1500:
# the decode's self rows (lengths of positions 129-160) and cross rows
# (every column), and a ragged f32 case; (label, b, h, hkv, hd, S,
# lengths, dtype)
WHISPER_PAGED_ROWS = (
    ("self", 8, 6, 6, 64, 1500, list(range(129, 157, 4)) + [160], "bfloat16"),
    ("cross", 8, 6, 6, 64, 1500, [1500] * 8, "bfloat16"),
    ("ragged f32", 3, 6, 6, 64, 37, [1, 20, 37], "float32"))
# the other form timed beside the plan's one split of the whole row:
# the same K/V copied into a pool of pages of this many positions, which
# the plan splits over the SMs (a split is a whole number of pages)
WHISPER_POOL_PAGE = 16
# (d): lm_loss at qwen3_32b's vocabulary and width, b 1, t 4096, bf16
# head; the chunked form against one chunk: the loss relative to its
# value (f32 sums of 4096 NLLs in another grouping) and each gradient
# relative to its largest entry (bf16 outputs, one rounding apart)
LM_LOSS_SHAPE = (1, 4096, 5120, 151936)
LM_LOSS_RTOL = 1e-5
LM_LOSS_GRAD_RTOL = 1e-2
LM_LOSS_REPS = 5        # timed calls of each form, after one to warm up


def whisper_paged_rows(card: str) -> dict:
    """(a) The paged kernel with the contiguous cache as one page a row
    at whisper's heads against its plain version (WHISPER_PAGED_ROWS),
    its plan and the build report's line for the instantiation it takes;
    the bf16 cases timed (self: every row at length 144, decode step 16
    after 128 prompt tokens; cross: every row at 1500) beside the plain
    version, SDPA over the same columns, the bound, and the kernel over
    the same K/V in a pool of WHISPER_POOL_PAGE-position pages (the form
    the plan can split).  Returns the cross case's record (launches set
    by (b))."""
    import re
    import torch
    from repro_torch.kernels import _build, paged_attention, ref
    path = _build.build(["paged_attention"])["paged_attention"]
    stats = ptxas_stats(path)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    records = {}
    for label, b, h, hkv, hd, s_len, lengths, dt in WHISPER_PAGED_ROWS:
        dtype = getattr(torch, dt)
        args = one_page_a_row(b, h, hkv, hd, s_len, lengths, dtype, SEED + 1)
        got = paged_attention.paged_attention(*args).float()
        err = (got - ref.paged_attention_ref(*args).float()).abs().max().item()
        p = paged_attention.plan(b, h, hkv, s_len, hd, 1,
                                 args[1].element_size(), 16, sms)
        tol = KERNEL_TOL[dt]
        print(f"4q (a) paged_attention one page a row, whisper {label}: b={b}"
              f" h={h} hkv={hkv} hd={hd} S={s_len} lengths {min(lengths)}-"
              f"{max(lengths)} {dt}: max_abs_err {err:.3e} (tol {tol:.0e}); "
              f"plan: split {p.split} x {p.n_splits}, grid {p.grid} = "
              f"{math.prod(p.grid)} blocks for {sms} SMs, {p.vec_bytes}-byte "
              f"loads, {p.rows} rows a block", flush=True)
        if not err <= tol:
            raise AssertionError(f"4q (a) paged {label}: {err} > {tol}")
        tmpl = "__nv_bfloat16" if dt == "bfloat16" else "float"
        pat = rf"paged_split_kernel<{tmpl}, {p.vec_bytes}, {p.rows}>"
        for short, _, st in stats:
            if re.search(pat, short):
                print(f"  4q (a) {short}: {st.get('regs')} registers, "
                      f"{st['spill'][0]} bytes spill stores, "
                      f"{st['spill'][1]} bytes spill loads", flush=True)
        if dt != "bfloat16":
            continue
        n = 144 if label == "self" else s_len
        args[4] = torch.full((b,), n, dtype=torch.int32, device="cuda")
        ins = copies_for(args)
        ms = time_ms(paged_attention.paged_attention, ins)[0]
        plain_ms = time_ms(ref.paged_attention_ref, ins, iters=20)[0]
        lib_ms = time_ms(functools.partial(sdpa_rows, n=n), ins)[0]
        pool = as_page_pool(*args, WHISPER_POOL_PAGE)
        pool_ms = time_ms(paged_attention.paged_attention,
                          copies_for(pool))[0]
        pp = paged_attention.plan(b, h, hkv, WHISPER_POOL_PAGE, hd,
                                  pool[3].shape[1], 2, 16, sms)
        bound, by = paged_bounds(b, h, hkv, hd, s_len, [n] * b, dtype)
        print(f"4q (a) paged_attention one page a row, whisper {label}, all "
              f"rows at length {n} of S {s_len}: kernel {ms * 1e3:.2f} us "
              f"(the plan's one split a row), plain {plain_ms * 1e3:.2f} us,"
              f" SDPA over the first {n} columns {lib_ms * 1e3:.2f} us, "
              f"bound {bound * 1e3:.3f} us ({by}); the same K/V in a pool "
              f"of {WHISPER_POOL_PAGE}-position pages {pool_ms * 1e3:.2f} us "
              f"(split {pp.split} x {pp.n_splits}, grid {pp.grid}) "
              f"[{card}]", flush=True)
        if label == "cross":
            records["paged_attention row whisper_tiny"] = dict(
                name="paged_attention (one page a row, hd 64, whisper_tiny:"
                     " the cross rows timed; launches: every self and cross"
                     " decode of 4q (b))",
                route="cuda", source="src/repro_torch/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:108",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib_ms, launches=0)
    return records


def whisper_cross_flash(card: str) -> dict:
    """(a) The flash forward, non-causal, at the serving prefill's cross
    shape (8 prompts of 128 queries over 1500 frames, 6 heads of 64,
    bf16, no lse: serving takes no gradient) against its plain version
    (bf16 limits, each row against its own scale too), timed beside the
    plain version, SDPA and the bound.  (The encoder's 8 x 1500^2 shape
    is phase 4l's.)  Returns its record (launches set by (b))."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import attention, ref
    shape = (8, 6, 6, 64, 128, 1500, torch.bfloat16)
    q, k, v = flash_case(*shape, SEED + 2)
    o = attention.flash_attention(q, k, v, causal=False)
    want = ref.attention_fwd_ref(q, k, v, False)[0]
    err = (o.float() - want.float()).abs().max().item()
    row, mean = row_and_mean_errs(o, want)
    ins = copies_for([q, k, v])
    ms = time_ms(lambda q, k, v: attention.flash_attention(
        q, k, v, causal=False), ins)[0]
    plain_ms = time_ms(lambda q, k, v: ref.attention_fwd_ref(
        q, k, v, False), ins, iters=10)[0]
    lib_ms = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v), ins)[0]
    bound, by = flash_bounds(*shape, causal=False)
    print(f"4q (a) flash_attention non-causal at the prefill's cross shape "
          f"b=8 h=6 hd=64 sq=128 skv=1500 bfloat16: max_abs_err {err:.3e} "
          f"(tol {KERNEL_TOL['bfloat16']}), max over rows of max|err| / "
          f"max|ref| {row:.3e} (tol {FLASH_ROW_TOL:.3e}), mean|err| / "
          f"mean|ref| {mean:.3e} (tol {FLASH_MEAN_TOL:.3e}); kernel "
          f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, SDPA "
          f"{lib_ms * 1e3:.2f} us, bound {bound * 1e3:.3f} us ({by}) "
          f"[{card}]", flush=True)
    if not (err <= KERNEL_TOL["bfloat16"] and row <= FLASH_ROW_TOL
            and mean <= FLASH_MEAN_TOL):
        raise AssertionError(f"4q (a) flash cross: {err}, {row}, {mean}")
    return {"flash_attention serve cross": dict(
        name="flash_attention (non-causal, whisper_tiny's serving cross: "
             "launches: every flash launch of 4q (b)'s prefill)",
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/attention.py:63", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=lib_ms, launches=0)}


def as_page_pool(q, kc, vc, table, ln, page: int):
    """The contiguous cache (b, hkv, S, hd) copied into a pool of pages
    of ``page`` positions (S padded with zeros to a whole page; pool page
    0 the null page), with each row's table: (q, k pool, v pool, table,
    lengths), what the paged engine's decode hands the kernel."""
    import torch
    import torch.nn.functional as F
    b, hkv, s_len, hd = kc.shape
    nb = -(-s_len // page)

    def pool(c):
        c = F.pad(c, (0, 0, 0, nb * page - s_len))
        c = c.reshape(b, hkv, nb, page, hd).transpose(1, 2)
        return F.pad(c.reshape(b * nb, hkv, page, hd),
                     (0, 0, 0, 0, 0, 0, 1, 0)).contiguous()
    rows = 1 + torch.arange(b * nb, dtype=torch.int32, device=kc.device)
    return q, pool(kc), pool(vc), rows.reshape(b, nb), ln


def whisper_frames(cfg, b: int, seed: int):
    """Seeded ``enc_frames`` (b, frames, d) f32 on the card (the conv
    front end is a stub in both packages: the frames are its output)."""
    import torch
    return torch.randn((b, cfg.enc_frames, cfg.d_model), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(
                           seed))


def whisper_serve_full_width(card: str) -> dict:
    """(b) ServeSession on whisper_tiny at its published widths and depth
    (bf16, seeded weights drawn on the card): XLSTM_SERVE's 8 prompts of
    128 tokens with seeded frames, one prefill and 31 decode steps over
    caches of WHISPER_MAX_SEQ: prefill ms, decode step p50/p99, output
    tokens/s, peak memory beside the reckoning (the weights, the
    prefill's and the decode's caches), a profiled window of 4 decode
    steps, and the launches of the counted run (counts set to 0 just
    before it): flash 8 non-causal (4 encoder layers, 4 cross) and 4
    causal a prefill, paged 8 a decode step (4 self, 4 cross).  The
    tokens must equal ``generate``'s.  Returns {kernel: launches}."""
    import torch
    from repro_torch.api import RunSpec, ServeSession, build
    from repro_torch.configs import get
    from repro_torch.kernels import attention, paged_attention
    cfg = get("whisper_tiny")
    b, t, new = XLSTM_SERVE
    gc.collect()
    torch.cuda.empty_cache()
    sess = ServeSession(RunSpec(arch="whisper_tiny"),
                        params=device_params(cfg, SEED + 5), device="cuda",
                        cfg=cfg)
    weights = cache_bytes(sess.params)
    prompts = torch.randint(0, cfg.vocab, (b, t), device="cuda",
                            generator=torch.Generator(
                                device="cuda").manual_seed(SEED + 6))
    frames = whisper_frames(cfg, b, SEED + 7)
    sess.generate(prompts[:1, :16], 2, max_seq=WHISPER_MAX_SEQ,
                  enc_frames=frames[:1])                       # warm
    flash, paged = attention.flash_attention, paged_attention.paged_attention
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.launches, flash.launches_by_mode = 0, {}
    paged.launches = 0
    t0 = time.perf_counter()
    logits, pre = sess.prefill(prompts, enc_frames=frames)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    by_mode = dict(flash.launches_by_mode)
    cache = build.seed_cache(sess.new_cache(b, WHISPER_MAX_SEQ), pre)
    tok = logits.argmax(-1)[:, None]
    out, times = [tok], []
    for i in range(new - 1):
        t1 = time.perf_counter()
        logits, cache = sess.decode(cache, tok, t + i)
        tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        out.append(tok)
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash.launches,
                "paged_attention": paged.launches}
    peak = torch.cuda.max_memory_allocated()
    caches = cache_bytes(pre) + cache_bytes(cache)
    gen = torch.cat(out, dim=1)
    same = torch.equal(gen, sess.generate(prompts, new,
                                          max_seq=WHISPER_MAX_SEQ,
                                          enc_frames=frames))
    t1 = time.perf_counter()
    sess.prefill(prompts, enc_frames=frames)
    torch.cuda.synchronize()
    prefill_again_s = time.perf_counter() - t1
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for i in range(4):               # positions 128-131 written again
            sess.decode(cache, tok, t + i)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t1
    print(f"4q (b) whisper_tiny ({cfg.n_enc_layers} + {cfg.n_layers} layers,"
          f" {n_params(cfg):,} parameters, bf16) served by ServeSession: {b}"
          f" prompts of {t} tokens x {new} new, {cfg.enc_frames} frames, "
          f"max_seq {WHISPER_MAX_SEQ}: prefill {prefill_s * 1e3:.2f} ms "
          f"(the first at this shape; {prefill_again_s * 1e3:.2f} ms after "
          f"generate()), "
          f"decode step p50 {pct(times, 0.5) * 1e3:.2f} ms p99 "
          f"{pct(times, 0.99) * 1e3:.2f} ms over {len(times)} steps, "
          f"{b * new / wall:.1f} output tokens/s ({wall:.3f} s); peak "
          f"{peak / 1e9:.3f} GB beside the reckoning "
          f"{(weights + caches) / 1e9:.3f} GB (weights {weights / 1e6:.1f} "
          f"MB, the caches {caches / 1e6:.1f} MB: the decode's self and "
          f"cross {cache_bytes(cache['self']) / 1e6:.1f} + "
          f"{cache_bytes(cache['cross']) / 1e6:.1f} MB); flash launches of "
          f"the prefill by mode {by_mode}, paged launches "
          f"{launches['paged_attention']}; generate() gives the same "
          f"tokens: {same} [{card}]", flush=True)
    device_profile(prof, prof_s, card, "4q (b) whisper_tiny, 4 decode steps"
                   " (after the counted run)")
    want = {"flash_attention": cfg.n_enc_layers + 2 * cfg.n_layers,
            "paged_attention": 2 * cfg.n_layers * (new - 1)}
    want_mode = {"full": cfg.n_enc_layers + cfg.n_layers,
                 "causal": cfg.n_layers}
    if launches != want or by_mode != want_mode:
        raise AssertionError(f"4q (b): launches {launches} by mode {by_mode},"
                             f" want {want} and {want_mode}")
    if not (same and torch.isfinite(logits).all()):
        raise AssertionError("4q (b) whisper_tiny: decode disagrees with "
                             "generate() or the logits are not finite")
    del sess, pre, cache
    return launches


def lm_loss_chunks(card: str) -> None:
    """(d) ``layers.lm_loss`` at qwen3_32b's vocabulary and width
    (LM_LOSS_SHAPE, x and the head bf16, seeded on the card): the
    chunked loss (1024 positions a chunk under checkpoint) and its
    gradients against the one-chunk form (``chunk`` past t), each
    form's peak memory above the inputs, and the time of a forward and
    backward (CUDA events, LM_LOSS_REPS calls after one to warm up; the
    host's wall beside).  A third form, the chunked loss with its chunks
    summed by ``kernels.ref.fma_f32`` (which reads on the host whether a
    sum needs its correction, a stall a chunk), prices those stalls: the
    chunked form less the one-chunk form is the recompute's cost, the
    third form less the chunked one the stalls'."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.models import layers
    b, t, d, v = LM_LOSS_SHAPE
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    gc.collect()
    torch.cuda.empty_cache()
    x = torch.randn((b, t, d), device="cuda", generator=g).bfloat16()
    head = (torch.randn((d, v), device="cuda", generator=g) * 0.02
            ).bfloat16()
    tg = torch.randint(0, v, (b, t), device="cuda", generator=g)
    sync_free = layers.fma_round_once

    def host_read(a, b_, c):
        return ref.fma_f32(a[None], b_[None], c[None])[0]
    res = {}
    for label, chunk, fma in (("chunked", layers.LOSS_CHUNK, sync_free),
                              ("one chunk", t + 1, sync_free),
                              ("chunked, host-read FMA", layers.LOSS_CHUNK,
                               host_read)):
        layers.fma_round_once = fma
        try:
            xs = x.clone().requires_grad_()
            hs = head.clone().requires_grad_()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            loss = layers.lm_loss(xs, hs, tg, chunk=chunk)
            gx, gh = torch.autograd.grad(loss, (xs, hs))
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            dev, wall = [], []
            for _ in range(LM_LOSS_REPS):
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                t0 = time.perf_counter()
                e0.record()
                torch.autograd.grad(layers.lm_loss(xs, hs, tg, chunk=chunk),
                                    (xs, hs))
                e1.record()
                torch.cuda.synchronize()
                wall.append(time.perf_counter() - t0)
                dev.append(e0.elapsed_time(e1))
        finally:
            layers.fma_round_once = sync_free
        res[label] = (loss.item(), gx, gh, peak, pct(dev, 0.5),
                      pct(wall, 0.5) * 1e3)
        del xs, hs, loss
    (l0, gx0, gh0, p0, d0, w0), (l1, gx1, gh1, p1, d1, w1), \
        (l2, gx2, gh2, _, d2, w2) = res.values()
    errs = [abs(l0 - l1) / abs(l1)] + [
        ((a.float() - c.float()).abs().max() / c.float().abs().max()).item()
        for a, c in ((gx0, gx1), (gh0, gh1))]
    same = l2 == l0 and torch.equal(gx2, gx0) and torch.equal(gh2, gh0)
    print(f"4q (d) lm_loss at b {b}, t {t}, d {d}, vocab {v} (bf16 head): "
          f"chunked loss {l0:.6f} vs one chunk {l1:.6f} (relative "
          f"{errs[0]:.3e}, tol {LM_LOSS_RTOL:.0e}); gradients x, head "
          f"{errs[1]:.3e}, {errs[2]:.3e} of their largest entry (tol "
          f"{LM_LOSS_GRAD_RTOL:.0e}); peak above the inputs: chunked "
          f"{p0 / 1e9:.3f} GB, one chunk {p1 / 1e9:.3f} GB (the f32 logits "
          f"of one chunk {b * min(t, 1024) * v * 4 / 1e9:.3f} GB, of the "
          f"row {b * t * v * 4 / 1e9:.3f} GB) [{card}]", flush=True)
    print(f"4q (d) lm_loss forward and backward, p50 of {LM_LOSS_REPS} "
          f"(CUDA events; host wall): chunked {d0:.2f} ms ({w0:.2f}), one "
          f"chunk {d1:.2f} ms ({w1:.2f}), chunked with the host-read FMA "
          f"{d2:.2f} ms ({w2:.2f}; loss and gradients bit-equal to the "
          f"chunked form's: {same}): the recompute {d0 - d1:.2f} ms, the "
          f"host's stalls {d2 - d0:.2f} ms [{card}]", flush=True)
    if not (errs[0] <= LM_LOSS_RTOL and max(errs[1:]) <= LM_LOSS_GRAD_RTOL
            and p0 < p1 and same):
        raise AssertionError(f"4q (d) lm_loss: chunked vs one chunk {errs}, "
                             f"peaks {p0} vs {p1}, host-read FMA same {same}")
    del x, head, gx0, gh0, gx1, gh1, gx2, gh2, res
    gc.collect()
    torch.cuda.empty_cache()


def whisper_serve_phase(card: str) -> dict:
    """Phase 4q: ServeSession on the enc-dec family and lm_loss's chunks,
    on one card, (a)-(d).  Returns (a)'s records, their launches from
    (b)."""
    import torch
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    parts = {}

    def part(key, fn, *args):
        t = time.perf_counter()
        out = fn(card, *args)
        parts[key] = time.perf_counter() - t
        return out
    records = part("a", lambda card: {**whisper_paged_rows(card),
                                      **whisper_cross_flash(card)})
    launches = part("b", whisper_serve_full_width)
    for key, rec in records.items():
        rec["launches"] = launches[key.split()[0]]
    part("c", contiguous_serving_card_vs_cpu, "4q (c)", "whisper_tiny")
    part("d", lm_loss_chunks)
    print(f"phase 4q took {time.perf_counter() - t_phase:.1f} s ("
          + ", ".join(f"({k}) {v:.1f} s" for k, v in parts.items())
          + f") [{card}]", flush=True)
    return records


def whisper_serve_alone(card: str) -> None:
    """Phase 4q alone, the kernels built first."""
    from repro_torch.kernels import _build
    _build.build()
    whisper_serve_phase(card)


# ----------------------------------------- phase 4d: the trained ONN
# The paper's scenario 1 (examples/quickstart.py --scenario1): B 8, N 4,
# K 4, 4-64-128-256-128-64-4 with layers 1-6 approximated, the full
# 13^4 = 28,561-sample input grid, 3000 epochs (stage 2 from 2400)
SCENARIO1_TRAIN = dict(epochs=3000, e1=2400, lr=1e-2, proj_every=200)
# the paper's Table II, worst accuracy row (approximated layers 3-6 of
# scenario 4; src/repro/photonics/error_model.py:34)
TABLE_II_WORST = 0.9998891


class captured_histories:
    """Collects the history of every ``training.train`` call made inside
    the ``with`` block (``ONNModule.train`` returns only the module)."""

    def __enter__(self):
        from repro_torch.photonics import training
        self.histories, self._train = [], training.train

        def spy(*args, **kw):
            params, history = self._train(*args, **kw)
            self.histories.append(history)
            return params, history

        training.train = spy
        return self.histories

    def __exit__(self, *exc):
        from repro_torch.photonics import training
        training.train = self._train


def onn_accuracies(card: str, label: str, module, a, t) -> dict:
    """The accuracy of a trained scenario-1 ONN on the whole input grid
    through the plain path (``training.accuracy``), the ``onn_layer``
    kernel (``symbols(a, 'onn')``) and the ``mesh_scan`` kernel (both
    backends), and its error histogram.  Raises if a kernel path's count
    of exact samples differs from the plain path's by more than the
    samples whose plain analog output lies within ONN_MARGIN of a PAM4
    threshold."""
    import torch
    from repro_torch.photonics import training
    n = len(a)
    a_gpu, t_gpu = torch.from_numpy(a).cuda(), torch.from_numpy(t).cuda()
    plain = training.accuracy(module.params, a, t, module.cfg, device="cuda")
    with torch.no_grad():
        analog = training.apply_onn(module.params_on("cuda"), a_gpu,
                                    module.cfg)
    thr = torch.tensor([0.5, 1.5, 2.5], device="cuda")
    near = int(((analog[..., None] - thr).abs() <= ONN_MARGIN).any(-1)
               .any(-1).sum())

    def exact(sym):
        return int((sym == t_gpu).all(-1).sum())

    got = {"onn_layer": exact(module.symbols(a_gpu, "onn"))}
    t0 = time.perf_counter()
    module.programs_on("cuda")
    programming = time.perf_counter() - t0
    for backend in ("xla", "pallas"):
        got[f"mesh_scan {backend}"] = exact(module.symbols(
            a_gpu, "mesh", mesh_backend=backend))
    hist = training.error_histogram(module.params, a, t, module.cfg,
                                    device="cuda")
    print(f"trained ONN {label}: accuracy over the {n} samples, plain "
          f"path {plain:.7f}; " + ", ".join(
              f"{k} {v / n:.7f}" for k, v in got.items())
          + f"; {near} samples within {ONN_MARGIN} of a threshold; error "
          f"histogram {dict(sorted(hist.items()))}; paper 1.0 "
          f"{'met' if plain == 1.0 else 'NOT met'}, Table II's worst row "
          f"{TABLE_II_WORST}: {'at or above' if plain >= TABLE_II_WORST else 'BELOW'}; "
          f"Givens programming {programming:.3f} s on the host [{card}]",
          flush=True)
    for k, v in got.items():
        if abs(v - round(plain * n)) > near:
            raise AssertionError(f"{label}: {k} accuracy {v / n} differs "
                                 f"from the plain path's {plain} by more "
                                 f"than the {near} near-threshold samples")
    return {"plain": plain, "onn_acc": got["onn_layer"] / n,
            "mesh_acc": got["mesh_scan pallas"] / n}


def trained_onn_full_width(card: str) -> dict:
    """Phase 4d: trains the paper's scenario-1 ONN on the card twice, in
    the paper's project mode as examples/quickstart.py does and in
    cayley mode through ``runtime.get_module(params='train')``; prints
    each one's seconds, losses and accuracies by path.  Returns the one
    with the higher onn_layer accuracy (project on a tie) as {"module",
    "label", "onn_acc", "codes"}, codes those of first_bucket_codes."""
    import torch
    from repro_torch.photonics import (PhotonicsConfig, dataset, runtime,
                                       training)
    from repro_torch.photonics.module import ONNModule
    from repro_torch.photonics.onn import ONNConfig

    cfg = ONNConfig(structure=ONN8_STRUCTURE, approx_layers=APPROX_LAYERS,
                    bits=8, n_servers=4, k_inputs=4)
    a, t = dataset.full_dataset(cfg)
    picks = []
    for mode in ("project", "cayley"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "project":
            params, hist = training.train(
                cfg, training.TrainConfig(**SCENARIO1_TRAIN), a, t,
                eval_every=200, device="cuda")
            module = ONNModule.from_params(cfg, params)
        else:
            ph = PhotonicsConfig(fidelity="onn", params="train",
                                 train_epochs=SCENARIO1_TRAIN["epochs"],
                                 approx_layers=APPROX_LAYERS)
            with captured_histories() as hists:
                module = runtime.get_module(ph, 8, 4)
            (hist,) = hists
            if module.cfg != cfg:
                raise AssertionError(f"params='train' built {module.cfg}")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        evals = [(h["epoch"], h["acc"]) for h in hist if "acc" in h]
        print(f"phase 4d: scenario-1 ONN {ONN8_STRUCTURE} (approx 1-6, "
              f"bits 8, N 4, K 4, {len(a)} samples), mode {mode}: "
              f"{len(hist)} epochs in {secs:.3f} s ({1e3 * secs / len(hist):.3f}"
              f" ms an epoch); loss {hist[0]['loss']:.6e} -> "
              f"{hist[-1]['loss']:.6e}; stage 2 from epoch "
              f"{next((h['epoch'] for h in hist if h['stage'] == 2), None)};"
              f" accuracy at the evaluations {evals} [{card}]", flush=True)
        acc = onn_accuracies(card, mode, module, a, t)
        picks.append((acc["onn_acc"], mode == "project", mode, module))
    onn_acc, _, label, module = max(picks, key=lambda p: p[:2])
    print(f"phase 4d: installing the {label} ONN (onn_layer accuracy "
          f"{onn_acc:.7f}) for phases 4b, 4c and 4e", flush=True)
    return {"module": module, "label": label, "onn_acc": onn_acc,
            "codes": first_bucket_codes()}


# ------------------------------------------------ phase 4e: PhaseNoise
NOISE_ARGV = ["--theta-drift-std", "0.02", "--shot-noise-std", "0.01"]


# pallas steps of each PhaseNoise run (3 in PRs 23-30: ~5 s a step)
NOISE_STEPS = 2


def train_noise_full_width(card: str, onn, clean_losses, clean_times,
                           behavioral_bits2) -> int:
    """Phase 4e: the trained ONN's bits-8 mesh steps with thermal drift
    and shot noise: pallas (the kernel's drift branch, 6 x 42 launches a
    step) for NOISE_STEPS steps, again with the same seed (the same
    losses), and
    xla (the drift in tensor ops, no drift launch) for 1; then bits 2
    with the same stds for 8 steps beside behavioral.  Returns the drift
    launches of the first pallas run."""
    from repro_torch import configs
    from repro_torch.collectives.bucketizer import expected_buckets
    from repro_torch.models import lm
    from repro_torch.photonics import PhotonicsConfig, runtime
    from repro_torch.tree import leaves

    cfg = configs.get("paper_llama")
    n_buckets = expected_buckets(4 * sum(
        math.prod(s) for s in leaves(lm.param_shapes(cfg))))
    runtime.put_module(PhotonicsConfig(fidelity="mesh"), 8, 4,
                       onn["module"])
    per_step = 6 * n_buckets
    runs = {}
    for name, backend, steps in (("pallas", "pallas", NOISE_STEPS),
                                 ("pallas again", "pallas", NOISE_STEPS),
                                 ("xla", "xla", 1)):
        losses, times, launches, branches = mesh_run(
            card, ["--bits", "8", "--mesh-backend", backend] + NOISE_ARGV,
            steps, f" (trained {onn['label']} ONN, PhaseNoise)")
        want = ({"clean": 0, "theta_drift": per_step * steps}
                if backend == "pallas"
                else {"clean": per_step * steps, "theta_drift": 0})
        if branches != want:
            raise AssertionError(f"{name}: mesh_scan branches {branches}, "
                                 f"want {want}")
        runs[name] = losses, times, branches
        print(f"  PhaseNoise {name}: step times ms "
              f"{[round(x * 1e3, 3) for x in times]} (clean "
              f"{[round(x * 1e3, 3) for x in clean_times[:steps]]}); loss "
              f"{losses} (clean {clean_losses[:steps]}); max |dloss| "
              f"{max(abs(a - b) for a, b in zip(losses, clean_losses)):.5f}"
              f" [{card}]", flush=True)
    if runs["pallas"][0] != runs["pallas again"][0]:
        raise AssertionError(f"the same seed gave other losses: "
                             f"{runs['pallas'][0]} vs "
                             f"{runs['pallas again'][0]}")
    losses, times, _, branches = mesh_run(
        card, ["--bits", "2", "--mesh-backend", "pallas"] + NOISE_ARGV, 8,
        " (exact identity, PhaseNoise: shot noise only)")
    if branches["theta_drift"] or branches["clean"]:
        raise AssertionError(f"bits 2 launched the mesh kernel: {branches}")
    print(f"  PhaseNoise --bits 2, 8 steps: loss {losses}; behavioral "
          f"{behavioral_bits2[:8]}; max |dloss| "
          f"{max(abs(a - b) for a, b in zip(losses, behavioral_bits2)):.5f}"
          f" (ties at k + 0.5 of the 4-peer average may fall either way "
          f"under the shot noise) [{card}]", flush=True)
    return runs["pallas"][2]["theta_drift"]


def trained_onn_and_noise(card: str) -> None:
    """Phases 4d and 4e alone (build included): the scenario-1 ONN
    trained twice, then the clean bits-8 pallas mesh steps and bits-2
    mesh steps that phase 4e prints its noisy runs beside."""
    from repro_torch.kernels import _build
    from repro_torch.photonics import PhotonicsConfig, runtime
    _build.build()
    onn = trained_onn_full_width(card)
    runtime.put_module(PhotonicsConfig(fidelity="mesh"), 8, 4,
                       onn["module"])
    losses, times, _, _ = mesh_run(
        card, ["--bits", "8", "--mesh-backend", "pallas"], 3)
    bits2, _, _, _ = mesh_run(card, ["--bits", "2"], 8)
    train_noise_full_width(card, onn, losses, times, bits2)


# ---------------------------- phase 4j: ResNet-50 on CIFAR-100 shapes
# benchmarks/fig7a.py's ResNet step (value_and_grad of resnet.loss_fn,
# then sync_gradients over the data peers at block 2048, then SGD) at
# full width: 100 classes, 32 x 32 x 3 images from synthetic_images, 4
# peers stacked on one card, 64 images a peer (fig7b's ResNet-50 batch).
# The JAX package has no ResNet trainer, so the step lives here (and in
# tests/test_torch_resnet.py), not in the port.  lr 0.002: at fig7a's
# 0.05 the full-width loss rises (4.777 -> 7.456 in 10 psum steps on an
# NVIDIA H100 80GB HBM3, 700 W; JAX's fig7a step does the same on the
# CPU at BLOCKS (1, 1, 1, 1), 4.744 -> 8.440 in 6): a step moves every
# logit by ~lr |f|^2, and the head's input f is 2048 non-negative
# features of order one
RESNET_PEERS = 4
RESNET_BATCH = 256
RESNET_STEPS = 6
RESNET_LR = 0.002
# (a)'s runs: label -> (SyncConfig and PhotonicsConfig fields, pods,
# steps); the bits-8 onn and mesh runs go through phase 4d's ONN
RESNET_RUNS = {
    "psum": (dict(mode="psum"), 1, RESNET_STEPS),
    "ring": (dict(mode="ring"), 1, RESNET_STEPS),
    "optinc bits 8": (dict(mode="optinc"), 1, RESNET_STEPS),
    "optinc bits 8 again": (dict(mode="optinc"), 1, RESNET_STEPS),
    "injection": (dict(mode="optinc", error_layers=(3, 4, 5, 6)), 1,
                  RESNET_STEPS),
    "bits 2 behavioral": (dict(mode="optinc", bits=2), 1, RESNET_STEPS),
    "bits 2 onn": (dict(mode="optinc", bits=2, fidelity="onn"), 1,
                   RESNET_STEPS),
    "bits 2 mesh": (dict(mode="optinc", bits=2, fidelity="mesh",
                         mesh_backend="pallas"), 1, RESNET_STEPS),
    "cascade pods 2": (dict(mode="cascade"), 2, RESNET_STEPS),
    "onn bits 8": (dict(mode="optinc", fidelity="onn"), 1, 3),
    "mesh bits 8": (dict(mode="optinc", fidelity="mesh",
                         mesh_backend="pallas"), 1, 2),
}
# (c): 4 ranks of these against the stacked runs of (a)
RESNET_PROC_RUNS = ("optinc bits 8", "ring", "cascade pods 2", "psum")
# ring against psum, each loss of RESNET_STEPS steps: the two sum the 4
# f32 gradient rows in other orders (an ulp or two an element), and SGD
# carries that into the weights; a ring that got a chunk or 1/N wrong
# would move step 1's loss (O(5)) by far more
RESNET_RING_TOL = 1e-3
# (b): BLOCKS and WIDTHS of the narrow card-vs-CPU step
RESNET_NARROW = ((1, 1, 1, 1), (8, 16, 32, 64))


@contextlib.contextmanager
def resnet_determinism():
    """TF32 off, cuDNN deterministic and not benchmarking, for the
    stacked runs and every rank worker alike (a new process starts with
    cuDNN's TF32 on), so the peers' pre-sync gradients are the same bits
    wherever they are computed."""
    import torch
    flags = [(torch.backends.cuda.matmul, "allow_tf32", False),
             (torch.backends.cudnn, "allow_tf32", False),
             (torch.backends.cudnn, "deterministic", True),
             (torch.backends.cudnn, "benchmark", False)]
    old = [getattr(o, name) for o, name, _ in flags]
    for o, name, value in flags:
        setattr(o, name, value)
    try:
        yield
    finally:
        for (o, name, _), value in zip(flags, old):
            setattr(o, name, value)


@contextlib.contextmanager
def resnet_width(blocks, widths):
    """The port's ResNet with BLOCKS and WIDTHS set to these."""
    from repro_torch.models import resnet
    old = resnet.BLOCKS, resnet.WIDTHS
    resnet.BLOCKS, resnet.WIDTHS = tuple(blocks), tuple(widths)
    try:
        yield
    finally:
        resnet.BLOCKS, resnet.WIDTHS = old


def resnet_sync(fields: dict, pods: int = 1, **kw):
    """fig7a's SyncConfig (bits 8, block 2048) with ``fields`` (its own
    and the PhotonicsConfig's) over the data peers, or 2 levels."""
    from repro_torch.collectives.engine import SyncConfig
    from repro_torch.launch.mesh import sync_axes
    from repro_torch.photonics import PhotonicsConfig
    f = dict(fields)
    ph = PhotonicsConfig(**{k: f.pop(k) for k in ("fidelity", "mesh_backend")
                            if k in f})
    f.setdefault("bits", 8)
    return SyncConfig(axes=sync_axes(pods), block=2048, photonics=ph,
                      **f, **kw)


def resnet_layout(bucket_bytes=None):
    """The bucket layout of the ResNet's gradient at the widths set now."""
    import torch
    from repro_torch.collectives.bucketizer import (DEFAULT_BUCKET_BYTES,
                                                    make_layout)
    from repro_torch.models import resnet
    from repro_torch.tree import leaves
    return make_layout([(s, torch.float32) for s in
                        leaves(resnet.param_shapes())],
                       bucket_bytes or DEFAULT_BUCKET_BYTES)


def resnet_batches(steps: int, device, batch: int | None = None) -> list:
    """Each step's global batch of synthetic_images (RESNET_BATCH images
    unless ``batch`` says) on ``device``."""
    import torch
    from repro_torch.data.pipeline import synthetic_images
    return [tuple(torch.from_numpy(a).to(device) for a in synthetic_images(
        s, batch or RESNET_BATCH)) for s in range(steps)]


def resnet_key(step: int) -> int:
    """Step ``step``'s sync key, the trainer's key tree."""
    from repro_torch import prng
    return prng.fold_in(prng.PRNGKey(SEED + 1), step)


def resnet_peer_grads(params, images, labels, peers: int, world=None):
    """Each peer's loss and gradients on its rows [p B/N, (p+1) B/N) of
    the global batch, as P("data") splits it (with ``world`` this rank's
    peer alone): ((n,) losses, the gradient tree with a leading peer
    dimension)."""
    import torch
    from repro_torch.models import resnet
    from repro_torch.tree import leaves, unflatten
    per = images.shape[0] // peers
    own = range(peers) if world is None else [world.rank]
    train = [t.detach().requires_grad_() for t in leaves(params)]
    tparams = unflatten(params, train)
    losses, grads = [], []
    for p in own:
        loss, _ = resnet.loss_fn(tparams, images[p * per:(p + 1) * per],
                                 labels[p * per:(p + 1) * per])
        grads.append(torch.autograd.grad(loss, train))
        losses.append(loss.detach())
    return torch.stack(losses), unflatten(
        params, [torch.stack(g) for g in zip(*grads)])


def resnet_step(params, images, labels, sync, key, pods: int = 1,
                world=None):
    """fig7a's step over RESNET_PEERS peers: (params, loss, pre-sync
    gradient tree, synced gradient tree); the loss is the peers' losses
    summed and divided by N, as ``launch.steps`` reports it."""
    from repro_torch.collectives.engine import sync_gradients
    from repro_torch.tree import tree_map
    losses, grads = resnet_peer_grads(params, images, labels, RESNET_PEERS,
                                      world)
    synced, _ = sync_gradients(grads, sync, None, key, pods=pods, world=world)
    params = tree_map(lambda p, g: p - RESNET_LR * g, params, synced)
    if world is not None:
        losses = world.gather_rows(losses)
    return params, losses.sum() / RESNET_PEERS, grads, synced


def resnet_run(sync, pods: int, steps: int, batches, params):
    """``steps`` stacked steps from ``params``: (whole losses, step
    seconds, each timed to the loss on the host)."""
    losses, times = [], []
    for s in range(steps):
        t0 = time.perf_counter()
        params, loss, _, _ = resnet_step(params, *batches[s], sync,
                                         resnet_key(s), pods)
        losses.append(loss.item())
        times.append(time.perf_counter() - t0)
    return losses, times


def resnet_install_onn(onn=None) -> str:
    """Phase 4d's ONN (``onn``) for the bits-8 onn and mesh runs, else a
    seeded Table I row 1 ONN (for 4j alone); returns what it is."""
    from repro_torch.photonics import PhotonicsConfig, runtime
    if onn is None:
        module = seeded_onn(PhotonicsConfig(fidelity="onn"), APPROX_LAYERS,
                            SEED + 6)
        label = "a seeded Table I row 1 ONN (approx 1-6)"
    else:
        module, label = onn["module"], f"phase 4d's trained {onn['label']} ONN"
    for fid in ("onn", "mesh"):
        runtime.put_module(PhotonicsConfig(fidelity=fid), 8, RESNET_PEERS,
                           module)
    return label


def resnet_want_launches(sync, nb: int, steps: int) -> dict:
    """Each kernel's launches in ``steps`` steps of ``sync`` over ``nb``
    buckets: pam4 encode and decode once a bucket but in psum and ring,
    onn_layer once a layer of the ONN a bucket at fidelity onn, mesh_scan
    once a mesh a bucket at fidelity mesh (none at bits 2: the exact
    identity has no rotation)."""
    from repro_torch.photonics import runtime
    pam4 = 0 if sync.mode in ("psum", "ring") else nb * steps
    want = {"pam4_quantize_encode": pam4, "pam4_decode_dequantize": pam4,
            "onn_layer": 0, "mesh_scan_blocks": 0}
    ph = sync.photonics
    if ph.fidelity == "onn":
        module = runtime.get_module(ph, sync.bits, RESNET_PEERS)
        want["onn_layer"] = (len(module.cfg.structure) - 1) * nb * steps
    if ph.fidelity == "mesh" and sync.bits > 2:
        module = runtime.get_module(ph, sync.bits, RESNET_PEERS)
        want["mesh_scan_blocks"] = sum(
            len(layer) for layer in mesh_launches(module.programs)
        ) * nb * steps
    return want


def resnet_counters() -> dict:
    from repro_torch.kernels import mesh_scan, onn_layer, pam4
    return {"pam4_quantize_encode": pam4.pam4_quantize_encode,
            "pam4_decode_dequantize": pam4.pam4_decode_dequantize,
            "onn_layer": onn_layer.onn_layer,
            "mesh_scan_blocks": mesh_scan.mesh_scan_blocks}


def resnet_stats(times) -> str:
    rest = times[1:] or times
    p50 = pct(rest, 0.5)
    return (f"step p50 {p50 * 1e3:.3f} ms p99 {pct(rest, 0.99) * 1e3:.3f} ms "
            f"over steps 1-{len(times) - 1}, {RESNET_BATCH / p50:.1f} "
            f"images/s "
            f"(first step {times[0] * 1e3:.3f} ms)")


def resnet_stacked_runs(card: str, labels, onn=None) -> dict:
    """(a)'s runs of ``labels`` (RESNET_RUNS keys), each with the launch
    counts set to 0 just before it and read just after: {label: (losses,
    step seconds, launches)}; raises on a non-finite loss, a loss that
    does not fall over RESNET_STEPS steps or a launch count off its
    want."""
    import torch
    from repro_torch.models import resnet
    from repro_torch.photonics import error_model, runtime

    nb = resnet_layout().n_buckets
    params0 = resnet.init_params(SEED, device="cuda")
    batches = resnet_batches(RESNET_STEPS, "cuda")
    if {"onn bits 8", "mesh bits 8"} & set(labels):
        print(f"4j: the bits-8 onn and mesh runs go through "
              f"{resnet_install_onn(onn)}", flush=True)
    counters = resnet_counters()
    tally = []                      # (hits, codes drawn) of each bucket
    inject_with = error_model.inject_with

    def counting(u_avg, hit, which, spec, bits):
        tally.append((int(hit.sum()), hit.numel()))
        return inject_with(u_avg, hit, which, spec, bits)

    out = {}
    for label in labels:
        fields, pods, steps = RESNET_RUNS[label]
        sync = resnet_sync(fields, pods)
        if sync.photonics.fidelity != "behavioral":
            runtime.warmup(sync, RESNET_PEERS, "cuda")
        want = resnet_want_launches(sync, nb, steps)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        error_model.inject_with = counting
        try:
            losses, times = resnet_run(sync, pods, steps, batches, params0)
        finally:
            error_model.inject_with = inject_with
        launches = {k: fn.launches for k, fn in counters.items()}
        print(f"4j {label}: {steps} steps, losses {losses}; "
              f"{resnet_stats(times)}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; "
              f"launches {launches} [{card}]", flush=True)
        if not all(math.isfinite(x) for x in losses) or (
                steps == RESNET_STEPS and not sum(losses[-3:])
                < sum(losses[:3])):
            raise AssertionError(f"4j {label}: losses {losses} (the last "
                                 f"three must sum below the first three)")
        if launches != want:
            raise AssertionError(f"4j {label}: launches {launches}, want "
                                 f"{want}")
        out[label] = losses, times, launches
    if tally:
        resnet_check_injection(card, tally, nb)
    return out


def resnet_check_injection(card: str, tally, nb: int) -> None:
    """The Table-II hits of each step of the injection run within
    INJECT_SIGMAS binomial sigma of the expected count."""
    from repro_torch.photonics import error_model
    p = error_model.TABLE_II[(3, 4, 5, 6)].p_error
    steps = [tally[i:i + nb] for i in range(0, len(tally), nb)]
    for s, buckets in enumerate(steps):
        hits = sum(h for h, _ in buckets)
        drawn = sum(d for _, d in buckets)
        mean, sd = p * drawn, (drawn * p * (1 - p)) ** 0.5
        print(f"4j injection step {s}: {hits} Table-II hits in {drawn} "
              f"codes drawn, expected {mean:.1f} +- {INJECT_SIGMAS} x "
              f"{sd:.1f} (p_error {p:.7f}) [{card}]", flush=True)
        if abs(hits - mean) > INJECT_SIGMAS * sd or not hits:
            raise AssertionError(f"4j injection step {s}: {hits} hits")


def resnet_ragged_forms(card: str) -> None:
    """The pam4 forms of the last, ragged bucket (310 blocks and a
    1,700-element tail at full width): its optinc sync alone on a peer
    stack of the step's shape."""
    import torch
    from repro_torch.collectives.engine import sync_flat
    from repro_torch.kernels import pam4
    layout = resnet_layout()
    s, e = layout.bounds[-1]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    flat = torch.randn((RESNET_PEERS, layout.total), generator=g,
                       device="cuda")
    enc, dec = pam4.pam4_quantize_encode, pam4.pam4_decode_dequantize
    enc.forms = dict.fromkeys(enc.forms, 0)
    dec.forms = dict.fromkeys(dec.forms, 0)
    sync_flat(flat, [(s, e)], resnet_sync(dict(mode="optinc")))
    torch.cuda.synchronize()
    print(f"4j the last bucket, elements [{s}, {e}) ({e - s} = "
          f"{(e - s) // 2048} blocks of 2048 + {(e - s) % 2048}), optinc "
          f"bits 8: encode forms {enc.forms}, decode forms {dec.forms} "
          f"[{card}]", flush=True)


def resnet_profile(card: str) -> None:
    """One optinc bits-8 step (after a warm-up step) under the profiler:
    the busy share, the top device operations, and the device time of
    the convolutions (cuDNN and GEMM kernels), the elementwise passes
    and reductions (GroupNorm's, with the ReLUs and adds) and pam4."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import resnet
    params = resnet.init_params(SEED, device="cuda")
    batches = resnet_batches(1, "cuda")
    sync = resnet_sync(dict(mode="optinc"))
    params, loss, _, _ = resnet_step(params, *batches[0], sync, resnet_key(0))
    loss.item()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, loss, _, _ = resnet_step(params, *batches[0], sync, resnet_key(1))
        loss.item()
        wall = time.perf_counter() - t0
    dev = device_profile(prof, wall, card, "ResNet-50 step, optinc bits 8, "
                         "4 peers x 64 images")
    conv_words = ("conv", "gemm", "xmma", "wgrad", "dgrad", "fprop",
                  "cudnn", "cutlass", "implicit", "winograd")
    shares = {"convolutions": 0.0, "elementwise and reductions": 0.0,
              "pam4": 0.0, "other": 0.0}
    for name, us in dev.items():
        low = name.lower()
        if "pam4" in low:
            shares["pam4"] += us
        elif any(w in low for w in conv_words):
            shares["convolutions"] += us
        elif "elementwise" in low or "reduce" in low:
            shares["elementwise and reductions"] += us
        else:
            shares["other"] += us
    busy = max(sum(shares.values()), 1e-9)
    print("4j profiled step, device time by kind: " + ", ".join(
        f"{k} {v / 1e3:.3f} ms ({100 * v / busy:.2f}%)"
        for k, v in shares.items()) + f" [{card}]", flush=True)


def resnet_card_vs_plain(card: str) -> None:
    """(b): one narrow f32 step of 4 peers on the card and on the CPU
    from the same weights and images; then the card's gradient stack
    synced on the CPU through the plain versions must give the card's
    synced gradients bit for bit, in optinc and ring."""
    import torch
    from repro_torch.collectives.engine import sync_gradients
    from repro_torch.models import resnet
    from repro_torch.tree import leaves, tree_map
    with resnet_width(*RESNET_NARROW):
        params_cpu = resnet.init_params(SEED, device="cpu")
        params_gpu = tree_map(lambda t: t.cuda(), params_cpu)
        [(images, labels)] = resnet_batches(1, "cpu", 16)
        l_cpu, g_cpu = resnet_peer_grads(params_cpu, images, labels,
                                         RESNET_PEERS)
        l_gpu, g_gpu = resnet_peer_grads(params_gpu, images.cuda(),
                                         labels.cuda(), RESNET_PEERS)
        loss_err = (l_gpu.cpu() - l_cpu).abs().max().item()
        grad_err = max(((a.cpu() - w).abs().max() / w.abs().max()).item()
                       for a, w in zip(leaves(g_gpu), leaves(g_cpu)))
        same = {}
        for mode in ("optinc", "ring"):
            sync = resnet_sync(dict(mode=mode), bucket_bytes=1 << 18)
            out_g, _ = sync_gradients(g_gpu, sync, None, resnet_key(0))
            out_c, _ = sync_gradients(tree_map(lambda t: t.cpu(), g_gpu),
                                      sync, None, resnet_key(0))
            same[mode] = all(torch.equal(a.cpu(), b) for a, b in
                             zip(leaves(out_g), leaves(out_c)))
        n = resnet_layout(1 << 18)
    print(f"4j (b) card vs CPU, BLOCKS {RESNET_NARROW[0]} WIDTHS "
          f"{RESNET_NARROW[1]}, 4 peers x 4 images, f32 ({n.total} params, "
          f"{n.n_buckets} buckets): loss max_abs_err {loss_err:.3e} (tol "
          f"{TRAIN_LOSS_TOL:.0e}), pre-sync gradients max_abs_err / "
          f"max|leaf| {grad_err:.3e} (tol {TRAIN_GRAD_TOL:.0e}); the card's "
          f"stack synced on the CPU bit-equal to the card's sync {same} "
          f"[{card}]", flush=True)
    if not (loss_err <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL
            and all(same.values())):
        raise AssertionError("4j (b): card vs CPU")


def resnet_rank(spec_json: str) -> None:
    """One rank of phase 4j (c) under torchrun: RESNET_RUNS[label] as 4
    processes, this rank's peer and its sync over ``world``; writes
    ``rank<r>.json`` (losses, bytes a collective, launches, step seconds)
    into ``out``, and for psum rank 0 also ``psum_grads.pt`` (the
    first-step synced gradients of the process psum and of the stacked
    sum of the gathered rows, and each element's bound).  One card a
    rank, NCCL."""
    import torch
    from repro_torch.launch import distributed
    from repro_torch.models import resnet
    from repro_torch.tree import leaves
    spec = json.loads(spec_json)
    fields, pods, steps = RESNET_RUNS[spec["label"]]
    out = Path(spec["out"])
    with resnet_determinism():
        world = distributed.init(pods, RESNET_PEERS // pods, 1, "cuda")
        params = resnet.init_params(SEED, device=world.device)
        batches = resnet_batches(steps, world.device)
        sync = resnet_sync(fields, pods)
        counters = resnet_counters()
        for fn in counters.values():
            fn.launches = 0
        losses, times = [], []
        for s in range(steps):
            t0 = time.perf_counter()
            params, loss, grads, synced = resnet_step(
                params, *batches[s], sync, resnet_key(s), pods, world)
            losses.append(loss.item())
            times.append(time.perf_counter() - t0)
            if s == 0 and sync.mode == "psum":
                rows = world.gather_rows(torch.cat(
                    [g.reshape(1, -1) for g in leaves(grads)], dim=1))
                if world.rank == 0:
                    mag = rows.abs().sum(0) / RESNET_PEERS
                    torch.save({
                        "process": torch.cat([g.reshape(-1) for g in
                                              leaves(synced)]).cpu(),
                        "stacked": (rows.sum(0) / RESNET_PEERS).cpu(),
                        "bound": (PSUM_ULPS * (torch.nextafter(
                            mag, torch.full_like(mag, math.inf)) - mag)
                        ).cpu()}, out / "psum_grads.pt")
                del rows
        (out / f"rank{world.rank}.json").write_text(json.dumps({
            "rank": world.rank, "device": str(world.device),
            "losses": losses, "times": times,
            "bytes": dict(world.bytes),
            "launches": {k: fn.launches for k, fn in counters.items()}}))
    distributed.shutdown()
    distributed.exit_rank(0)


def bucket_codes(bounds, n: int, block: int) -> int:
    """The B-bit codes one step's buckets carry over ``n`` ranks: each
    bucket's elements padded to whole blocks, then to JAX's shards of
    ceil(L / N)."""
    return sum(-(-(-(-(e - s) // block) * block) // n) * n
               for s, e in bounds)


def check_psum_grads(label: str, got: dict, card: str) -> None:
    """The process psum's first-step synced gradients against the
    stacked sum of the same rows, elementwise within ``got["bound"]``
    (PSUM_ULPS spacings of sum|x_i| / 4)."""
    diff = (got["process"] - got["stacked"]).abs()
    ulps = float((diff / (got["bound"] / PSUM_ULPS)).max())
    print(f"{label} psum first-step synced gradients, NCCL all-reduce vs "
          f"the stacked sum ({diff.numel()} elements): max_abs_err "
          f"{float(diff.max()):.3e}, {int((diff > 0).sum())} elements "
          f"differ, at most {ulps:.2f} x spacing(sum|x_i| / 4) (bound "
          f"{PSUM_ULPS}) [{card}]", flush=True)
    if not bool((diff <= got["bound"]).all()):
        raise AssertionError(f"{label} psum gradients beyond the bound")


def resnet_processes(card: str, stacked: dict) -> None:
    """(c): RESNET_PROC_RUNS as 4 ``--resnet-rank`` ranks on NCCL, one a
    card, against (a)'s stacked runs (``stacked``: {label: (losses, step
    seconds, launches)}): the losses bit for bit but psum's, psum's
    first-step gradients within PSUM_ULPS spacings, each rank's launches
    (pam4 once a bucket a step, its own row) and, in optinc, its bytes a
    step: 2 B a code reduce-scattered in 16-bit lanes, 1 B a code
    all-gathered as uint8."""
    import shutil
    import torch
    cards = torch.cuda.device_count()
    if cards < 4:
        print(f"4j (c): skipped, the 4-rank runs need 4 cards and this "
              f"machine has {cards} (on a 4-card host "
              f"resnet_processes_alone runs them) [{card}]", flush=True)
        return
    layout = resnet_layout()
    nb = layout.n_buckets
    codes = bucket_codes(layout.bounds, RESNET_PEERS, 2048)
    out = ROOT / "build" / "resnet_ranks"
    for label in RESNET_PROC_RUNS:
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        rc, o, e, wall = torchrun(4, [
            str(ROOT / "chip_smoke.py"), "--resnet-rank",
            json.dumps({"label": label, "out": str(out)})])
        if rc != 0:
            raise AssertionError(f"4j (c) {label}: exit {rc}\n{o[-3000:]}\n"
                                 f"{e[-6000:]}")
        ranks = [json.loads((out / f"rank{r}.json").read_text())
                 for r in range(4)]
        losses, times, _ = stacked[label]
        got = ranks[0]["losses"]
        same = got == losses
        err = max(abs(a - b) for a, b in zip(got, losses))
        print(f"4j (c) {label}, 4 ranks vs 4 stacked peers ({wall:.1f} s of "
              f"torchrun): losses bit-equal {same}, max_abs_diff {err:.3e}; "
              f"rank 0 {resnet_stats(ranks[0]['times'])}; stacked "
              f"{resnet_stats(times)} [{card}]", flush=True)
        if label != "psum" and not same:
            raise AssertionError(f"4j (c) {label}: {got} vs stacked {losses}")
        pam4 = 0 if label in ("ring", "psum") else nb * RESNET_STEPS
        for r in ranks:
            launches = {k: v for k, v in r["launches"].items() if v}
            print(f"4j (c) {label}: rank {r['rank']} on {r['device']} "
                  f"launched {launches}; bytes a step "
                  f"{ {k: v / RESNET_STEPS for k, v in r['bytes'].items()} }",
                  flush=True)
            if (r["launches"]["pam4_quantize_encode"] != pam4
                    or r["device"] != f"cuda:{r['rank']}"):
                raise AssertionError(f"4j (c) {label}: rank {r['rank']}")
            if label == "optinc bits 8":
                wire = (r["bytes"]["psum_scatter:int32"] / RESNET_STEPS,
                        r["bytes"]["all_gather:uint8"] / RESNET_STEPS)
                if wire != (2 * codes, codes):
                    raise AssertionError(f"4j (c) optinc wire bytes {wire}, "
                                         f"want {(2 * codes, codes)}")
        if label == "optinc bits 8":
            print(f"4j (c) optinc: {codes} codes a step over {nb} buckets; "
                  f"every rank reduce-scattered {2 * codes} B and "
                  f"all-gathered {codes} B a step, as derived", flush=True)
        if label == "psum":
            check_psum_grads("4j (c)", torch.load(out / "psum_grads.pt"),
                             card)
    shutil.rmtree(out, ignore_errors=True)


def resnet_full_width(card: str, onn=None) -> None:
    """Phase 4j: ResNet-50 on CIFAR-100 shapes through every --sync mode
    ((a) 4 peers stacked on one card, RESNET_RUNS), its ragged bucket's
    pam4 forms and a profiled step; (b) narrow, card vs CPU; (c) 4 ranks
    against (a) when the machine has 4 cards.  ``onn``: phase 4d's pick
    for the bits-8 onn and mesh runs (a seeded ONN when None)."""
    import torch
    t_phase = time.perf_counter()
    with resnet_determinism():
        runs = resnet_stacked_runs(card, RESNET_RUNS, onn)
        losses = {k: v[0] for k, v in runs.items()}
        ring_err = max(abs(a - b) for a, b in zip(losses["ring"],
                                                  losses["psum"]))
        checks = {
            "optinc bits 8 again = optinc bits 8":
                losses["optinc bits 8 again"] == losses["optinc bits 8"],
            "bits 2 onn = bits 2 mesh = bits 2 behavioral":
                losses["bits 2 onn"] == losses["bits 2 mesh"]
                == losses["bits 2 behavioral"],
            "cascade pods 2 = optinc bits 8":
                losses["cascade pods 2"] == losses["optinc bits 8"],
            f"ring within {RESNET_RING_TOL} of psum":
                ring_err <= RESNET_RING_TOL,
        }
        off = {k: max(abs(a - b) for a, b in zip(losses[k],
                                                 losses["optinc bits 8"]))
               for k in ("onn bits 8", "mesh bits 8")}
        print(f"4j checks (bit for bit but the ring): {checks}; ring vs psum "
              f"max_abs_diff {ring_err:.3e}; max |dloss| against optinc "
              f"bits 8 (behavioral) {off} [{card}]", flush=True)
        if not all(checks.values()):
            raise AssertionError(f"4j: {checks}")
        for label in ("psum", "optinc bits 8", "injection"):
            ls = losses[label]
            print(f"4j fig7a row resnet50.{label}: loss_first "
                  f"{sum(ls[:3]) / 3:.4f} loss_last {sum(ls[-3:]) / 3:.4f} "
                  f"steps {len(ls)} [{card}]", flush=True)
        resnet_ragged_forms(card)
        resnet_profile(card)
        gc.collect()
        torch.cuda.empty_cache()
        resnet_card_vs_plain(card)
        resnet_processes(card, runs)
    print(f"phase 4j took {time.perf_counter() - t_phase:.1f} s [{card}]",
          flush=True)


def resnet_alone(card: str) -> None:
    """Phase 4j alone, the kernels built first (a seeded ONN for the
    bits-8 onn and mesh runs)."""
    from repro_torch.kernels import _build
    _build.build()
    resnet_full_width(card)


def resnet_processes_alone(card: str) -> None:
    """Phase 4j (c) alone on a 4-card host: the kernels built, the
    stacked runs it compares with, then the 4-rank runs."""
    from repro_torch.kernels import _build
    _build.build()
    with resnet_determinism():
        resnet_processes(card, resnet_stacked_runs(card, RESNET_PROC_RUNS))


def card_vs_plain_training(card: str) -> None:
    """A narrow f32 training step on the card and on the CPU from the
    same weights and tokens; then the card's gradient stack synced on
    the CPU through the plain versions, two steps with error feedback."""
    import torch
    from repro_torch.collectives.bucketizer import make_layout
    from repro_torch.collectives.engine import SyncConfig, sync_flat
    from repro_torch.kernels import pam4
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import lm
    from repro_torch.models.config import ModelConfig
    from repro_torch.tree import leaves

    cfg = ModelConfig(name="paper-llama-narrow", family="dense", n_layers=2,
                      d_model=128, n_heads=8, n_kv_heads=8, d_ff=512,
                      vocab=512, dtype="float32")
    params_cpu = lm.init_params(cfg, SEED, "cpu")
    params_gpu = {k: ({kk: vv.cuda() for kk, vv in v.items()}
                      if isinstance(v, dict) else v.cuda())
                  for k, v in params_cpu.items()}
    sync = SyncConfig(mode="optinc", bits=8, block=2048, error_feedback=True,
                      bucket_bytes=2 ** 20)
    layout = make_layout([(s, torch.float32) for s in
                          leaves(lm.param_shapes(cfg))], sync.bucket_bytes)
    g = torch.Generator().manual_seed(SEED + 2)
    res_gpu = res_cpu = None
    for step in range(2):
        tok = torch.randint(0, cfg.vocab, (8, 129), generator=g)
        l_cpu, f_cpu = tsteps.peer_grad_stack(cfg, params_cpu, tok, 2,
                                              layout.total)
        l_gpu, f_gpu = tsteps.peer_grad_stack(cfg, params_gpu, tok.cuda(), 2,
                                              layout.total)
        loss_err = (l_gpu.cpu() - l_cpu).abs().max().item()
        grad_err, start = 0.0, 0
        for size in layout.sizes:          # each leaf against its own max
            want = f_cpu[:, start:start + size]
            got = f_gpu[:, start:start + size].cpu()
            grad_err = max(grad_err, ((got - want).abs().max()
                                      / want.abs().max()).item())
            start += size
        if res_gpu is None:
            res_gpu = torch.zeros_like(f_gpu)
            res_cpu = res_gpu.cpu()
        decode = pam4.pam4_decode_dequantize
        decode.forms = dict.fromkeys(decode.forms, 0)
        out_gpu, new_res_gpu = sync_flat(f_gpu, layout.bounds, sync, res_gpu)
        forms = dict(decode.forms)
        out_cpu, new_res_cpu = sync_flat(f_gpu.cpu(), layout.bounds, sync,
                                         res_gpu.cpu())
        same = (torch.equal(out_gpu.cpu(), out_cpu),
                torch.equal(new_res_gpu.cpu(), new_res_cpu))
        print(f"card vs plain training step {step} (narrow f32, 2 peers, "
              f"{layout.total} params in {layout.n_buckets} buckets): loss "
              f"max_abs_err {loss_err:.3e} (tol {TRAIN_LOSS_TOL:.0e}), "
              f"pre-sync gradients max_abs_err / max|leaf| {grad_err:.3e} "
              f"(tol {TRAIN_GRAD_TOL:.0e}); the card's stack synced on the "
              f"CPU: synced bit-equal {same[0]}, residuals bit-equal "
              f"{same[1]}; the card's pam4 decode forms {forms} [{card}]",
              flush=True)
        if not (loss_err <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL
                and all(same)):
            raise AssertionError("card vs plain training disagrees")
        res_gpu = new_res_gpu
        if step == 0:
            card_vs_plain_onn_sync(card, f_gpu, layout.bounds)
            card_vs_plain_mesh_sync(card, f_gpu, layout.bounds)


def card_vs_plain_onn_sync(card: str, f_gpu, bounds) -> None:
    """A gradient stack (peers, total) on the card synced at fidelity onn
    on the card and through the plain versions on the CPU, error feedback
    on: bits 2 bit for bit (and equal to the behavioral sync); bits 8
    with a seeded ONN, its analog outputs within ONN_TOL and the averaged
    codes and synced gradients bit for bit away from the thresholds."""
    import torch
    from repro_torch.collectives import backends
    from repro_torch.collectives.engine import SyncConfig, sync_flat
    from repro_torch.photonics import PhotonicsConfig, pipeline, runtime
    from repro_torch.photonics.module import ONNModule

    peers = f_gpu.shape[0]
    ph = PhotonicsConfig(fidelity="onn")
    runtime.put_module(ph, 8, peers, ONNModule.init(
        runtime.onn_config(ph, 8, peers), SEED + 4))
    zeros = torch.zeros_like(f_gpu)
    for bits in (2, 8):
        sync = SyncConfig(mode="optinc", bits=bits, block=2048,
                          error_feedback=True, bucket_bytes=2 ** 20,
                          photonics=ph)
        out_g, res_g = sync_flat(f_gpu, bounds, sync, zeros)
        out_c, res_c = sync_flat(f_gpu.cpu(), bounds, sync, zeros.cpu())
        res_same = torch.equal(res_g.cpu(), res_c)
        if bits == 2:
            beh, _ = sync_flat(f_gpu, bounds, SyncConfig(
                mode="optinc", bits=2, block=2048, error_feedback=True,
                bucket_bytes=2 ** 20), zeros)
            same = (torch.equal(out_g.cpu(), out_c), res_same,
                    torch.equal(out_g, beh))
            print(f"card vs plain onn sync, bits 2 (exact identity ONN, "
                  f"{peers} peers, {f_gpu.shape[1]} elements): synced "
                  f"bit-equal {same[0]}, residuals bit-equal {same[1]}, "
                  f"equal to the card's behavioral sync {same[2]} [{card}]",
                  flush=True)
            if not all(same):
                raise AssertionError("card vs plain onn sync at bits 2")
            continue
        stages = pipeline.level_pipeline(runtime.get_module(ph, 8, peers),
                                         8).stages
        rel, near_rows, code_diff = 0.0, 0, 0
        keep = torch.ones(f_gpu.shape[1], dtype=torch.bool)
        for s, e in bounds:
            got = {}
            for dev, x in (("cuda", f_gpu[:, s:e]),
                           ("cpu", f_gpu[:, s:e].cpu())):
                u = backends._encode(x, backends._shared_scale(x, sync),
                                     sync)
                analog = pipeline.SyncPipeline(stages[:3]).run(
                    u.reshape(peers, -1)).data
                codes = pipeline.SyncPipeline(stages[3:]).run(analog).data
                got[dev] = analog.cpu(), codes.cpu()
            (ag, cg), (ac, cc) = got["cuda"], got["cpu"]
            rel = max(rel, ((ag - ac).abs().max()
                            / ac.abs().max()).item())
            thr = torch.tensor([0.5, 1.5, 2.5])
            near = ((ac[..., None] - thr).abs() <= ONN_MARGIN).any(-1).any(
                -1)
            near_rows += int(near.sum())
            code_diff += int((cg != cc)[~near].sum())
            keep[s:e] = ~near[:e - s]
        out_same = torch.equal(out_g.cpu()[keep], out_c[keep])
        print(f"card vs plain onn sync, bits 8 (seeded ONN "
              f"{ONN8_STRUCTURE}, {peers} peers): ONN analog outputs "
              f"max_abs_err / max|y| {rel:.3e} (tol {ONN_TOL:.0e}); "
              f"{near_rows} rows within {ONN_MARGIN} of a threshold (not "
              f"compared); averaged codes differing elsewhere {code_diff}; "
              f"synced bit-equal elsewhere {out_same}; residuals bit-equal "
              f"{res_same} [{card}]", flush=True)
        if not (rel <= ONN_TOL and code_diff == 0 and out_same and res_same
                and near_rows <= 0.01 * f_gpu.shape[1]):
            raise AssertionError("card vs plain onn sync at bits 8")


def card_vs_plain_mesh_sync(card: str, f_gpu, bounds) -> None:
    """The mesh fidelity card vs CPU: bits 2 over the whole stack bit for
    bit (and equal to the card's behavioral sync); bits 8 through the
    Table I row 1 ONN over MESH_ELEMS elements (four blocks): analog
    outputs within ONN_TOL, codes bit for bit away from the thresholds;
    and the card's mesh outputs against the dense ONN of the same
    projected weights within MESH_DENSE_TOL."""
    import torch
    from repro_torch.collectives import backends
    from repro_torch.collectives.engine import SyncConfig, sync_flat
    from repro_torch.photonics import PhotonicsConfig, pipeline, runtime

    peers = f_gpu.shape[0]
    zeros = torch.zeros_like(f_gpu)
    ph = PhotonicsConfig(fidelity="mesh", mesh_backend="pallas")
    sync = SyncConfig(mode="optinc", bits=2, block=2048, error_feedback=True,
                      bucket_bytes=2 ** 20, photonics=ph)
    out_g, res_g = sync_flat(f_gpu, bounds, sync, zeros)
    out_c, res_c = sync_flat(f_gpu.cpu(), bounds, sync, zeros.cpu())
    beh, _ = sync_flat(f_gpu, bounds, dataclasses.replace(
        sync, photonics=PhotonicsConfig()), zeros)
    same = (torch.equal(out_g.cpu(), out_c), torch.equal(res_g.cpu(), res_c),
            torch.equal(out_g, beh))
    print(f"card vs plain mesh sync, bits 2 (exact identity ONN, {peers} "
          f"peers, {f_gpu.shape[1]} elements): synced bit-equal {same[0]}, "
          f"residuals bit-equal {same[1]}, equal to the card's behavioral "
          f"sync {same[2]} [{card}]", flush=True)
    if not all(same):
        raise AssertionError("card vs plain mesh sync at bits 2")

    module = seeded_onn(ph, APPROX_LAYERS, SEED + 7, peers)
    runtime.put_module(ph, 8, peers, module)
    sync = dataclasses.replace(sync, bits=8)
    stages = pipeline.level_pipeline(module, 8, fidelity="mesh",
                                     mesh_backend="pallas").stages
    got = {}
    for dev, x in (("cuda", f_gpu[:, :MESH_ELEMS]),
                   ("cpu", f_gpu[:, :MESH_ELEMS].cpu())):
        t = time.perf_counter()
        u = backends._encode(x, backends._shared_scale(x, sync), sync)
        pre = pipeline.SyncPipeline(stages[:2]).run(u.reshape(peers, -1))
        analog = stages[2].apply(pre).data
        codes = pipeline.SyncPipeline(stages[3:]).run(analog).data
        if dev == "cuda":
            torch.cuda.synchronize()
            dense = module.apply(pre.data)
        got[dev] = analog.cpu(), codes.cpu(), time.perf_counter() - t
    (ag, cg, tg), (ac, cc, tc) = got["cuda"], got["cpu"]
    rel = ((ag - ac).abs().max() / ac.abs().max()).item()
    thr = torch.tensor([0.5, 1.5, 2.5])
    near = ((ac[..., None] - thr).abs() <= ONN_MARGIN).any(-1).any(-1)
    code_diff = int((cg != cc)[~near].sum())
    dense_rel = ((dense.cpu() - ag).abs().max() / ag.abs().max()).item()
    print(f"card vs plain mesh sync, bits 8 (seeded Table I row 1 ONN, "
          f"{peers} peers, {MESH_ELEMS} elements): ONN analog outputs "
          f"max_abs_err / max|y| {rel:.3e} (tol {ONN_TOL:.0e}); "
          f"{int(near.sum())} rows within {ONN_MARGIN} of a threshold (not "
          f"compared); codes differing elsewhere {code_diff}; mesh vs dense "
          f"ONN of the same projected weights on the card max_abs_err / "
          f"max|y| {dense_rel:.3e} (tol {MESH_DENSE_TOL:.0e}); pipeline "
          f"{tg:.3f} s on the card, {tc:.3f} s on the CPU [{card}]",
          flush=True)
    if not (rel <= ONN_TOL and code_diff == 0 and dense_rel <= MESH_DENSE_TOL
            and near.sum() <= 0.01 * MESH_ELEMS):
        raise AssertionError("card vs plain mesh sync at bits 8")


def card_vs_plain_sync_modes(card: str) -> None:
    """The sync modes of phase 4g card vs CPU: a narrow f32 gradient
    stack of 4 peers computed on the card, synced on the card and
    through the plain versions on the CPU, two steps with error feedback
    and a sync key; the synced gradients and residuals must be bit-equal
    for the ring at 4 peers, at 3 and over 2 pods of 2, the behavioral
    cascade over 2 pods, the photonic cascade at bits 2 (onn), Table-II
    injection on one fixed draw (the same on both devices) and the
    streaming dispatch (the card's ``BucketStream`` on its side stream,
    fed the leaves back to front, against the CPU's barrier path)."""
    import torch
    from repro_torch import prng
    from repro_torch.collectives.bucketizer import make_layout
    from repro_torch.collectives.engine import (BucketStream, SyncConfig,
                                                sync_flat)
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import lm
    from repro_torch.models.config import ModelConfig
    from repro_torch.photonics import PhotonicsConfig, error_model
    from repro_torch.tree import leaves

    cfg = ModelConfig(name="paper-llama-narrow", family="dense", n_layers=2,
                      d_model=128, n_heads=8, n_kv_heads=8, d_ff=512,
                      vocab=512, dtype="float32")
    params = lm.init_params(cfg, SEED, "cuda")
    kw = dict(block=2048, error_feedback=True, bucket_bytes=2 ** 20)
    layout = make_layout([(s, torch.float32) for s in
                          leaves(lm.param_shapes(cfg))], kw["bucket_bytes"])
    g = torch.Generator().manual_seed(SEED + 5)
    stacks = []
    for _ in range(2):
        tok = torch.randint(0, cfg.vocab, (8, 129), generator=g).cuda()
        stacks.append(tsteps.peer_grad_stack(cfg, params, tok, 4,
                                             layout.total)[1])

    def fixed_draws(key, shape, spec, device="cpu"):
        gen = torch.Generator().manual_seed(key & 0xFFFFFFFF)
        hit = torch.rand(tuple(shape), generator=gen) < 0.01
        which = torch.randint(0, len(spec.values), tuple(shape),
                              generator=gen)
        return hit.to(device), which.to(device)

    cases = {
        "ring 4 peers": (SyncConfig(mode="ring", **kw), 4, 1),
        "ring 3 peers": (SyncConfig(mode="ring", **kw), 3, 1),
        "ring 2 pods of 2": (SyncConfig(mode="ring", axes=("pod", "data"),
                                        **kw), 4, 2),
        "cascade pods 2, bits 8": (SyncConfig(mode="cascade",
                                              axes=("pod", "data"), **kw),
                                   4, 2),
        "cascade onn pods 2, bits 2": (SyncConfig(
            mode="cascade", axes=("pod", "data"), bits=2,
            photonics=PhotonicsConfig(fidelity="onn"), **kw), 4, 2),
        "injection (3, 4, 5, 6), bits 8": (SyncConfig(
            mode="optinc", error_layers=(3, 4, 5, 6), **kw), 4, 1),
        "overlap": (SyncConfig(mode="optinc", overlap=True, **kw), 4, 1),
    }
    draws = error_model.draws
    error_model.draws = fixed_draws
    try:
        for label, (sync, peers, pods) in cases.items():
            res_g = torch.zeros((peers, layout.total), device="cuda")
            res_c = res_g.cpu()
            same, ok = [], True
            for step, f in enumerate(stacks):
                f = f[:peers].contiguous()
                key = prng.fold_in(prng.PRNGKey(SEED + 1), step)
                if sync.overlap:
                    stream = BucketStream(layout, sync, f, res_g, key, pods)
                    for i in reversed(range(len(layout.sizes))):
                        stream.leaf_ready(i)
                    out_g, new_g = stream.finish()
                else:
                    out_g, new_g = sync_flat(f, layout.bounds, sync, res_g,
                                             key, pods)
                out_c, new_c = sync_flat(f.cpu(), layout.bounds, sync, res_c,
                                         key, pods)
                pair = (torch.equal(out_g.cpu(), out_c),
                        (new_g is None and new_c is None)
                        or torch.equal(new_g.cpu(), new_c))
                same.append(pair)
                ok = ok and all(pair)
                if new_g is not None:
                    res_g, res_c = new_g, new_c
            extra = (f", {stream.early} of {layout.n_buckets} buckets "
                     f"launched before the last leaf" if sync.overlap
                     else "")
            print(f"card vs plain sync, {label} ({layout.total} elements, "
                  f"{layout.n_buckets} buckets, 2 steps): (synced, "
                  f"residuals) bit-equal {same}{extra} [{card}]", flush=True)
            if not ok:
                raise AssertionError(f"card vs plain sync: {label}")
    finally:
        error_model.draws = draws


# ----------------------------------------- phase 5: card vs plain, f32
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
    from repro_torch import configs
    serving_card_vs_cpu(card, "card vs plain", dataclasses.replace(
        configs.get("paper_llama"), dtype="float32"))


def serving_card_vs_cpu(card: str, label: str, cfg) -> None:
    """``cfg`` (f32) served by ServeEngine on the card and on the CPU from
    the same seeded weights, 4 requests x 16 tokens: the teacher-forced
    logits (prefill and every paged decode step) within LOGIT_TOL, and
    the greedy tokens equal up to the first position where the plain
    top-2 margin is thinner than 2 LOGIT_TOL."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    from repro_torch.serving.config import ServeConfig
    from repro_torch.serving.engine import ServeEngine

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
    print(f"{label} ({cfg.name} f32, 4 requests x {new} tokens): "
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
            print(f"{label} request {rid}: plain top-2 margin below "
                  f"{2 * LOGIT_TOL:.0e} first at position {upto}; tokens "
                  f"compared up to it", flush=True)
    equal = sum(np.array_equal(card_out[r], plain[r]) for r in plain)
    print(f"{label} greedy tokens: {equal}/{len(plain)} requests identical "
          f"on card and plain [{card}]", flush=True)


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
        if name.startswith("flash") or name in ("onn_layer", "pam4",
                                                 "paged_attention"):
            continue                  # their checks name each kernel
        log = Path(str(path) + ".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    def phase(label, fn, *args):
        """fn(*args), its seconds printed on a line of their own."""
        t = time.perf_counter()
        out = fn(*args)
        print(f"phase {label}: {time.perf_counter() - t:.1f} s [{card}]",
              flush=True)
        return out

    records = phase("2 paged", check_kernels, card)
    records.update(phase("2 flash", check_flash_kernels, card))
    records.update(phase("2b pam4", check_training_kernels, card))
    records.update(phase("2c onn_layer", check_onn_kernel, card))
    records.update(phase("2d mesh_scan", check_mesh_kernel, card))
    launches = phase("3 serve", serve_full_width, card)
    for name in launches:
        records[name]["launches"] = launches[name]
    train_launches, behavioral8, train_p50_ms, base = phase(
        "4 train", train_full_width, card)
    for name in ("flash_attention_bwd", "pam4_quantize_encode",
                 "pam4_decode_dequantize"):
        records[name]["launches"] = train_launches[name]
    phase("4f sessions", sessions_full_width, card, train_p50_ms)
    phase("4g sync modes", sync_modes_full_width, card, base)
    phase("4h processes", processes_full_width, card)
    phase("4i sharding", sharded_full_width, card)
    records.update(phase("4k moe", moe_full_width, card)["records"])
    records.update(phase("4l whisper", whisper_phase, card))
    records.update(phase("4m qk-norm and mamba2", hybrid_phase, card))
    phase("4o xlstm", xlstm_phase, card)
    records.update(phase("4p serve families", serve_families_phase, card))
    records.update(phase("4q whisper serve", whisper_serve_phase, card))
    onn = phase("4d trained onn", trained_onn_full_width, card)
    onn_launches, behavioral_bits2 = phase(
        "4b onn", train_onn_full_width, card, behavioral8, onn)
    records["onn_layer"]["launches"] = onn_launches["onn_layer"]
    mesh_launches_, clean_losses, clean_times = phase(
        "4c mesh", train_mesh_full_width, card, behavioral_bits2,
        behavioral8, onn)
    records["mesh_scan_blocks"]["launches"] = mesh_launches_[
        "mesh_scan_blocks"]
    drift = phase("4e phase noise", train_noise_full_width, card, onn,
                  clean_losses, clean_times, behavioral_bits2)
    print(f"mesh_scan_blocks theta-drift launches on the PhaseNoise path: "
          f"{drift} in {NOISE_STEPS} pallas steps [{card}]", flush=True)
    phase("4j resnet", resnet_full_width, card, onn)
    phase("5 card vs plain serving", card_vs_plain, card)
    phase("5 card vs plain training", card_vs_plain_training, card)
    phase("5 card vs plain sync modes", card_vs_plain_sync_modes, card)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys}
                                  for rec in records.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--psum-grads"]:
        psum_grads_rank(sys.argv[2])     # one rank of phase 4h's check
    if sys.argv[1:2] == ["--train-layers"]:      # one rank of phase 4i
        train_layers_rank(int(sys.argv[2]), sys.argv[3:])
    if sys.argv[1:2] == ["--tp-grads"]:          # one rank of phase 4i (b)
        tp_grads_rank(sys.argv[2])
    if sys.argv[1:2] == ["--moe-grads"]:         # one rank of phase 4k (d)
        moe_grads_rank(sys.argv[2])
    if sys.argv[1:2] == ["--resnet-rank"]:       # one rank of phase 4j (c)
        resnet_rank(sys.argv[2])
    sys.exit(main())
