#!/usr/bin/env python3
"""Drive the PyTorch port (torched_impala_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits
non-zero (no phase's failure is caught):

1. env: the card, torch/CUDA versions, the TF32 settings in force.
2. build: nvcc builds every kernel from csrc/ (one process per source,
   all at once, seven sources); the seconds it took.
3. vtrace: the CUDA kernel against its plain PyTorch version on the card
   over shapes x clip thresholds x lambda (max abs error <= 1e-5; T = 33
   and 1000 carry the recursion across 32-step chunks) and with a NaN
   log-ratio (the same NaN pattern as the plain version), its time beside
   the plain version's and its bound at the Pong shape, its device time at
   B = 32 for T = 20, 100 and 1000, and `impala_loss` through the kernel
   against `impala_loss` through the plain V-trace (total and grads, rtol
   1e-5).
4. lstm: the LSTM-cell kernel against its plain version at the learner's
   (B=32, F=H=256) and the actor's (B=8) shapes and five ragged ones
   (max abs error <= 5e-5: f32 sums of up to 768 products in another
   order), a second launch bit-identical to the first, gradients through
   the autograd.Function with the kernel's forward against the plain
   forward's (rtol 1e-4, atol 1e-5); at the learner's and the actor's
   shapes the kernel's grid (>= 128 blocks, from the profiler's trace),
   its time (events and profiler device µs), the bound, and
   `torch.lstm_cell`'s time (events and profiler device µs).
5. resblock: the bf16 kernel's machine code holds `HGMMA` (wgmma)
   instructions (`cuobjdump -sass`; the phase fails on none); the
   residual-block kernels against their plain version at the three
   Breakout block shapes with N = 672 (the learner's 21 x 32 images)
   and N = 8 (one actor) in bf16, at procgen's (N = 1344 at 32x32x16,
   16x16x32 and 8x8x32, and N = 16 and 32 there), and at C = 24, C = 1 and C = 72
   (zero-padded channels), one bf16 rounding apart (rtol = atol = 2^-7, 99% of
   elements equal), and ragged f32 shapes (1e-5); gradients through the
   autograd.Function (rtol 1e-4, atol 1e-5 x the gradient's largest
   magnitude); times at the learner's and the actor's shapes, bound and
   the cuDNN baseline (two F.conv2d calls with the relus and the add).
   Then the general kernel, at shapes past the tuned kernels' shared
   memory (bf16 C = 96 and 128; f32 (C, W) = (48, 42) and (64, 21)): the
   same gates, one general launch a call and none of the tuned kernels',
   two launches bit-identical; its time, bound and the cuDNN pair's at
   (8, 42, 42, 48) in f32.
6. fused_loss: the fused loss's forward kernel against its plain version
   at (T, B, A) = (20, 32, 6), (100, 32, 15), (1, 1, 2), (7, 130, 4),
   (20, 64, 15) (procgen's: one full cluster) x
   the three threshold sets x lambda, with a mask with zeros (the five
   sums rtol 1e-5; vs, the advantages, lse and the entropy <= 1e-5
   absolute), its backward kernel against its plain version (rtol 1e-5,
   atol 1e-6 x the largest gradient), two launches of each bit-identical,
   and the whole loss through both kernels (one launch of each a call)
   against the loss through the plain versions, reductions sum and mean
   (logs and gradients rtol 1e-5); times, device times and bounds of each
   kernel at the pong_transformer shape (20, 32, 6), and of one loss call
   with its backward, every kernel it launches summed (no single PyTorch
   call computes either kernel).
7. attention: both kernels' machine code holds `HMMA` (mma.sync)
   instructions in each of their ten instantiations; the forward and the
   backward (one call: dq, dk and dv) against their plain versions at the
   learner's shape (B=32, T=21, H=4, dh=64, W=128: S=149, episodes that
   reset mid-unroll, a cache partly of an older episode or empty), a long
   one (B=2, T=1024), ragged ones (T=1 with W=0; dh 16 and 32) and head
   widths 8 and 128, each in f32 and bf16: f32 forward <= 2e-5 absolute
   (TF32 off), gradients rtol 1e-4, atol 1e-5 x the largest gradient,
   bf16 within one bf16 rounding; bf16 dtypes through the
   autograd.Function; two forward launches and two backward launches
   bit-identical at the learner and long shapes. Head widths 257, 320
   and 512 in f32 and bf16 on the general kernels (csrc/attention_wide.cu)
   at the same gates, one wide launch each way a call and none of the
   tiled kernels'; their time, bound and SDPA's at (B=8, T=21, H=4,
   dh=512, W=128) in f32, two launches bit-identical. Times of each call and
   its plain version at those two
   shapes (events, and device time with every kernel of the call summed),
   bounds, `F.scaled_dot_product_attention` with the same boolean mask as
   the yardstick (its forward alone and its backward alone, events and
   device time, and the kernels it runs), and fwd + bwd of the kernels
   against the einsum branch: the measurement behind
   configs.KERNEL_MIN_SCORE_ELEMS.
8. model: the Pong net, the Breakout net (deep torso + LSTM, fused
   blocks off and on) and the pong_transformer net (kernel branch, from
   a warm cache) on the card against the same nets on the CPU, f32 (TF32
   off) and bf16 torso, on a small input; each unroll has a `first`
   reset in the middle, the Breakout one a non-zero start state.
9. pong: `loop.train` with the PONG preset at full width (84x84x4 uint8,
   Nature-CNN, bf16 torso, T=20, B=32) on the card, three runs, each
   with every kernel's launch count zeroed just before and read just
   after, its loop steps/s and env frames/s from the first logged
   learner step from the 5th on, a profiled short run (6 learner steps)
   for the device's idle share, V-trace launches a
   step (>= 1) and `os.cpu_count()`:
   - "pong": the preset as configured, 32 env worker processes in two
     pools of 16, lockstep, each pool driven by a batched-inference
     thread on the card, the queue feed; 20 learner steps. At the 5th
     step no worker is among nvidia-smi's compute apps or holds the card's
     device files (this process does); after the run every worker has
     exited and no shared-memory segment of the pools is left. Then one
     pool of 16 workers alone: its lockstep step, and one actor thread
     driving it;
   - "pong_ring": the same with `traj_ring=True`, and: the ring's slots
     are pinned host memory, the first 4 ring batches on the card equal
     a host copy of their slot taken just before its release, and the
     ring's feed of one batch (one pinned slot to the card on a side
     stream) is timed against the queue feed's (np.stack of 32 unrolls
     plus pageable copies);
   - "pong_thread": 4 thread actors x 8 envs, 12 learner steps, with the
     learner's train step alone on a fixed batch, one actor alone and
     one fake env step.
10. pong_superbatch: the PONG preset as `run.py --superbatch-k 4`
   configures it (the preset's 32 worker processes, the trajectory ring
   with superbatch slots, `donate_batch`, 4 steps a dispatch) through
   `loop.train` for 20 dispatches (80 learner steps), as pong_ring, the
   workers' checks included: V-trace launched exactly 4 times a dispatch
   and held to its plain version on the run's own first learner input
   (1e-5); the ring's slots pinned, `device_queue_depth + 4` of them,
   each `[4, 21, 32, 84, 84, 4]`; every slot release finding the event
   recorded after the step that consumed it completed; on a fixed
   superbatch one dispatch equal bit for bit to 4 `train_step`s on its
   slices, from the same params, with cuDNN's deterministic algorithms;
   the dispatch alone (events ms, device-busy ms, kernels), one step
   alone, the dispatch's peak device memory, the pinned slots' bytes and
   allocation seconds, and the loop's env frames/s and final param lag
   beside pong_ring's from the same call. No profiled run: the smoke
   keeps its length.
11. resume: the PONG preset as configured (32 worker processes, queue
   feed) through `loop.train` with checkpoints. Run 1: an
   `AsyncCheckpointer` (interval 4, keep 3) and a fault plan (one env
   worker SIGKILLed, actor 0 raised at an unroll start, the third save
   corrupted, the learner crashed at step 14) must end in `ChaosError`
   after a pool restart and a supervisor restart, with saves at steps 4,
   8 and 12, step 12's file corrupt and the others loadable, no
   half-written file, every worker exited, no process left, and the
   step-8 file equal bit for bit to the state read synchronously on the
   learner thread at step 8. The restore alone, into a fresh learner on
   the card, falls back past step 12 to step 8 (timed). Run 2
   (`resume="auto"`, 16 steps) must restore step 8 (the params equal to
   the file, the actors' first version the restored frame count), reach
   step 16 with >= 8 V-trace launches and write its final save. Run 3:
   the synchronous `Checkpointer` every 4 steps, a crash at step 6, a
   resume from step 4 to 8. Then its numbers, each on a line with the
   card's name and power limit: the train step on a fixed batch alone
   and with an async save in its window (CUDA events) and the loop's
   step windows with and without one (host clock), the clone's ms on
   the learner thread, the writer's seconds and bytes a save, the
   restore's seconds. Its temporary directory is removed.
12. breakout: `loop.train` with the BREAKOUT preset (IMPALA deep ResNet,
   LSTM(256) core, bf16 torso, 4 actions) as 4 thread actors x 8 envs
   for 12 learner steps, as pong_thread, once with the preset's unfused
   blocks and once with `fused_conv=True`.
13. breakout_bf16: the BREAKOUT preset with `train_dtype="bfloat16"` (the
   bf16 train step: params lowered from the f32 masters inside the
   differentiated step) and the fused blocks, on 4 thread actors x 8
   envs for 12 learner steps, as breakout_superbatch: >= 1 V-trace, 21
   LSTM-cell and 6 residual-block (N = 672) launches a learner step, each
   kernel held to its plain version on the run's own learner inputs at
   the gates of phases 3-5; the params and RMSProp moments float32 after
   the run; on a fixed batch with non-zero LSTM start states, the
   gradient-rounding contract (every torso and head grad
   bf16-representable, no LSTM grad); the greedy-action gate's (ok,
   mismatches) on the card, built as `run.py --train-dtype bfloat16`
   builds the config and failing the phase where run.py would fall back
   to f32; then the bf16 train step alone against the
   f32 one (the same preset with its bf16 torso) from the run's final
   state, twice each, alternating: events ms, device-busy ms, kernels a
   step, peak MB. No profiled run: the smoke keeps its length.
14. breakout_accum: the BREAKOUT preset at full width with the fused
   blocks, both memory levers (`grad_accum=2`, `remat_torso=True`), the
   lr scaled by B / 16 with a 4-step warmup and `publish_interval=2`:
   `loop.train` as in breakout for 12 steps (>= 2 V-trace, 42 LSTM-cell
   and 24 residual-block launches a step); the param store's versions
   must be the frame counts of steps 0, 2, ..., 12 and nothing else, and
   the lr of each optimizer step at counts 0-5 `make_lr_schedule`'s. No
   profiled run (50-72 s on the card): the smoke keeps its length.
   Then, from the loop's final state, one train step alone on a fixed
   batch with non-zero LSTM start states for (G, remat) = (1, off)
   twice, (2, off), (1, on) and (2, on), each in a learner of its own
   after one warm-up step: the (2, on) step launches V-trace 2, the LSTM
   cell 42 and the residual block 24 times, and 12 with remat off; remat
   on equals remat off bit for bit at G = 1 and 2, as the two plain steps
   equal each other (if any of these pairs differs, every step is taken
   again with cuDNN's deterministic algorithms and the pairs must then
   agree; the line says which pairs differed without them); the (2, on)
   step against the (1, off) step, by the relative L2 distance of their
   param steps and by the unclipped grad norm: with an f32 torso both
   within 1e-3, with the bf16 torso below the bf16 torso's own distance
   and grad-norm change from the f32 one (plus 1e-3 of the grad norm);
   each lever's peak device memory below (1, off)'s.
15. breakout_superbatch: the BREAKOUT preset with the fused blocks at 2
   steps a dispatch (the queue feed's in-place superbatch assembly) on 4
   thread actors x 8 envs for 6 dispatches: V-trace exactly once a
   learner step, >= 21 LSTM-cell and >= 6 residual-block launches a
   learner step; the cell (B = 32) and the block (N = 672, its three
   shapes) held to their plain versions on the run's own first learner
   inputs, at the gates of phases 4 and 5. No profiled run (≈ 45 s on
   the card): the smoke keeps its length. Its env frames/s spans three
   dispatches (steps 6 to 12) and is recorded, not compared.
16. pong_transformer: the same with the PONG_TRANSFORMER preset
   (Nature-CNN bf16 torso, transformer core d_model 256, 2 layers, 4
   heads, window 128) for 12 learner steps with the attention kernels
   forced and `fused_epilogue=True`; it must launch the attention
   forward and backward >= 2 times a learner step each, the fused loss's
   forward and backward >= once each and V-trace never.
17. procgen: the PROCGEN preset (IMPALA deep ResNet without a core,
   64x64x3 uint8, 15 actions, bf16 torso, T=20, B=64, the async
   ready-set pool at `pool_ready_fraction` 0.5) as `run.py --config
   procgen --fake-envs --num-actors 64 --fused-conv` configures it, its
   `dp_devices=-1` resolved to one device: 64 env worker processes of
   one env in two pools of 32 (waves of 16, or every ready worker) in
   place of 512, through `loop.train` for 12 learner steps, as pong (the
   workers' checks included), with the train step alone and a profiled
   run of 6 steps: V-trace >= 1 launch a step and held to its plain
   version on the run's own [20, 64] input (1e-5); the residual block
   >= 6 launches a learner step at the learner's N (counted apart from
   the actors' waves), and held to its plain version on the main run's
   own inputs (not the train step alone's or the profiled run's) at
   every shape it was launched at (the learner's N
   = 1344 at 32x32x16, 16x16x32 and 8x8x32, and each N the actors' waves
   gave it), at the bf16 gate of phase 5.

18. health: the training-health plane. (a) The BREAKOUT preset with the
   fused blocks and `health_diagnostics`, one train step with the fused
   loss and one with the separate loss from the same seed-0 params on a
   fixed batch (non-zero LSTM start states, cuDNN deterministic): the
   same 23 `health_*` keys, each within 1e-4 relative + 1e-5 absolute of
   the other; V-trace, the fused loss's forward and its backward one
   launch each in the fused step, V-trace one in the separate one. (b)
   The fused step's diagnostic V-trace launch held to its plain version
   on the step's own input (1e-5). (c) The train step alone on a fixed
   batch, health off and on, for Breakout (fused blocks) on the fused
   loss and Pong on the separate loss, through
   `compare_builds.train_step_numbers` (as that script times a parent
   tree): events ms, device-busy ms and kernels a step, and the kernels
   health on adds by name; health on must launch no fewer of any kernel.
   (d) `run.py --config pong --fake-envs --health --total-steps 10
   --log-every 1` (the preset's 32 worker processes): the registry holds
   every `health/*` gauge of the Pong net (`expected_health_gauges`),
   each finite; then the same with a `crash_learner` plan at step 3 must
   raise ChaosError and leave exactly one `*_crash` bundle whose
   `postmortem.json`, `flight_tail.json` (a valid Chrome trace) and
   `snapshots.jsonl` load.

Then, whether the phases passed or failed, every process the run started
is stopped: the pools' forkserver and resource tracker (they outlive the
pools), then any descendant still alive after 5 s, which fails the run.
Then the `kernels` line (the general kernels beside the tuned ones they
stand in for, with the same `replaces`; no main path reaches their
shapes, so their launches read 0), the card's name and power limit, and
the last line `{"ok": true, "device": {...}}`. Without CUDA it exits 2
and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
# Both attention kernels do their f32 products on the tensor cores as
# 3xTF32, three TF32 products for each: the card's dense TF32 rate over 3
# bounds them, where the f32 rate outside the tensor cores would read as
# slower than the kernels themselves.
PEAK_TF32_SPLIT_OPS_PER_S = 495e12 / 3
PEAK_BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
# V-trace (T, B): the Pong shape first (timed), then longer unrolls, wider
# batches, one step over a 32-step chunk with a ragged second tile, ragged
# ones, breakout_accum's microbatch (B = 32 / 2) and the procgen learner's.
KERNEL_SHAPES = [(20, 32), (100, 32), (20, 256), (1, 1), (7, 130), (33, 33), (1000, 32),
                 (20, 16), (20, 64)]
# Unroll lengths of the V-trace kernel's device-time sweep at B = 32: the
# slope is what each step of T costs.
VTRACE_SWEEP_T = (20, 100, 1000)
THRESHOLDS = [
    dict(),
    dict(clip_rho_threshold=None, clip_c_threshold=None, clip_pg_rho_threshold=None),
    dict(clip_rho_threshold=0.5, clip_c_threshold=2.0, clip_pg_rho_threshold=2.0),
]
PONG_STEPS = 20
# The thread-actor Pong run beside the preset's process actors.
PONG_THREAD_STEPS = 12
# Ring batches whose device copy is held to a host copy of its slot.
RING_PROBE_BATCHES = 4
BREAKOUT_STEPS = 12
# The profiled short run's learner steps (8 before the superbatch phases
# came; cut so that the smoke keeps its length).
PROFILED_STEPS = 6
# The superbatch phases: Pong with --superbatch-k 4 for 20 dispatches,
# Breakout fused at 2 steps a dispatch for 6.
SUPERBATCH_K = 4
PONG_SUPERBATCH_DISPATCHES = 20
BREAKOUT_SUPERBATCH_K = 2
BREAKOUT_SUPERBATCH_DISPATCHES = 6
# B, F, H: the learner's and the actors' shapes first (both timed), then
# ragged ones: one unit, K tiled past one stage, two row tiles; last,
# breakout_accum's microbatch (B = 32 / 2).
LSTM_SHAPES = [(32, 256, 256), (8, 256, 256), (1, 7, 7), (33, 100, 130), (1, 1, 1),
               (2, 3, 300), (64, 512, 256), (16, 256, 256)]
LSTM_MIN_BLOCKS = 128  # the grid at H = 256, whatever B
LSTM_ATOL = 5e-5
# (N, H, W, C): the learner's three block shapes (21 x 32 images), then
# one actor's (8 envs); all are timed, the learner's are the kernels
# line's sums.
BLOCK_LEARNER_SHAPES = [(672, 42, 42, 16), (672, 21, 21, 32), (672, 11, 11, 32)]
BLOCK_SHAPES = BLOCK_LEARNER_SHAPES + [(8, 42, 42, 16), (8, 21, 21, 32), (8, 11, 11, 32)]
# breakout_accum's three block shapes (a microbatch of 21 x 16 images),
# held to the plain block but not timed.
BLOCK_ACCUM_SHAPES = [(336, 42, 42, 16), (336, 21, 21, 32), (336, 11, 11, 32)]
# The procgen learner's three block shapes (21 x 64 images of 64x64x3),
# then two of its async actors' wave sizes (16 and 32 workers of one env),
# held to the plain block but not timed.
BLOCK_PROCGEN_LEARNER_SHAPES = [(1344, 32, 32, 16), (1344, 16, 16, 32), (1344, 8, 8, 32)]
BLOCK_PROCGEN_SHAPES = BLOCK_PROCGEN_LEARNER_SHAPES + [
    (n, h, w, c) for n in (16, 32) for _, h, w, c in BLOCK_PROCGEN_LEARNER_SHAPES]
# Channel counts the bf16 kernel zero-pads (to 32, 16 and 80; at 80 each
# conv's kernel is staged before that conv).
BLOCK_BF16_PADDED_SHAPES = [(3, 13, 7, 24), (2, 13, 21, 1), (2, 9, 9, 72)]
BLOCK_F32_SHAPES = [(3, 13, 7, 24), (2, 42, 42, 16), (1, 1, 1, 1)]
# Shapes past the tuned kernels' shared memory, which take the general
# kernel: bf16 with C above 80, f32 where two staged kernels and a one-row
# band pass 227 KB (C = 48 from W = 42; C = 64 at any W). The last is
# timed for the kernels line.
BLOCK_GENERAL_CASES = [
    ((2, 9, 9, 96), "bfloat16"), ((2, 7, 11, 128), "bfloat16"),
    ((2, 5, 42, 48), "float32"), ((2, 21, 21, 64), "float32"), ((8, 42, 42, 48), "float32"),
]
BF16_ULP = 2.0**-7
# T, B, A; (20, 64, 15) is procgen's: one full cluster, 15 actions.
FUSED_SHAPES = [(20, 32, 6), (100, 32, 15), (1, 1, 2), (7, 130, 4), (20, 64, 15)]
# (B, T, H, dh, W): the learner's (T + 1 = 21 queries over S = W + 21),
# a long unroll, and ragged ones.
ATTN_LEARNER = (32, 21, 4, 64, 128)
ATTN_LONG = (2, 1024, 4, 64, 128)
ATTN_RAGGED = [(3, 1, 2, 16, 0), (3, 9, 2, 16, 7), (5, 40, 3, 32, 19)]
# Head widths beside the learner's 64: dh 8 runs zero-padded to 16, and
# 128 is the instantiation whose dK/dV arrays first pass 48 KB; each in
# f32 and bf16.
ATTN_WIDTHS = [(3, 9, 2, 8, 7), (2, 40, 2, 128, 19)]
ATTN_F32_ATOL = 2e-5
# Head widths past the tiled kernels' 256, which take the general kernels
# of csrc/attention_wide.cu, each in f32 and bf16; then the shape they are
# timed at (f32).
ATTN_WIDE = [(2, 21, 2, dh, 19) for dh in (257, 320, 512)]
ATTN_WIDE_TIMED = (8, 21, 4, 512, 128)
PONG_TRANSFORMER_STEPS = 12
# The procgen phase: the preset's async pool cut to 64 worker processes of
# one env (two pools of 32, waves of 16 or every ready worker).
PROCGEN_STEPS = 12
PROCGEN_WORKERS = 64
# Kernels that share a source file with another.
SOURCES = {
    "fused_loss_fwd": "fused_loss", "fused_loss_bwd": "fused_loss",
    "attention_wide_fwd": "attention_wide", "attention_wide_bwd": "attention_wide",
    "resblock_general": "resblock",
}


START = time.monotonic()


def emit(obj) -> None:
    """Print one JSON line; a phase's line also gets the script's elapsed
    seconds when it ends."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=time.monotonic() - START)
    print(json.dumps(obj), flush=True)


def vtrace_inputs(T, B, seed, device):
    import torch

    rng = np.random.default_rng(seed)
    arrays = dict(
        log_rhos=rng.normal(size=(T, B)) * 0.5,
        discounts=0.99 * (rng.uniform(size=(T, B)) > 0.15),
        rewards=rng.normal(size=(T, B)),
        values=rng.normal(size=(T, B)),
        bootstrap_value=rng.normal(size=(B,)),
    )
    return {
        k: torch.from_numpy(v.astype(np.float32)).to(device) for k, v in arrays.items()
    }


def time_cuda(fn, iters=200, warmup=20) -> float:
    """Median milliseconds of `fn` over `iters` calls, each between two
    CUDA events, after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(bytes_moved, ops, peak_ops):
    """(least ms, what binds it): bytes over the memory rate against
    operations over the peak rate of their type."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_env():
    import torch

    from torched_impala_tpu_torch.device import configure_precision

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    emit(
        {
            "phase": "env",
            "nvidia_smi": smi,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "python": sys.version.split()[0],
            "tf32": configure_precision(),
        }
    )
    return smi


def phase_build():
    from torched_impala_tpu_torch.ops import _build

    names = _build.kernel_names()
    t0 = time.monotonic()
    _build.build_all(names)
    for name in names:
        _build.load(name)
    emit(
        {
            "phase": "build",
            "kernels": names,
            "seconds": round(time.monotonic() - t0, 3),
            "dir": str(_build.build_dir()),
        }
    )
    return names


def phase_vtrace(device):
    import torch

    from torched_impala_tpu_torch.ops import losses, profiling, vtrace_cuda
    from torched_impala_tpu_torch.ops.vtrace import vtrace_reference

    worst = 0.0
    per_shape = {}
    for T, B in KERNEL_SHAPES:
        x = vtrace_inputs(T, B, seed=T * 1000 + B, device=device)
        err = 0.0
        for clips in THRESHOLDS:
            for lambda_ in (1.0, 0.9):
                out = vtrace_cuda.vtrace_cuda(**x, **clips, lambda_=lambda_)
                ref = vtrace_reference(**x, **clips, lambda_=lambda_)
                torch.cuda.synchronize()
                for a, b in zip(out, ref):
                    err = max(err, float((a - b).abs().max()))
        per_shape[f"{T}x{B}"] = err
        worst = max(worst, err)
    if not worst <= 1e-5:
        raise AssertionError(f"vtrace kernel vs plain: max abs err {per_shape}")
    # A NaN log-ratio must give NaN where the plain version does.
    x = vtrace_inputs(20, 32, seed=5, device=device)
    x["log_rhos"][7, 3] = float("nan")
    for clips in THRESHOLDS:
        out = vtrace_cuda.vtrace_cuda(**x, **clips)
        ref = vtrace_reference(**x, **clips)
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, equal_nan=True)

    T, B = 20, 32
    x = vtrace_inputs(T, B, seed=7, device=device)
    kernel_ms = time_cuda(lambda: vtrace_cuda.vtrace_cuda(**x))
    plain_ms = time_cuda(lambda: vtrace_reference(**x))
    # Where the kernel's time goes: the wrapper's host cost per call
    # (back-to-back calls, one synchronize at the end) and the kernel's
    # own device time from the profiler.
    calls = 1000
    t0 = time.perf_counter()
    for _ in range(calls):
        vtrace_cuda.vtrace_cuda(**x)
    torch.cuda.synchronize()
    wrapper_host_us = (time.perf_counter() - t0) / calls * 1e6
    device_us, _ = profiling.device_us(
        lambda: vtrace_cuda.vtrace_cuda(**x), name="vtrace_kernel"
    )
    sweep_us = {}
    for T_sweep in VTRACE_SWEEP_T:
        xs = vtrace_inputs(T_sweep, B, seed=T_sweep, device=device)
        sweep_us[str(T_sweep)], _ = profiling.device_us(
            lambda: vtrace_cuda.vtrace_cuda(**xs), calls=100, name="vtrace_kernel"
        )
    bytes_moved = (4 * T * B + B) * 4 + 3 * T * B * 4
    # Per element: exp, three clips, and 12 multiplies/adds of the
    # recursion and the two output formulas.
    ops = 16 * T * B
    bound_s = max(bytes_moved / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S)
    bound_by = "bytes" if bytes_moved / PEAK_BYTES_PER_S >= ops / PEAK_F32_OPS_PER_S else "operations"

    # impala_loss through the kernel vs through the plain V-trace, all
    # else identical on the card.
    rng = np.random.default_rng(11)
    A = 6

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    inputs = dict(
        behaviour_logits=t(rng.normal(size=(T, B, A))),
        bootstrap_value=t(rng.normal(size=(B,))),
        actions=torch.from_numpy(rng.integers(0, A, size=(T, B))).to(device),
        rewards=t(rng.normal(size=(T, B))),
        discounts=t(0.99 * (rng.uniform(size=(T, B)) > 0.05)),
    )
    logits0 = rng.normal(size=(T, B, A))
    values0 = rng.normal(size=(T, B))

    def loss_and_grads():
        logits = t(logits0).requires_grad_()
        values = t(values0).requires_grad_()
        out = losses.impala_loss(target_logits=logits, values=values, **inputs)
        g = torch.autograd.grad(out.total, (logits, values))
        return out.total.detach(), g

    total_k, grads_k = loss_and_grads()
    real_vtrace = losses.vtrace
    losses.vtrace = vtrace_reference
    try:
        total_p, grads_p = loss_and_grads()
    finally:
        losses.vtrace = real_vtrace
    torch.testing.assert_close(total_k, total_p, rtol=1e-5, atol=1e-6)
    for gk, gp in zip(grads_k, grads_p):
        torch.testing.assert_close(gk, gp, rtol=1e-5, atol=1e-6)
    loss_err = max(float((gk - gp).abs().max()) for gk, gp in zip(grads_k, grads_p))
    emit(
        {
            "phase": "vtrace",
            "max_abs_err": worst,
            "max_abs_err_by_shape": per_shape,
            "pong_shape": [T, B],
            "kernel_us": kernel_ms * 1e3,
            "plain_us": plain_ms * 1e3,
            "wrapper_host_us": wrapper_host_us,
            "kernel_device_us_profiler": device_us,
            "device_us_by_T_at_B32": sweep_us,
            "bound_us": bound_s * 1e6,
            "bound_by": bound_by,
            "bytes": bytes_moved,
            "library_call": None,
            "impala_loss_total": [float(total_k), float(total_p)],
            "impala_loss_grad_max_abs_diff": loss_err,
        }
    )
    return dict(
        max_abs_err=worst,
        ms=kernel_ms,
        plain_ms=plain_ms,
        bound_ms=bound_s * 1e3,
        bound_by=bound_by,
    )


def phase_lstm(device):
    import torch

    from torched_impala_tpu_torch.ops import lstm, lstm_cuda, profiling

    def inputs(B, F, H, seed):
        rng = np.random.default_rng(seed)
        arrays = [
            rng.normal(size=(B, F)),
            rng.normal(size=(B, H)),
            rng.normal(size=(B, H)),
            rng.normal(size=(F, 4 * H)) / np.sqrt(F),
            rng.normal(size=(H, 4 * H)) / np.sqrt(H),
            rng.normal(size=(4 * H,)) * 0.1,
        ]
        return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]

    per_shape = {}
    for B, F, H in LSTM_SHAPES:
        args = inputs(B, F, H, seed=B + F + H)
        out = lstm_cuda.lstm_cell_cuda(*args)
        again = lstm_cuda.lstm_cell_cuda(*args)
        ref = lstm.lstm_reference(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            raise AssertionError(f"lstm kernel: two launches differ at {(B, F, H)}")
        per_shape[f"{B}x{F}x{H}"] = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    worst = max(per_shape.values())
    if not worst <= LSTM_ATOL:
        raise AssertionError(f"lstm kernel vs plain: max abs err {per_shape}")

    B, F, H = LSTM_SHAPES[0]
    args = inputs(B, F, H, seed=1)
    grad_args = [a.clone().requires_grad_() for a in args]
    c, h = lstm.lstm_cell_fused(*grad_args)
    g_kernel = torch.autograd.grad((c * 0.5 + h).sum(), grad_args)
    c, h, _ = lstm.lstm_reference(*grad_args)
    g_plain = torch.autograd.grad((c * 0.5 + h).sum(), grad_args)
    for a, b in zip(g_kernel, g_plain):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    grad_err = max(float((a - b).abs().max()) for a, b in zip(g_kernel, g_plain))

    timed = {}
    for B, F, H in LSTM_SHAPES[:2]:
        args = inputs(B, F, H, seed=1)
        x, h, c, wi, wh, b = args
        w_ih, w_hh, zeros = wi.t().contiguous(), wh.t().contiguous(), torch.zeros_like(b)
        lib_h, lib_c = torch.lstm_cell(x, (h, c), w_ih, w_hh, b, zeros)
        ref_c, ref_h, _ = lstm.lstm_reference(*args)
        library_err = max(float((lib_c - ref_c).abs().max()), float((lib_h - ref_h).abs().max()))
        grids = profiling.launched_grids(lambda: lstm_cuda.lstm_cell_cuda(*args), "lstm_cell_kernel")
        blocks = [g[0] * g[1] * g[2] for g in grids]
        if len(blocks) != 1 or blocks[0] < LSTM_MIN_BLOCKS:
            raise AssertionError(f"lstm kernel at {(B, F, H)}: grids {grids}, expected one of >= {LSTM_MIN_BLOCKS} blocks")
        kernel_ms = time_cuda(lambda: lstm_cuda.lstm_cell_cuda(*args))
        plain_ms = time_cuda(lambda: lstm.lstm_reference(*args))
        library_ms = time_cuda(lambda: torch.lstm_cell(x, (h, c), w_ih, w_hh, b, zeros))
        device_us, _ = profiling.device_us(
            lambda: lstm_cuda.lstm_cell_cuda(*args), name="lstm_cell_kernel"
        )
        library_device_us, library_kernels = profiling.device_us(
            lambda: torch.lstm_cell(x, (h, c), w_ih, w_hh, b, zeros)
        )
        bytes_moved = 4 * (B * F + 2 * B * H + (F + H) * 4 * H + 4 * H) + 4 * (2 * B * H + B * 4 * H)
        # The two gate products, the gate adds, and the cell's elementwise
        # work counting each activation as one operation.
        ops = 2 * B * (F + H) * 4 * H + 2 * B * 4 * H + 8 * B * H
        bound_ms, bound_by = bound(bytes_moved, ops, PEAK_F32_OPS_PER_S)
        timed[f"{B}x{F}x{H}"] = dict(
            grid_blocks=blocks[0],
            kernel_us=kernel_ms * 1e3,
            kernel_device_us_profiler=device_us,
            plain_us=plain_ms * 1e3,
            library_us=library_ms * 1e3,
            library_device_us_profiler=library_device_us,
            library_kernels_a_call=library_kernels,
            library_max_abs_err_vs_plain=library_err,
            bound_us=bound_ms * 1e3,
            bound_by=bound_by,
            bytes=bytes_moved,
            ops=ops,
        )
        if (B, F, H) == LSTM_SHAPES[0]:
            learner = dict(
                max_abs_err=worst, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms,
            )
    emit(
        {
            "phase": "lstm",
            "max_abs_err": worst,
            "max_abs_err_by_shape": per_shape,
            "tolerance": LSTM_ATOL,
            "two_launches_bit_identical": True,
            "grad_max_abs_diff": grad_err,
            "timed": timed,
        }
    )
    return learner


def phase_resblock(device):
    import torch
    import torch.nn.functional as F

    from torched_impala_tpu_torch.ops import _build, conv_block, conv_block_cuda, profiling

    def inputs(N, H, W, C, dtype, seed):
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(rng.normal(size=(N, H, W, C)).astype(np.float32))
        params = [
            rng.normal(size=(3, 3, C, C)) / np.sqrt(9 * C),
            rng.normal(size=(C,)) * 0.1,
            rng.normal(size=(3, 3, C, C)) / np.sqrt(9 * C),
            rng.normal(size=(C,)) * 0.1,
        ]
        return [x.to(device=device, dtype=dtype)] + [
            torch.from_numpy(a.astype(np.float32)).to(device) for a in params
        ]

    # The bf16 kernel's products run on the tensor cores: count the wgmma
    # instructions (HGMMA in SASS) in each of its instantiations.
    hgmma = {}
    for function, count in _build.sass_counts("resblock", "HGMMA").items():
        match = re.search(r"resblock_bf16_wgmma_kernelILi(\d+)E", function)
        if match:
            hgmma[f"resblock_bf16_wgmma_kernel<{match.group(1)}>"] = count
    if not hgmma or min(hgmma.values()) == 0:
        raise AssertionError(f"resblock: bf16 kernels without HGMMA instructions: {hgmma}")

    def library_block(x_nchw, w1, b1, w2, b2):
        out = F.conv2d(F.relu(x_nchw), w1, b1, padding=1)
        return x_nchw + F.conv2d(F.relu(out), w2, b2, padding=1)

    per_shape, equal_share, plans = {}, {}, {}
    for shape in BLOCK_SHAPES + BLOCK_ACCUM_SHAPES + BLOCK_PROCGEN_SHAPES + BLOCK_BF16_PADDED_SHAPES:
        args = inputs(*shape, torch.bfloat16, seed=shape[1])
        out = conv_block_cuda.resblock_cuda(*args)
        ref = conv_block.block_reference(*args)
        torch.cuda.synchronize()
        key = "x".join(map(str, shape))
        plans[key] = dataclasses.asdict(conv_block_cuda.bf16_launch_plan(*shape))
        per_shape[key] = float((out.float() - ref.float()).abs().max())
        equal_share[key] = float((out == ref).float().mean())
        torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_ULP, atol=BF16_ULP)
        if equal_share[key] < 0.99:
            raise AssertionError(f"resblock {key}: only {equal_share[key]} of elements equal")
    f32_err = {}
    for shape in BLOCK_F32_SHAPES:
        args = inputs(*shape, torch.float32, seed=3)
        out = conv_block_cuda.resblock_cuda(*args)
        ref = conv_block.block_reference(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        f32_err["x".join(map(str, shape))] = float((out - ref).abs().max())

    # The general kernel, at shapes the tuned kernels' shared memory does
    # not hold: one general launch a call, none of the tuned kernels',
    # the tuned kernels' gates, two launches bit-identical.
    general_err = {}
    tuned_before, general_before = conv_block_cuda.LAUNCHES, conv_block_cuda.GENERAL_LAUNCHES
    for shape, dtype_name in BLOCK_GENERAL_CASES:
        dtype = getattr(torch, dtype_name)
        if conv_block_cuda.route(dtype, shape[2], shape[3]) != "general":
            raise AssertionError(f"resblock: {shape} {dtype_name} does not route to the general kernel")
        args = inputs(*shape, dtype, seed=shape[3])
        out = conv_block_cuda.resblock_cuda(*args)
        again = conv_block_cuda.resblock_cuda(*args)
        ref = conv_block.block_reference(*args)
        torch.cuda.synchronize()
        key = f"{dtype_name}_" + "x".join(map(str, shape))
        if not torch.equal(out, again):
            raise AssertionError(f"resblock general {key}: two launches differ")
        if dtype == torch.bfloat16:
            torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_ULP, atol=BF16_ULP)
            if float((out == ref).float().mean()) < 0.99:
                raise AssertionError(f"resblock general {key}: under 99% of elements equal")
        else:
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        general_err[key] = float((out.float() - ref.float()).abs().max())
    launched = (conv_block_cuda.LAUNCHES - tuned_before,
                conv_block_cuda.GENERAL_LAUNCHES - general_before)
    if launched != (0, 2 * len(BLOCK_GENERAL_CASES)):
        raise AssertionError(f"resblock general: launches (tuned, general) {launched}")
    general_shape = shape  # the last case, f32: timed
    N, H, W, C = general_shape
    args = inputs(*general_shape, torch.float32, seed=7)
    x, k1, b1, k2, b2 = args
    lib_args = (x.permute(0, 3, 1, 2), k1.permute(3, 2, 0, 1).contiguous(), b1,
                k2.permute(3, 2, 0, 1).contiguous(), b2)
    general_bytes = 2 * N * H * W * C * 4 + 4 * (2 * 9 * C * C + 2 * C)
    general_ops = 2 * 2 * 9 * C * C * N * H * W + 5 * N * H * W * C
    general_bound_ms, general_bound_by = bound(general_bytes, general_ops, PEAK_F32_OPS_PER_S)
    general = dict(
        max_abs_err=max(general_err.values()),
        ms=time_cuda(lambda: conv_block_cuda.resblock_cuda(*args), iters=20, warmup=3),
        plain_ms=time_cuda(lambda: conv_block.block_reference(*args), iters=20, warmup=3),
        bound_ms=general_bound_ms,
        bound_by=general_bound_by,
        library_ms=time_cuda(lambda: library_block(*lib_args), iters=20, warmup=3),
    )
    general_device_us, general_kernels = profiling.device_us(
        lambda: conv_block_cuda.resblock_cuda(*args), calls=10, name="resblock_general"
    )

    grad_args = [t.requires_grad_() for t in inputs(4, 11, 11, 32, torch.float32, seed=5)]
    g_kernel = torch.autograd.grad(
        conv_block.fused_residual_block(*grad_args).square().sum(), grad_args
    )
    g_plain = torch.autograd.grad(
        conv_block.block_reference(*grad_args).square().sum(), grad_args
    )
    # dout = 2 * out carries the forward's f32 rounding into each kernel
    # gradient, a sum over N*H*W positions: the bound scales with the
    # gradient's own magnitude.
    for a, b in zip(g_kernel, g_plain):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()))
    grad_err = max(float((a - b).abs().max()) for a, b in zip(g_kernel, g_plain))

    times, device_times = {}, []
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bytes=0, ops=0)
    for shape in BLOCK_SHAPES:
        N, H, W, C = shape
        args = inputs(*shape, torch.bfloat16, seed=7)
        x, k1, b1, k2, b2 = args
        # The unfused block's operands: bf16 NCHW views over channels-last
        # memory, OIHW bf16 kernels, bias inside the conv.
        oihw = [k.permute(3, 2, 0, 1).contiguous().bfloat16() for k in (k1, k2)]
        lib_args = (x.permute(0, 3, 1, 2), oihw[0], b1.bfloat16(), oihw[1], b2.bfloat16())
        kernel_ms = time_cuda(lambda: conv_block_cuda.resblock_cuda(*args), iters=50, warmup=5)
        plain_ms = time_cuda(lambda: conv_block.block_reference(*args), iters=50, warmup=5)
        library_ms = time_cuda(lambda: library_block(*lib_args), iters=50, warmup=5)
        device_us, _ = profiling.device_us(
            lambda: conv_block_cuda.resblock_cuda(*args), calls=20, name="resblock_bf16_wgmma"
        )
        library_device_us, _ = profiling.device_us(lambda: library_block(*lib_args), calls=20)
        bytes_moved = 2 * N * H * W * C * 2 + 4 * (2 * 9 * C * C + 2 * C)
        # Two convs (2 x 9C multiply-adds per output), two bias adds, two
        # relus and the skip add per output element.
        ops = 2 * 2 * 9 * C * C * N * H * W + 5 * N * H * W * C
        bound_ms, bound_by = bound(bytes_moved, ops, PEAK_BF16_OPS_PER_S)
        key = "x".join(map(str, shape))
        times[key] = dict(
            kernel_us=kernel_ms * 1e3, kernel_device_us_profiler=device_us,
            plain_us=plain_ms * 1e3, library_us=library_ms * 1e3,
            library_device_us_profiler=library_device_us,
            bound_us=bound_ms * 1e3, bound_by=bound_by,
        )
        if shape not in BLOCK_LEARNER_SHAPES:
            continue
        for k, v in (("ms", kernel_ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                     ("bound_ms", bound_ms), ("bytes", bytes_moved), ("ops", ops)):
            totals[k] += v
        device_times.append((device_us, library_device_us))
    # Profiler device times, kernel and cuDNN pair (None where it saw none).
    for i, k in enumerate(("device_ms", "library_device_ms")):
        us = [d[i] for d in device_times]
        totals[k] = None if None in us else sum(us) / 1e3
    total_bound_by = bound(totals["bytes"], totals["ops"], PEAK_BF16_OPS_PER_S)[1]
    worst = max(per_shape.values())
    emit(
        {
            "phase": "resblock",
            "hgmma_instructions": hgmma,
            "bf16_launch_plans": plans,
            "max_abs_err_bf16": worst,
            "max_abs_err_bf16_by_shape": per_shape,
            "equal_share_bf16_by_shape": equal_share,
            "max_abs_err_f32_by_shape": f32_err,
            "grad_max_abs_diff": grad_err,
            "times_by_shape": times,
            "sum_over_the_three_learner_shapes": dict(totals, bound_by=total_bound_by),
            "general_max_abs_err_by_case": general_err,
            "general_timed": dict(
                general, shape=list(general_shape), dtype="float32",
                device_us_profiler=general_device_us,
                kernels_a_call=general_kernels, bytes=general_bytes, ops=general_ops,
            ),
        }
    )
    return {
        "resblock": dict(
            max_abs_err=max(worst, *f32_err.values()), ms=totals["ms"],
            plain_ms=totals["plain_ms"], bound_ms=totals["bound_ms"],
            bound_by=total_bound_by, library_ms=totals["library_ms"],
        ),
        "resblock_general": general,
    }


def loss_inputs(T, B, A, seed, device, mask_zeros=True):
    """The fused loss's inputs on `device`: logits and values (leaves to
    differentiate), behaviour logits, bootstrap, actions, rewards,
    discounts and a mask with zeros."""
    import torch

    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    mask = rng.uniform(size=(T, B)) > (0.2 if mask_zeros else -1.0)
    return dict(
        target_logits=t(rng.normal(size=(T, B, A))),
        values=t(rng.normal(size=(T, B))),
        behaviour_logits=t(rng.normal(size=(T, B, A))),
        bootstrap_value=t(rng.normal(size=(B,))),
        actions=torch.from_numpy(rng.integers(0, A, size=(T, B))).to(device),
        rewards=t(rng.normal(size=(T, B))),
        discounts=t(0.99 * (rng.uniform(size=(T, B)) > 0.05)),
        mask=t(mask),
    )


def fused_args(x):
    """The fused loss forward's operands from `loss_inputs`, in the order of
    `fused_core_reference`."""
    return tuple(x[k] for k in ("target_logits", "behaviour_logits", "actions", "values",
                                "bootstrap_value", "discounts", "rewards", "mask"))


def fused_bwd_args(args, seed):
    """The backward's operands after the plain forward of `args`, with three
    cotangents made from `seed`."""
    import torch

    from torched_impala_tpu_torch.ops import fused_loss

    z, _, actions, values, _, _, _, mask = args
    out = fused_loss.fused_core_reference(*args)
    g = np.random.default_rng(seed).normal(size=3)
    cot = [torch.tensor(float(v), dtype=torch.float32, device=z.device) for v in g]
    return (z, out.lse, out.ent, out.adv, out.vs, values, mask, actions, *cot)


def fused_work(T, B, A):
    """(forward bytes, forward ops, backward bytes, backward ops) of the two
    fused-loss kernels at (T, B, A): each input read once and each output
    written once; f32 operations counted from the formulas."""
    tb, tba = T * B, T * B * A
    # Forward: both logit cubes, int64 actions, values, discounts, rewards,
    # mask and the bootstrap read; vs, adv, lse, entropy and five sums
    # written. Per logit entry 13 operations (the target row's max, the
    # exp sum, log p, p * log p and its sum; the behaviour row's max and
    # exp sum); per step 32 (the V-trace's 16, log pi(a), log mu(a), the
    # log-ratio, lse and the five sums' terms).
    fwd_bytes = 2 * tba * 4 + tb * 8 + (4 * tb + B) * 4 + 4 * tb * 4 + 5 * 4
    fwd_ops = 13 * tba + 32 * tb
    # Backward: the logits, lse, entropy, adv, vs, values, mask, int64
    # actions and three cotangents read; dL/dz and dL/dvalues written. Per
    # logit entry 12 operations (log p, exp, p * log p, the two
    # coefficients, c1, the two products, the difference, the action's
    # add); per step 3 for dL/dvalues.
    bwd_bytes = tba * 4 + 6 * tb * 4 + tb * 8 + 3 * 4 + tba * 4 + tb * 4
    bwd_ops = 12 * tba + 3 * tb
    return fwd_bytes, fwd_ops, bwd_bytes, bwd_ops


def phase_fused_loss(device):
    import torch

    from torched_impala_tpu_torch.ops import fused_loss, fused_loss_cuda, losses, profiling
    from torched_impala_tpu_torch.ops.vtrace import threshold

    # The forward against its plain version: the five sums rtol 1e-5; vs,
    # adv, lse and the entropy 1e-5 absolute. The backward against its
    # plain version: rtol 1e-5, atol 1e-6 x the largest gradient. Two
    # launches of each bit-identical.
    fwd_err, sums_rel, bwd_err, bwd_rel, per_shape = 0.0, 0.0, 0.0, 0.0, {}
    for T, B, A in FUSED_SHAPES:
        args = fused_args(loss_inputs(T, B, A, seed=T * 100 + B, device=device))
        err = 0.0
        for clips in THRESHOLDS:
            kw = dict(
                clip_rho=threshold(clips.get("clip_rho_threshold", 1.0)),
                clip_c=threshold(clips.get("clip_c_threshold", 1.0)),
                clip_pg_rho=threshold(clips.get("clip_pg_rho_threshold", 1.0)),
            )
            for lambda_ in (1.0, 0.9):
                out = fused_loss_cuda.fused_loss_fwd(*args, **kw, lambda_=lambda_)
                again = fused_loss_cuda.fused_loss_fwd(*args, **kw, lambda_=lambda_)
                ref = fused_loss.fused_core_reference(*args, **kw, lambda_=lambda_)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(out, again)):
                    raise AssertionError(f"fused_loss_fwd: two launches differ at {(T, B, A)}")
                torch.testing.assert_close(out.sums, ref.sums, rtol=1e-5, atol=1e-6)
                sums_rel = max(sums_rel, float(((out.sums - ref.sums).abs()
                                                / ref.sums.abs().clamp(min=1e-6)).max()))
                for a, b in zip(out[1:], ref[1:]):
                    err = max(err, float((a - b).abs().max()))
        bwd = fused_bwd_args(args, seed=T + A)
        got = fused_loss_cuda.fused_loss_bwd(*bwd)
        again = fused_loss_cuda.fused_loss_bwd(*bwd)
        ref = fused_loss.fused_core_backward_reference(*bwd)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"fused_loss_bwd: two launches differ at {(T, B, A)}")
        for a, b in zip(got, ref):
            scale = float(b.abs().max())
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * scale)
            bwd_err = max(bwd_err, float((a - b).abs().max()))
            bwd_rel = max(bwd_rel, float((a - b).abs().max()) / max(scale, 1e-30))
        per_shape[f"{T}x{B}x{A}"] = err
        fwd_err = max(fwd_err, err)
    if not fwd_err <= 1e-5:
        raise AssertionError(f"fused_loss_fwd vs plain: vs/adv/lse/ent max abs err {per_shape}")

    # The whole loss through the two kernels against the loss through the
    # plain versions, all else identical on the card: logs and gradients.
    loss_err = 0.0
    for T, B, A in FUSED_SHAPES:
        for clips in THRESHOLDS:
            for reduction in ("sum", "mean"):
                cfg = losses.ImpalaLossConfig(fused_epilogue=True, reduction=reduction, **clips)
                x = loss_inputs(T, B, A, seed=T + B, device=device)

                def loss_and_grads():
                    leaves = {k: x[k].clone().requires_grad_() for k in ("target_logits", "values")}
                    out = losses.impala_loss(**{**x, **leaves}, config=cfg)
                    g = torch.autograd.grad(out.total, list(leaves.values()))
                    return out, g

                before = dict(fused_loss_cuda.LAUNCHES)
                out_k, grads_k = loss_and_grads()
                if fused_loss_cuda.LAUNCHES != {k: v + 1 for k, v in before.items()}:
                    raise AssertionError(f"fused loss call: launches {before} -> {fused_loss_cuda.LAUNCHES}")
                real = fused_loss.fused_core, fused_loss.fused_core_backward
                fused_loss.fused_core = fused_loss.fused_core_reference
                fused_loss.fused_core_backward = fused_loss.fused_core_backward_reference
                try:
                    out_p, grads_p = loss_and_grads()
                finally:
                    fused_loss.fused_core, fused_loss.fused_core_backward = real
                for key in out_p.logs:
                    torch.testing.assert_close(out_k.logs[key], out_p.logs[key], rtol=1e-5, atol=1e-6)
                for gk, gp in zip(grads_k, grads_p):
                    torch.testing.assert_close(gk, gp, rtol=1e-5, atol=1e-6)
                    loss_err = max(loss_err, float((gk - gp).abs().max()))

    # Times at the pong_transformer learner's shape: each kernel and its
    # plain version (events), each kernel's device time, and one loss call
    # with its backward, every kernel it launches summed (the function
    # level that the kernels replace).
    T, B, A = FUSED_SHAPES[0]
    x = loss_inputs(T, B, A, seed=7, device=device)
    args = fused_args(x)
    bwd = fused_bwd_args(args, seed=8)
    cfg = losses.ImpalaLossConfig(fused_epilogue=True)

    def loss_call():
        leaves = {k: x[k].clone().requires_grad_() for k in ("target_logits", "values")}
        out = losses.impala_loss(**{**x, **leaves}, config=cfg)
        torch.autograd.grad(out.total, list(leaves.values()))

    fwd_bytes, fwd_ops, bwd_bytes, bwd_ops = fused_work(T, B, A)
    result, line = {}, {}
    for name, fn, plain, n_bytes, ops in (
        ("fwd", lambda: fused_loss_cuda.fused_loss_fwd(*args),
         lambda: fused_loss.fused_core_reference(*args), fwd_bytes, fwd_ops),
        ("bwd", lambda: fused_loss_cuda.fused_loss_bwd(*bwd),
         lambda: fused_loss.fused_core_backward_reference(*bwd), bwd_bytes, bwd_ops),
    ):
        kernel_ms = time_cuda(fn)
        plain_ms = time_cuda(plain)
        device_us, _ = profiling.device_us(fn, name=f"fused_loss_{name}_kernel")
        bound_ms, bound_by = bound(n_bytes, ops, PEAK_F32_OPS_PER_S)
        line.update({
            f"{name}_us": kernel_ms * 1e3, f"{name}_plain_us": plain_ms * 1e3,
            f"{name}_device_us_profiler": device_us, f"{name}_bound_us": bound_ms * 1e3,
            f"{name}_bound_by": bound_by, f"{name}_bytes": n_bytes, f"{name}_ops": ops,
        })
        result[f"fused_loss_{name}"] = dict(
            max_abs_err=fwd_err if name == "fwd" else bwd_err, ms=kernel_ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        )
    call_us, call_kernels = profiling.device_us(loss_call)
    emit(
        {
            "phase": "fused_loss",
            "fwd_max_abs_err": fwd_err,
            "fwd_max_abs_err_by_shape": per_shape,
            "sums_max_rel_err": sums_rel,
            "bwd_max_abs_err": bwd_err,
            "bwd_max_err_over_largest": bwd_rel,
            "loss_grad_max_abs_diff": loss_err,
            "pong_transformer_shape": [T, B, A],
            **line,
            "loss_call_fwd_bwd_us": time_cuda(loss_call, iters=50, warmup=5) * 1e3,
            "loss_call_fwd_bwd_device_us": call_us,
            "loss_call_fwd_bwd_kernels": call_kernels,
            "library_call": None,
        }
    )
    return result


def attention_inputs(B, T, H, dh, W, seed, device, dtype="float32"):
    """q, k, v, dOut and the segments of one attention call: episodes that
    reset mid-unroll and a cache whose slots are of this episode, of an
    older one, or empty (-1)."""
    import torch

    rng = np.random.default_rng(seed)
    S = W + T
    base = rng.integers(1, 4, size=(B, 1))
    seg_q = base + np.cumsum(rng.uniform(size=(B, T)) < 4.0 / max(T, 4), axis=1)
    cache = np.where(
        rng.uniform(size=(B, W)) < 0.6, base, rng.choice([-1, 0], size=(B, W))
    )
    dt = getattr(torch, dtype)

    def f(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device, dt)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return dict(
        q=f((B, T, H, dh)), k=f((B, S, H, dh)), v=f((B, S, H, dh)), g=f((B, T, H, dh)),
        seg_q=i32(seg_q), seg_ctx=i32(np.concatenate([cache, seg_q], axis=1)), W=W,
    )


def attention_work(x, itemsize):
    """(bytes, operations) each kernel must move and do on these inputs:
    every input read once and every output written once; each product
    (q.k, dO.v, P v, dS k, dS q, P dO) counts 2 dh operations for each
    visible (query, slot) pair of this data, the pairs the kernels do not
    skip. "bwd" is `_bwd_pallas`'s work, whatever implements it: q, dO and
    the f32 O (for D), k, v, lse and the segments in; dq, dk, dv out; five
    products."""
    from torched_impala_tpu_torch.ops import attention

    B, T, H, dh = x["q"].shape
    S = x["k"].shape[1]
    visible = int(attention._visibility(x["seg_q"], x["seg_ctx"], T, S, x["W"]).sum())
    q = B * T * H * dh * itemsize
    kv = B * S * H * dh * itemsize
    q32, kv32 = B * T * H * dh * 4, B * S * H * dh * 4
    segs = B * (T + S) * 4
    rows = B * H * T * 4  # lse
    pair = 2 * H * dh * visible
    return {
        "fwd": (q + 2 * kv + segs + q32 + rows, 2 * pair),
        "bwd": (2 * q + q32 + 2 * kv + segs + rows + q32 + 2 * kv32, 5 * pair),
    }


def sdpa_yardstick(x, device_calls):
    """`F.scaled_dot_product_attention` with the same boolean mask, on
    [B, H, T, dh] copies of the inputs (never on the port's path): the
    event ms and device µs of its forward alone and of its backward alone
    (the gradient of a saved graph, `retain_graph=True`), and the kernels
    each runs."""
    import torch
    import torch.nn.functional as F

    from torched_impala_tpu_torch.ops import attention, profiling

    T, S = x["q"].shape[1], x["k"].shape[1]
    mask = attention._visibility(x["seg_q"], x["seg_ctx"], T, S, x["W"])[:, None]
    qh, kh, vh = (x[k].transpose(1, 2).contiguous().requires_grad_() for k in ("q", "k", "v"))
    gh = x["g"].transpose(1, 2).contiguous()
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

    def bwd():
        torch.autograd.grad(out, (qh, kh, vh), gh, retain_graph=True)

    result = {}
    for name, fn in (("fwd", fwd), ("bwd", bwd)):
        result[f"sdpa_{name}_ms"] = time_cuda(fn, iters=device_calls, warmup=5)
        kernels = profiling.kernels_by_name(fn, calls=device_calls)
        result[f"sdpa_{name}_device_us"] = sum(us for _, us in kernels.values())
        result[f"sdpa_{name}_kernels"] = sorted(kernels)
    return result


def phase_attention(device):
    import torch

    from torched_impala_tpu_torch.models.transformer import einsum_attention
    from torched_impala_tpu_torch.ops import _build, attention, attention_cuda, profiling

    # Both kernels run on the tensor cores: each of the ten instantiations
    # (two dtypes x five padded widths) of each holds mma.sync (HMMA)
    # instructions.
    hmma = {}
    for name in ("attention_fwd", "attention_bwd"):
        hmma[name] = {
            fn: n for fn, n in _build.sass_counts(name, "HMMA").items() if f"{name}_kernel" in fn
        }
        if len(hmma[name]) != 10 or min(hmma[name].values()) == 0:
            raise AssertionError(f"{name}: HMMA counts {hmma[name]}")

    def kernel_vs_plain(x, bf16=False):
        """Max abs errors of the forward and the backward against their
        plain versions on the same inputs; raises past the gates."""
        args = (x["q"], x["k"], x["v"], x["seg_q"], x["seg_ctx"], x["W"])
        out, lse = attention_cuda.attention_forward_cuda(*args)
        ref_out, ref_lse = attention.windowed_attention_reference(*args)
        # The backward reads the plain forward's output and lse, so it is
        # held to its plain version on identical inputs.
        bwd = (x["q"], x["k"], x["v"], x["g"], ref_out, ref_lse, x["seg_q"], x["seg_ctx"], x["W"])
        grads = attention_cuda.attention_backward_cuda(*bwd)
        refs = attention.windowed_attention_backward_reference(*bwd)
        torch.cuda.synchronize()
        for a in (out, lse, *grads):
            if not torch.isfinite(a).all():
                raise AssertionError("attention kernel: non-finite output")
        if bf16:
            fwd_tol = dict(rtol=BF16_ULP, atol=BF16_ULP)
        else:
            fwd_tol = dict(rtol=0.0, atol=ATTN_F32_ATOL)
        torch.testing.assert_close(out, ref_out, **fwd_tol)
        torch.testing.assert_close(lse, ref_lse, **fwd_tol)
        errs = {"fwd": max(float((out - ref_out).abs().max()), float((lse - ref_lse).abs().max()))}
        # atol scales with the largest gradient of the three: at T = 1,
        # W = 0 dq is 0 in exact arithmetic and only rounding is left.
        scale = max(float(a.abs().max()) for a in refs)
        for name, got, want in zip(("dq", "dk", "dv"), grads, refs):
            tol = dict(rtol=BF16_ULP, atol=BF16_ULP * scale) if bf16 else dict(rtol=1e-4, atol=1e-5 * scale)
            torch.testing.assert_close(got, want, **tol)
            errs[name] = float((got - want).abs().max())
        return errs

    errors = {}
    for shape in (ATTN_LEARNER, ATTN_LONG, *ATTN_RAGGED, *ATTN_WIDTHS):
        label = "x".join(map(str, shape))
        errors[label] = kernel_vs_plain(attention_inputs(*shape, seed=sum(shape), device=device))
        errors["bf16_" + label] = kernel_vs_plain(
            attention_inputs(*shape, seed=sum(shape), device=device, dtype="bfloat16"), bf16=True
        )
    # Head widths past 256: the general kernels, one launch each way a
    # call and none of the tiled kernels', at the same gates.
    wide_errors = {}
    before = (dict(attention_cuda.LAUNCHES), dict(attention_cuda.WIDE_LAUNCHES))
    for shape in ATTN_WIDE:
        label = "x".join(map(str, shape))
        wide_errors[label] = kernel_vs_plain(attention_inputs(*shape, seed=sum(shape), device=device))
        wide_errors["bf16_" + label] = kernel_vs_plain(
            attention_inputs(*shape, seed=sum(shape), device=device, dtype="bfloat16"), bf16=True
        )
    wide_launched = {k: v - before[1][k] for k, v in attention_cuda.WIDE_LAUNCHES.items()}
    if attention_cuda.LAUNCHES != before[0] or wide_launched != {"fwd": 6, "bwd": 6}:
        raise AssertionError(f"attention wide: launches {attention_cuda.LAUNCHES}, {wide_launched}")

    # Through the autograd.Function: bf16 in, bf16 out and bf16 grads.
    x = attention_inputs(*ATTN_LEARNER, seed=2, device=device, dtype="bfloat16")
    leaves = [x[k].clone().requires_grad_() for k in ("q", "k", "v")]
    out = attention.windowed_attention(*leaves, x["seg_q"], x["seg_ctx"], x["W"])
    grads = torch.autograd.grad((out.float() * x["g"].float()).sum(), leaves)
    if out.dtype != torch.bfloat16 or any(g.dtype != torch.bfloat16 for g in grads):
        raise AssertionError("attention: bf16 inputs must give bf16 output and grads")

    def per_kernel_max(keys):
        """The f32 cases' largest error (the main path runs f32)."""
        return max(e[k] for shape, e in errors.items() if not shape.startswith("bf16") for k in keys)

    times, checked = {}, {}
    for label, shape in (("learner", ATTN_LEARNER), ("long", ATTN_LONG)):
        B, T, H, dh, W = shape
        x = attention_inputs(*shape, seed=3, device=device)
        args = (x["q"], x["k"], x["v"], x["seg_q"], x["seg_ctx"], x["W"])
        out, lse = attention.windowed_attention_reference(*args)
        bwd = (x["q"], x["k"], x["v"], x["g"], out, lse, x["seg_q"], x["seg_ctx"], x["W"])
        # Deterministic: a second launch on the same inputs is bit-identical.
        for name, fn, fn_args in (
            ("attention_fwd", attention_cuda.attention_forward_cuda, args),
            ("attention_bwd", attention_cuda.attention_backward_cuda, bwd),
        ):
            first, again = (fn(*fn_args) for _ in range(2))
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                raise AssertionError(f"{name}: two launches differ at {shape}")
        iters = 50 if label == "learner" else 10
        t = dict(
            fwd=time_cuda(lambda: attention_cuda.attention_forward_cuda(*args), iters=iters, warmup=5),
            fwd_plain=time_cuda(lambda: attention.windowed_attention_reference(*args), iters=iters, warmup=5),
            bwd=time_cuda(lambda: attention_cuda.attention_backward_cuda(*bwd), iters=iters, warmup=5),
            bwd_plain=time_cuda(
                lambda: attention.windowed_attention_backward_reference(*bwd), iters=iters, warmup=5
            ),
            fwd_tiles=attention_cuda.fwd_tiles(T, W + T, dh),
            bwd_tiles=attention_cuda.bwd_tiles(W + T, dh),
        )
        # The yardstick (never on the path): SDPA with the same boolean mask.
        t.update(sdpa_yardstick(x, device_calls=iters))
        # fwd + bwd of the kernel path against the einsum branch: the
        # measurement behind configs.KERNEL_MIN_SCORE_ELEMS.
        leaves = [x[k].clone().requires_grad_() for k in ("q", "k", "v")]
        emask = attention._visibility(x["seg_q"], x["seg_ctx"], T, W + T, W)

        def kernel_fwd_bwd():
            o = attention.windowed_attention(*leaves, x["seg_q"], x["seg_ctx"], x["W"])
            torch.autograd.grad(o, leaves, x["g"])

        def einsum_fwd_bwd():
            o = einsum_attention(*leaves, emask)
            torch.autograd.grad(o, leaves, x["g"])

        t["kernel_fwd_bwd"] = time_cuda(kernel_fwd_bwd, iters=iters, warmup=5)
        t["einsum_fwd_bwd"] = time_cuda(einsum_fwd_bwd, iters=iters, warmup=5)
        # Device time of each call, every kernel inside it summed (the
        # backward's second kernel too, where it runs).
        for name, fn, kname in (
            ("fwd", lambda: attention_cuda.attention_forward_cuda(*args), "attention_fwd"),
            ("bwd", lambda: attention_cuda.attention_backward_cuda(*bwd), "attention_bwd"),
        ):
            t[f"{name}_device_us_profiler"], t[f"{name}_kernels_a_call"] = profiling.device_us(
                fn, calls=10, name=kname
            )
        work = attention_work(x, itemsize=4)
        for name in ("fwd", "bwd"):
            t[f"{name}_bound_ms"], t[f"{name}_bound_by"] = bound(*work[name], PEAK_TF32_SPLIT_OPS_PER_S)
        t["score_elems"] = T * (W + T)
        times[label] = t
        if label == "learner":
            checked = {
                name: dict(
                    max_abs_err=per_kernel_max(keys), ms=t[name], plain_ms=t[f"{name}_plain"],
                    bound_ms=t[f"{name}_bound_ms"], bound_by=t[f"{name}_bound_by"],
                    library_ms=t[f"sdpa_{name}_ms"],
                )
                for name, keys in (("fwd", ("fwd",)), ("bwd", ("dq", "dk", "dv")))
            }
    # The general kernels, timed at one wide shape (f32, CUDA cores).
    x = attention_inputs(*ATTN_WIDE_TIMED, seed=4, device=device)
    args = (x["q"], x["k"], x["v"], x["seg_q"], x["seg_ctx"], x["W"])
    out, lse = attention.windowed_attention_reference(*args)
    bwd = (x["q"], x["k"], x["v"], x["g"], out, lse, x["seg_q"], x["seg_ctx"], x["W"])
    for fn, fn_args in ((attention_cuda.attention_forward_cuda, args),
                        (attention_cuda.attention_backward_cuda, bwd)):
        first, again = fn(*fn_args), fn(*fn_args)
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"attention wide: two launches differ at {ATTN_WIDE_TIMED}")
    work = attention_work(x, itemsize=4)
    yardstick = sdpa_yardstick(x, device_calls=10)
    wide = {}
    for name, fn, plain, fn_args, kname in (
        ("fwd", attention_cuda.attention_forward_cuda, attention.windowed_attention_reference,
         args, "attention_wide_fwd"),
        ("bwd", attention_cuda.attention_backward_cuda,
         attention.windowed_attention_backward_reference, bwd, "attention_wide_d"),
    ):
        bound_ms, bound_by = bound(*work[name], PEAK_F32_OPS_PER_S)
        keys = ("fwd",) if name == "fwd" else ("dq", "dk", "dv")
        wide[f"attention_wide_{name}"] = dict(
            max_abs_err=max(e[k] for label, e in wide_errors.items()
                            if not label.startswith("bf16") for k in keys),
            ms=time_cuda(lambda: fn(*fn_args), iters=10, warmup=3),
            plain_ms=time_cuda(lambda: plain(*fn_args), iters=10, warmup=3),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=yardstick[f"sdpa_{name}_ms"],
        )
        wide[f"attention_wide_{name}"]["device_us_profiler"], _ = profiling.device_us(
            lambda: fn(*fn_args), calls=10, name=kname
        )
    emit({"phase": "attention", "hmma": hmma, "max_abs_err_by_shape": errors, "times_ms": times,
          "wide_max_abs_err_by_shape": wide_errors, "wide_timed": dict(wide, shape=list(ATTN_WIDE_TIMED)),
          "wide_sdpa": yardstick})
    for entry in wide.values():
        entry.pop("device_us_profiler")
    return {**{f"attention_{k}": v for k, v in checked.items()}, **wide}


def phase_model(device):
    import torch

    from torched_impala_tpu_torch.models.nets import ImpalaNet
    from torched_impala_tpu_torch.models.torsos import AtariDeepTorso, AtariShallowTorso

    rng = np.random.default_rng(3)
    obs = torch.from_numpy(rng.integers(0, 256, size=(3, 4, 84, 84, 4), dtype=np.uint8))
    first = torch.zeros(3, 4, dtype=torch.bool)
    first[1, 2] = first[2, 0] = True
    state0 = tuple(torch.from_numpy(rng.normal(size=(4, 256)).astype(np.float32)) for _ in range(2))
    result = {"phase": "model"}
    tols = {"float32": dict(rtol=1e-4, atol=1e-5), "bfloat16": dict(rtol=0.0, atol=5e-2)}
    transformer = dict(d_model=256, num_layers=2, num_heads=4, window=128, dense_kernel="kernel")
    nets = [
        ("pong", lambda dt, g: ImpalaNet(6, AtariShallowTorso(4, dtype=dt, generator=g), generator=g), ()),
        *(
            (
                f"breakout_{'fused' if fused else 'unfused'}",
                lambda dt, g, fused=fused: ImpalaNet(
                    4, AtariDeepTorso(dtype=dt, fused_blocks=fused, generator=g),
                    core="lstm", generator=g,
                ),
                state0,
            )
            for fused in (False, True)
        ),
        # A warm cache: the state after one unroll from a fresh one (None
        # below), then an unroll with a reset in the middle.
        (
            "pong_transformer",
            lambda dt, g: ImpalaNet(
                6, AtariShallowTorso(4, dtype=dt, generator=g), core="transformer",
                generator=g, transformer=transformer,
            ),
            None,
        ),
    ]
    for name, build, state in nets:
        for dtype, tol in tols.items():
            net = build(dtype, torch.Generator().manual_seed(0))
            with torch.no_grad():
                start = state
                if start is None:
                    _, start = net(obs.flip(0), torch.ones_like(first), net.initial_state(4), unroll=True)
                cpu_out, cpu_state = net(obs, first, start, unroll=True)
                net.to(device)
                dev_state_in = tuple(s.to(device) for s in start)
                dev_out, dev_state = net(obs.to(device), first.to(device), dev_state_in, unroll=True)
            logits = dev_out.policy_logits.cpu()
            if not torch.isfinite(logits).all() or logits.shape != cpu_out.policy_logits.shape:
                raise AssertionError(f"model {name} {dtype}: bad logits {logits.shape}")
            torch.testing.assert_close(logits, cpu_out.policy_logits, **tol)
            torch.testing.assert_close(dev_out.values.cpu(), cpu_out.values, **tol)
            for a, b in zip(dev_state, cpu_state):
                torch.testing.assert_close(a.cpu(), b, **tol)
            result[f"{name}_{dtype}"] = float((logits - cpu_out.policy_logits).abs().max())
    emit(result)


def fixed_batch(cfg, device, state, seed=5):
    """A full-size device batch for timing the train step alone."""
    import torch

    rng = np.random.default_rng(seed)
    T, B, A = cfg.unroll_length, cfg.batch_size, cfg.num_actions
    return (
        torch.from_numpy(rng.integers(0, 256, size=(T + 1, B, *cfg.obs_shape), dtype=np.uint8)).to(device),
        torch.zeros(T + 1, B, dtype=torch.bool, device=device),
        torch.from_numpy(rng.integers(0, A, size=(T, B))).to(device),
        torch.from_numpy(rng.normal(size=(T, B, A)).astype(np.float32)).to(device),
        torch.from_numpy((rng.uniform(size=(T, B)) < 0.05).astype(np.float32)).to(device),
        torch.ones(T, B, device=device),
        state,
    )


def train_args(cfg, device, learner_fields=None):
    """`loop.train`'s arguments for preset `cfg` on fake envs;
    `learner_fields` replace fields of its LearnerConfig."""
    from torched_impala_tpu_torch import configs

    learner_config = dataclasses.replace(configs.make_learner_config(cfg), **(learner_fields or {}))
    return dict(
        env_factory=configs.make_env_factory(cfg, fake=True),
        num_actors=cfg.num_actors,
        envs_per_actor=cfg.envs_per_actor,
        actor_mode=cfg.actor_mode,
        pool_mode=cfg.pool_mode,
        pool_ready_fraction=cfg.pool_ready_fraction,
        learner_config=learner_config,
        optimizer=configs.make_optimizer(cfg),
        device=device,
    )


# Each `drive` run's phase line, by name, for later phases to read.
PHASE_LINES = {}


def drive(name, cfg, steps, device, standalone=True, at_step5=None, after=None,
          learner_fields=None, profiled=True, during=()):
    """`loop.train` with `cfg` for `steps` learner steps on the card, every
    kernel's launch count set to 0 just before and read just after; then,
    with `standalone`, the train step alone on a fixed batch, one actor
    alone and one fake env step; and, with `profiled`, a profiled short
    run for the device's idle share. `at_step5()` runs in the logger at
    the first logged learner step from the 5th on (the 5th at one step a
    dispatch, the 8th at K = 4); its dict goes, as `seen`, to
    `after(result, seen)`, which runs after the run and returns a dict
    merged into the phase line. `learner_fields` replace fields of the LearnerConfig. The
    context managers in `during` are entered around the main run alone. Raises if
    the run did not train on the card."""
    import torch

    from torched_impala_tpu_torch import configs
    from torched_impala_tpu_torch.ops import profiling
    from torched_impala_tpu_torch.runtime import loop
    from torched_impala_tpu_torch.runtime.vector_actor import VectorActor

    agent = configs.make_agent(cfg, seed=0)
    before = {k: v.detach().clone() for k, v in agent.net.state_dict().items()}
    log_times = []
    seen = {}

    def logger(logs):
        log_times.append((logs["num_steps"], time.monotonic(), logs["total_loss"]))
        if at_step5 is not None and logs["num_steps"] >= 5 and not seen:
            seen.update(at_step5())

    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.monotonic()
    with contextlib.ExitStack() as stack:
        for manager in during:
            stack.enter_context(manager)
        result = loop.train(
            agent=agent, total_steps=steps, logger=logger, log_every=1,
            **train_args(cfg, device, learner_fields),
        )
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = read_launches()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    extra = {"os_cpu_count": os.cpu_count()}
    if after is not None:
        extra.update(after(result, seen))

    learner = result.learner
    final_loss = float(result.final_logs["total_loss"])
    if learner.num_steps != steps or not math.isfinite(final_loss):
        raise AssertionError(f"{name}: steps {learner.num_steps}, loss {final_loss}")
    if not all(p.device == device for p in learner.params.values()):
        raise AssertionError(f"{name}: a param is not on {device}")
    if learner.last_batch_device != device:
        raise AssertionError(f"{name}: batch on {learner.last_batch_device}")
    if agent.net.torso.dtype != torch.bfloat16:
        raise AssertionError(f"{name}: torso is not bf16")
    moved = sum(
        not torch.equal(before[k], v.detach().cpu())
        for k, v in agent.net.state_dict().items()
    )
    if moved != len(before):
        raise AssertionError(f"{name}: only {moved}/{len(before)} params moved")

    # Steady window: from the first logged learner step from the 5th on
    # (the 5th at one step a dispatch) to the last.
    first = next(i for i, (n, _, _) in enumerate(log_times) if n >= 5)
    (s0, t_0, _), (s1, t_1, _) = log_times[first], log_times[-1]
    steps_per_s = (s1 - s0) / (t_1 - t_0)
    T, B = cfg.unroll_length, cfg.batch_size
    factory = configs.make_env_factory(cfg, fake=True)
    if standalone:
        batch = fixed_batch(cfg, device, agent.net.initial_state(B))
        step_ms = time_cuda(lambda: learner.train_step(batch), iters=20, warmup=3)
        step_device_us, step_kernels = profiling.device_us(
            lambda: learner.train_step(batch), calls=10
        )
        actor = VectorActor(
            actor_id=0,
            envs=[factory(j, j) for j in range(cfg.envs_per_actor)],
            agent=agent,
            param_store=learner.param_store,
            enqueue=[].append,
            unroll_length=T,
            device=device,
        )
        actor.unroll_and_push()
        t0 = time.perf_counter()
        for _ in range(3):
            actor.unroll_and_push()
        actor_unroll_ms = (time.perf_counter() - t0) / 3 * 1e3
        env = factory(0, 0)
        env.reset()
        t0 = time.perf_counter()
        for _ in range(640):
            env.step(0)
        env_step_us = (time.perf_counter() - t0) / 640 * 1e6
        extra.update(
            train_step_alone_ms=step_ms,
            train_step_device_busy_ms=None if step_device_us is None else step_device_us / 1e3,
            train_step_kernels=step_kernels,
            actor_unroll_alone_ms=actor_unroll_ms,
            actor_alone_frames_per_s=T * cfg.envs_per_actor / actor_unroll_ms * 1e3,
            fake_env_step_us=env_step_us,
        )

    # Device idle share of a short profiled run of the same loop (start-up
    # included): kernel time summed over all threads against wall time.
    def short_run():
        loop.train(
            agent=configs.make_agent(cfg, seed=1),
            total_steps=PROFILED_STEPS,
            **train_args(cfg, device, learner_fields),
        )

    busy_us = profiled_wall_us = None
    if profiled:
        t0 = time.perf_counter()
        busy_us, _ = profiling.device_us(short_run, calls=1)
        profiled_wall_us = (time.perf_counter() - t0) * 1e6
    K = learner._config.steps_per_dispatch
    line = {
        "phase": name,
        "actors": f"{cfg.actor_mode} {cfg.num_actors} x {cfg.envs_per_actor}",
        "traj_ring": cfg.traj_ring,
        "steps_per_dispatch": K,
        "donate_batch": learner._config.donate_batch,
        "learner_steps": learner.num_steps,
        "launches": launches,
        "launches_per_learner_step": {k: v / steps for k, v in launches.items()},
        "launches_per_dispatch": {k: v * K / steps for k, v in launches.items()},
        "final_loss": final_loss,
        "train_wall_s": wall,
        "learner_steps_per_s": steps_per_s,
        "env_frames_per_s": steps_per_s * T * B,
        "profiled_run_wall_s": None if profiled_wall_us is None else profiled_wall_us / 1e6,
        "profiled_run_device_idle_share": (
            None if busy_us is None else 1.0 - busy_us / profiled_wall_us
        ),
        "max_memory_allocated_mb": peak_mb,
        "param_lag_frames_final": result.final_logs["param_lag_frames"],
        **extra,
    }
    PHASE_LINES[name] = line
    emit(line)
    return launches


def _wrappers():
    from torched_impala_tpu_torch.ops import (
        attention_cuda, conv_block_cuda, fused_loss_cuda, lstm_cuda, vtrace_cuda,
    )

    return [
        ("vtrace", vtrace_cuda, "LAUNCHES"), ("lstm_cell", lstm_cuda, "LAUNCHES"),
        ("resblock", conv_block_cuda, "LAUNCHES"),
        ("resblock_general", conv_block_cuda, "GENERAL_LAUNCHES"),
        ("fused_loss", fused_loss_cuda, "LAUNCHES"), ("attention", attention_cuda, "LAUNCHES"),
        ("attention_wide", attention_cuda, "WIDE_LAUNCHES"),
    ]


def read_launches() -> dict:
    """Every kernel wrapper's launch count, by kernel name (a counter of two
    kernels counts each: attention_fwd, fused_loss_bwd, ...)."""
    counts = {}
    for name, module, attr in _wrappers():
        count = getattr(module, attr)
        if isinstance(count, dict):
            counts.update({f"{name}_{k}": v for k, v in count.items()})
        else:
            counts[name] = count
    return counts


def zero_launches() -> None:
    for _, module, attr in _wrappers():
        count = getattr(module, attr)
        if isinstance(count, dict):
            for key in count:
                count[key] = 0
        else:
            setattr(module, attr, 0)


def descendants(root: int) -> list:
    """Pids of every live process below `root`, from /proc."""
    children = collections.defaultdict(list)
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        children[ppid].append(int(entry))
    found, todo = [], [root]
    while todo:
        for child in children.get(todo.pop(), []):
            found.append(child)
            todo.append(child)
    return found


def has_cuda_context(pid: int) -> bool:
    """Whether process `pid` holds the card's device files (/dev/nvidia*)
    open or mapped, as a process that has initialised CUDA does. `import
    torch` alone loads CUDA's libraries (the driver library among them)
    but opens no device file."""
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return False
    for fd in fds:
        try:
            if os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia"):
                return True
        except OSError:
            continue
    try:
        with open(f"/proc/{pid}/maps") as f:
            return "/dev/nvidia" in f.read()
    except OSError:
        return False


def processes_mid_run() -> dict:
    """At the 5th learner step of a process-actor run: this process's
    descendants (the forkserver and the env workers), which of them hold
    a CUDA context, and the pids `nvidia-smi` lists as compute apps."""
    kids = descendants(os.getpid())
    smi = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return {
        "descendants": kids,
        "descendants_with_cuda_context": [p for p in kids if has_cuda_context(p)],
        "parent_has_cuda_context": has_cuda_context(os.getpid()),
        "nvidia_smi_compute_pids": sorted(int(x) for x in smi.split() if x.strip().isdigit()),
    }


def check_workers(name, result, seen, count=32) -> dict:
    """The process run's `count` workers: alive and CUDA-free at the 5th
    step (not in nvidia-smi's compute apps, no CUDA context, where this
    process has one), all exited after the pools closed, and no
    shared-memory segment of theirs left in /dev/shm."""
    workers = set(result.pool_pids)
    if len(workers) != count or not workers <= set(seen["descendants"]):
        raise AssertionError(f"{name}: workers {sorted(workers)} not all seen mid-run: {seen}")
    if not seen["parent_has_cuda_context"]:
        raise AssertionError(f"{name}: this process's CUDA context is not visible in /proc")
    for key in ("descendants_with_cuda_context", "nvidia_smi_compute_pids"):
        if workers & set(seen[key]):
            raise AssertionError(f"{name}: env workers {sorted(workers & set(seen[key]))} in {key}")
    alive = [p for p in workers if os.path.exists(f"/proc/{p}")]
    shm_left = [n for n in result.pool_shm_names if os.path.exists(f"/dev/shm/{n.lstrip('/')}")]
    if alive or shm_left:
        raise AssertionError(f"{name}: after close, workers alive {alive}, shm left {shm_left}")
    return {
        "workers": len(workers),
        "pools": len(result.pool_shm_names),
        "mid_run": {k: v for k, v in seen.items() if k != "descendants"},
        "workers_exited_after_close": True,
        "shm_segments_left": 0,
    }


def pool_alone(learner, cfg, device) -> dict:
    """One pool of half the preset's workers, without the learner: its
    lockstep step alone (zero actions; 100 steps after 5), and one
    VectorActor driving it (3 unrolls after 1), as the loop's actor
    threads do."""
    from torched_impala_tpu_torch import configs
    from torched_impala_tpu_torch.runtime.env_pool import ProcessEnvPool
    from torched_impala_tpu_torch.runtime.vector_actor import VectorActor

    pool = ProcessEnvPool(
        env_factory=configs.make_env_factory(cfg, fake=True),
        num_workers=cfg.num_actors // 2, envs_per_worker=cfg.envs_per_actor,
        obs_shape=cfg.obs_shape, obs_dtype=np.dtype(cfg.obs_dtype),
    )
    try:
        pool.reset_all()
        actions = np.zeros(pool.num_envs, np.int32)
        for _ in range(5):
            pool.step_all(actions)
        t0 = time.perf_counter()
        for _ in range(100):
            pool.step_all(actions)
        step_ms = (time.perf_counter() - t0) / 100 * 1e3
        actor = VectorActor(
            actor_id=0, envs=pool, agent=configs.make_agent(cfg), param_store=learner.param_store,
            enqueue=[].append, unroll_length=cfg.unroll_length, device=device,
        )
        actor.unroll_and_push()
        t0 = time.perf_counter()
        for _ in range(3):
            actor.unroll_and_push()
        unroll_ms = (time.perf_counter() - t0) / 3 * 1e3
    finally:
        pool.close()
    return {
        "pool_alone_workers": pool.num_workers,
        "pool_step_alone_ms": step_ms,
        "pool_actor_unroll_alone_ms": unroll_ms,
        "pool_actor_alone_frames_per_s": cfg.unroll_length * pool.num_envs / unroll_ms * 1e3,
    }


class RingProbe:
    """While installed, pairs the first RING_PROBE_BATCHES ring batches'
    device copies with a host copy of their slot taken just before the
    batcher releases it; `check` holds each pair equal. A slot released
    before its copy completed, and refilled, would differ."""

    def __init__(self):
        self.open, self.pairs = {}, []

    def __enter__(self):
        from torched_impala_tpu_torch.runtime import learner, traj_ring

        probe = self
        self._saved = (learner.Learner._ring_to_device,
                       traj_ring.TrajectoryRing.release_after_transfer)
        to_device, release = self._saved

        def ring_to_device(learner_self, tensors):
            arrays = to_device(learner_self, tensors)
            if len(probe.pairs) + len(probe.open) < RING_PROBE_BATCHES:
                probe.open[tensors[0].data_ptr()] = arrays
            return arrays

        def release_after_transfer(ring_self, slot, event):
            if event is not None:
                event.synchronize()
            tensors = ring_self._slots[slot].tensors
            arrays = probe.open.pop(tensors.obs.data_ptr(), None)
            if arrays is not None:
                host = [t.clone() for t in tensors[:6]]
                probe.pairs.append((arrays, host))
            release(ring_self, slot, event)

        learner.Learner._ring_to_device = ring_to_device
        traj_ring.TrajectoryRing.release_after_transfer = release_after_transfer
        return self

    def __exit__(self, *exc):
        from torched_impala_tpu_torch.runtime import learner, traj_ring

        learner.Learner._ring_to_device, traj_ring.TrajectoryRing.release_after_transfer = self._saved

    def check(self) -> int:
        import torch

        if len(self.pairs) < RING_PROBE_BATCHES:
            raise AssertionError(f"ring probe: {len(self.pairs)} batches paired")
        for device_arrays, host in self.pairs:
            for d, h in zip(device_arrays[:6], host):
                if not torch.equal(d.cpu(), h.to(d.dtype)):
                    raise AssertionError("ring: a device batch differs from its slot")
        return len(self.pairs)


def feed_times(learner, cfg, device) -> dict:
    """The ring's feed against the queue feed, on one Pong batch: the
    queue feed's np.stack of B unrolls plus its pageable host-to-device
    copies, against the ring's copies of one pinned slot on a side stream
    (host clock, each to a synchronize; median of 20 after 3)."""
    import torch

    from torched_impala_tpu_torch.runtime.learner import stack_trajectories
    from torched_impala_tpu_torch.runtime.types import Trajectory

    rng = np.random.default_rng(9)
    T, B, A = cfg.unroll_length, cfg.batch_size, cfg.num_actions
    trajs = [
        Trajectory(
            obs=rng.integers(0, 256, size=(T + 1, 84, 84, 4), dtype=np.uint8),
            first=np.zeros((T + 1,), np.bool_), actions=np.zeros((T,), np.int32),
            behaviour_logits=np.zeros((T, A), np.float32), rewards=np.zeros((T,), np.float32),
            cont=np.ones((T,), np.float32), agent_state=(),
        )
        for _ in range(B)
    ]
    slot = learner.traj_ring._slots[0].tensors
    stacked = stack_trajectories(trajs)
    for dst, src in zip(slot[:6], stacked[:6]):
        dst.copy_(torch.from_numpy(src))
    stream = torch.cuda.Stream(device)

    def queue_feed():
        learner._to_device(stack_trajectories(trajs))
        torch.cuda.synchronize()

    def ring_feed():
        with torch.cuda.stream(stream):
            learner._ring_to_device((*slot[:6], slot.agent_state))
            event = torch.cuda.Event()
            event.record(stream)
        event.synchronize()

    result = {}
    for key, fn in (("queue_feed_ms", queue_feed), ("ring_feed_ms", ring_feed)):
        for _ in range(3):
            fn()
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        result[key] = statistics.median(times)
    result["batch_bytes"] = sum(x.nbytes for x in stacked[:6])
    return result


def phase_pong(device):
    """The PONG preset as configured (32 worker processes in two pools,
    lockstep, the queue feed), then with the trajectory ring, then 4
    thread actors x 8 envs; returns the preset run's launches."""
    from torched_impala_tpu_torch import configs

    cfg = configs.PONG
    assert (cfg.actor_mode, cfg.num_actors, cfg.envs_per_actor, cfg.pool_mode) == (
        "process", 32, 1, "lockstep"
    )
    assert (cfg.unroll_length, cfg.batch_size, cfg.traj_ring) == (20, 32, False)

    def ring_after(result, seen):
        ring = result.learner.traj_ring
        pinned = all(t.is_pinned() for s in ring._slots for t in s.tensors[:6])
        if not pinned:
            raise AssertionError("pong_ring: ring slots are not pinned host memory")
        return dict(
            check_workers("pong_ring", result, seen),
            ring_slots=ring.num_slots,
            ring_slots_pinned=pinned,
            ring_batches_equal_to_their_slots=probe.check(),
            **feed_times(result.learner, cfg, device),
        )

    runs = {}
    runs["pong"] = drive(
        "pong", cfg, PONG_STEPS, device, standalone=False, at_step5=processes_mid_run,
        after=lambda r, seen: dict(check_workers("pong", r, seen), **pool_alone(r.learner, cfg, device)),
    )
    with RingProbe() as probe:
        runs["pong_ring"] = drive(
            "pong_ring", dataclasses.replace(cfg, traj_ring=True), PONG_STEPS, device,
            standalone=False, at_step5=processes_mid_run, after=ring_after,
        )
    thread_cfg = dataclasses.replace(cfg, actor_mode="thread", num_actors=4, envs_per_actor=8)
    runs["pong_thread"] = drive("pong_thread", thread_cfg, PONG_THREAD_STEPS, device)
    for name, launches in runs.items():
        steps = PONG_THREAD_STEPS if name == "pong_thread" else PONG_STEPS
        if launches["vtrace"] < steps:
            raise AssertionError(f"{name}: {launches['vtrace']} vtrace launches < {steps} steps")
    return runs["pong"]


class CaptureInputs:
    """While installed, `module.<name>` is wrapped: for each key that
    `key(args, kwargs)` returns for a call (None: not kept), a clone of the
    first such call's arguments is kept in `captured`, and `calls` counts
    the calls by key. The calls go through unchanged, so the wrapper's
    launch count still counts them."""

    def __init__(self, module, name, key):
        self.module, self.name, self.key, self.captured, self.calls = module, name, key, {}, {}

    def __enter__(self):
        import torch

        original = self._saved = getattr(self.module, self.name)
        probe = self

        def clone(x):
            return x.detach().clone() if isinstance(x, torch.Tensor) else x

        def wrapper(*args, **kwargs):
            key = probe.key(args, kwargs)
            if key is not None:
                probe.calls[key] = probe.calls.get(key, 0) + 1
            if key is not None and key not in probe.captured:
                probe.captured[key] = ([clone(a) for a in args],
                                       {k: clone(v) for k, v in kwargs.items()})
            return original(*args, **kwargs)

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._saved)


class DonationProbe:
    """While installed, reads at every ring slot release whether the event
    the learner recorded after the step that consumed the slot (handed
    back with it under donate_batch) has completed. `check` fails on a
    release that found it pending or found none."""

    def __init__(self):
        self.events, self.released = {}, []

    def __enter__(self):
        from torched_impala_tpu_torch.runtime import learner, traj_ring

        probe = self
        hand_back, release = self._saved = (learner.Learner._hand_back,
                                            traj_ring.TrajectoryRing.release)

        def recording_hand_back(learner_self, slot, event):
            probe.events[(id(learner_self.traj_ring), slot)] = event
            hand_back(learner_self, slot, event)

        def recording_release(ring_self, slot):
            event = probe.events.pop((id(ring_self), slot), None)
            probe.released.append(event is not None and event.query())
            release(ring_self, slot)

        learner.Learner._hand_back = recording_hand_back
        traj_ring.TrajectoryRing.release = recording_release
        return self

    def __exit__(self, *exc):
        from torched_impala_tpu_torch.runtime import learner, traj_ring

        learner.Learner._hand_back, traj_ring.TrajectoryRing.release = self._saved

    def check(self) -> int:
        if not self.released or not all(self.released):
            raise AssertionError(f"donation: releases before their step's event: {self.released}")
        return len(self.released)


def fixed_superbatch(cfg, device, K, seed=5):
    """K fixed full-size batches stacked on a leading axis."""
    import torch

    batches = [fixed_batch(cfg, device, (), seed=seed + k) for k in range(K)]
    return (*(torch.stack([b[i] for b in batches]) for i in range(6)), ())


def phase_pong_superbatch(device, smi):
    """The PONG preset as `--superbatch-k 4` configures it (32 worker
    processes, superbatch ring slots, donate_batch, 4 steps a dispatch):
    `loop.train` for 20 dispatches (module docstring, phase 10)."""
    import torch

    from torched_impala_tpu_torch import configs, run
    from torched_impala_tpu_torch.ops import profiling, vtrace_cuda
    from torched_impala_tpu_torch.ops.vtrace import vtrace_reference
    from torched_impala_tpu_torch.runtime.learner import Learner, superbatch_slice
    from torched_impala_tpu_torch.runtime.traj_ring import TrajectoryRing

    K = SUPERBATCH_K
    steps = K * PONG_SUPERBATCH_DISPATCHES
    cfg = run.build_config(run.parse_args(
        ["--config", "pong", "--fake-envs", "--total-steps", str(steps), "--superbatch-k", str(K)]))
    assert (cfg.actor_mode, cfg.num_actors, cfg.traj_ring, cfg.steps_per_dispatch,
            cfg.donate_batch) == ("process", 32, True, K, True)
    T, B = cfg.unroll_length, cfg.batch_size

    def after(result, seen):
        learner = result.learner
        ring = learner.traj_ring
        shapes = {tuple(s.tensors.obs.shape) for s in ring._slots}
        pinned = all(t.is_pinned() for s in ring._slots for t in s.tensors[:6])
        want_slots = learner._config.device_queue_depth + 4
        if shapes != {(K, T + 1, B, 84, 84, 4)} or not pinned or ring.num_slots != want_slots:
            raise AssertionError(f"pong_superbatch: slots {shapes}, pinned {pinned}, "
                                 f"{ring.num_slots} of them, want {want_slots}")
        return dict(
            check_workers("pong_superbatch", result, seen),
            ring_slots=ring.num_slots,
            ring_slot_obs_shape=list(shapes.pop()),
            ring_slots_pinned=pinned,
            ring_slot_bytes=sum(t.nbytes for t in ring._slots[0].tensors[:6]),
        )

    # The pinned slots alone: the same ring as the run's, timed.
    import resource

    t0 = time.perf_counter()
    ring = TrajectoryRing(
        num_slots=configs.make_learner_config(cfg).device_queue_depth + 4, unroll_length=T,
        batch_size=B, example_obs=np.zeros(cfg.obs_shape, np.uint8), num_actions=cfg.num_actions,
        pin_memory=True, superbatch_k=K)
    pinned_alloc_s = time.perf_counter() - t0
    pinned_bytes = sum(t.nbytes for s in ring._slots for t in s.tensors[:6])
    del ring
    vtrace_key = CaptureInputs(vtrace_cuda, "vtrace_cuda", lambda a, kw: tuple(kw["log_rhos"].shape))
    with DonationProbe() as donation, vtrace_key as captured:
        launches = drive("pong_superbatch", cfg, steps, device, standalone=False,
                         at_step5=processes_mid_run, after=after, profiled=False)
    released = donation.check()
    if launches["vtrace"] != steps:
        raise AssertionError(f"pong_superbatch: {launches['vtrace']} vtrace launches, want "
                             f"{K} a dispatch")
    # V-trace held to its plain version on the run's own first learner input.
    args, kwargs = captured.captured[(T, B)]
    out, ref = vtrace_cuda.vtrace_cuda(**kwargs), vtrace_reference(**kwargs)
    vtrace_err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    if not vtrace_err <= 1e-5:
        raise AssertionError(f"pong_superbatch: vtrace vs plain {vtrace_err}")

    # One dispatch against K train_steps on a fixed superbatch, from the
    # same params, with cuDNN's deterministic algorithms: the same bits.
    def learner_():
        return Learner(agent=configs.make_agent(cfg, seed=0), optimizer=configs.make_optimizer(cfg),
                       config=dataclasses.replace(configs.make_learner_config(cfg), traj_ring=False),
                       device=device)

    batch = fixed_superbatch(cfg, device, K)
    dispatched, stepped = learner_(), learner_()
    torch.backends.cudnn.deterministic = True
    try:
        logs_d = dispatched.train_dispatch(batch)
        for k in range(K):
            logs_s = stepped.train_step(superbatch_slice(batch, k))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    differ = [k for k, p in dispatched.params.items() if not torch.equal(p, stepped.params[k])]
    differ += [k for k in logs_d if not torch.equal(logs_d[k], logs_s[k])]
    if differ:
        raise AssertionError(f"pong_superbatch: dispatch and {K} steps differ in {differ}")
    # The dispatch alone, and one step alone, on the fixed superbatch.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dispatch_ms = time_cuda(lambda: dispatched.train_dispatch(batch), iters=10, warmup=2)
    dispatch_peak_mb = torch.cuda.max_memory_allocated() / 2**20
    step_ms = time_cuda(lambda: stepped.train_step(superbatch_slice(batch, 0)), iters=20, warmup=3)
    dispatch_device_us, dispatch_kernels = profiling.device_us(
        lambda: dispatched.train_dispatch(batch), calls=3)
    ring_line = PHASE_LINES["pong_ring"]
    emit({
        "phase": "pong_superbatch_checks",
        "card": smi,
        "vtrace_launches_per_dispatch": launches["vtrace"] / PONG_SUPERBATCH_DISPATCHES,
        "vtrace_max_abs_err_on_the_runs_input": vtrace_err,
        "donated_releases_after_their_step_event": released,
        "dispatch_equals_K_train_steps_bit_for_bit": True,
        "cudnn_deterministic": True,
        "dispatch_alone_ms": dispatch_ms,
        "train_step_alone_ms": step_ms,
        "dispatch_device_busy_ms": None if dispatch_device_us is None else dispatch_device_us / 1e3,
        "kernels_per_dispatch": dispatch_kernels,
        "dispatch_peak_mb": dispatch_peak_mb,
        "pinned_ring_bytes": pinned_bytes,
        "pinned_ring_alloc_s": pinned_alloc_s,
        "rlimit_memlock": list(resource.getrlimit(resource.RLIMIT_MEMLOCK)),
        "env_frames_per_s": {"pong_superbatch_K4": PHASE_LINES["pong_superbatch"]["env_frames_per_s"],
                             "pong_ring_K1_same_call": ring_line["env_frames_per_s"]},
        "param_lag_frames_final": {
            "pong_superbatch_K4": PHASE_LINES["pong_superbatch"]["param_lag_frames_final"],
            "pong_ring_K1_same_call": ring_line["param_lag_frames_final"]},
    })
    return launches


def phase_breakout(device, fused):
    from torched_impala_tpu_torch import configs

    cfg = dataclasses.replace(
        configs.BREAKOUT,
        actor_mode="thread",
        num_actors=4,
        envs_per_actor=8,
        fused_conv=fused,
    )
    assert cfg.num_actors * cfg.envs_per_actor == cfg.batch_size == 32
    name = f"breakout_{'fused' if fused else 'unfused'}"
    launches = drive(name, cfg, BREAKOUT_STEPS, device)
    steps = BREAKOUT_STEPS
    # The learner's unroll calls the cell T+1 = 21 times a step (the
    # actors add one call per acting step); each torso forward runs the
    # six residual blocks.
    if launches["vtrace"] < steps:
        raise AssertionError(f"{name}: {launches['vtrace']} vtrace launches < {steps}")
    if launches["lstm_cell"] < (cfg.unroll_length + 1) * steps:
        raise AssertionError(f"{name}: {launches['lstm_cell']} lstm launches < 21 a step")
    if fused and launches["resblock"] < 6 * steps:
        raise AssertionError(f"{name}: {launches['resblock']} resblock launches < 6 a step")
    if not fused and launches["resblock"] != 0:
        raise AssertionError(f"{name}: {launches['resblock']} resblock launches, unfused")
    return launches


def phase_breakout_bf16(device, smi):
    """The BREAKOUT preset as `run.py --config breakout --fake-envs
    --actor-mode thread --num-actors 4 --envs-per-actor 8 --fused-conv
    --train-dtype bfloat16` configures it, for BREAKOUT_STEPS steps (module
    docstring, phase 13): the greedy-action gate that `run.py` runs first
    must pass on the card, so that run.py trains in bf16; the kernels'
    floors a step and each held to its plain version on the run's own
    learner inputs; f32 params and moments after the run; the
    gradient-rounding contract on the card; the bf16 train step alone
    against the f32 one."""
    import torch

    from torched_impala_tpu_torch import configs, run
    from torched_impala_tpu_torch.ops import conv_block, conv_block_cuda, lstm, lstm_cuda, vtrace_cuda
    from torched_impala_tpu_torch.ops.vtrace import vtrace_reference

    cfg = run.build_config(run.parse_args(
        ["--config", "breakout", "--fake-envs", "--total-steps", str(BREAKOUT_STEPS),
         "--actor-mode", "thread", "--num-actors", "4", "--envs-per-actor", "8", "--fused-conv",
         "--train-dtype", "bfloat16"]))
    assert (cfg.fused_conv, cfg.train_dtype) == (True, "bfloat16")
    failures = []
    # run.main's gate, on the run's device: a failure would make run.py
    # warn and train in f32.
    gate_ok, gate_mismatches = configs.check_train_dtype_parity(cfg, device, seed=0)
    if not gate_ok:
        failures.append(f"greedy-action gate: {gate_mismatches} mismatches")
    T, B = cfg.unroll_length, cfg.batch_size
    assert cfg.num_actors * cfg.envs_per_actor == B == 32
    assert configs.make_learner_config(cfg).train_dtype == "bfloat16"
    steps = BREAKOUT_STEPS
    learner_n = (T + 1) * B
    vtraces = CaptureInputs(vtrace_cuda, "vtrace_cuda", lambda a, kw: tuple(kw["log_rhos"].shape))
    cells = CaptureInputs(lstm_cuda, "lstm_cell_cuda",
                          lambda a, kw: tuple(a[0].shape) if a[0].shape[0] == B else None)
    blocks = CaptureInputs(conv_block_cuda, "resblock_cuda",
                           lambda a, kw: tuple(a[0].shape) if a[0].shape[0] == learner_n else None)
    run = {}

    def after(result, seen):
        run["learner"] = result.learner
        return {}

    launches = drive("breakout_bf16", cfg, steps, device, standalone=False, profiled=False,
                     after=after, during=(vtraces, cells, blocks))
    learner = run["learner"]
    learner_blocks = sum(blocks.calls.values())
    if launches["vtrace"] < steps or vtraces.calls.get((T, B), 0) < steps:
        failures.append(f"{launches['vtrace']} vtrace launches < 1 a step")
    if launches["lstm_cell"] < (T + 1) * steps or cells.calls.get((B, 256), 0) < (T + 1) * steps:
        failures.append(f"{launches['lstm_cell']} lstm launches < 21 a step")
    if learner_blocks < 6 * steps:
        failures.append(f"{learner_blocks} resblock launches at N = {learner_n} < 6 a step")
    errors, equal = {}, {}
    _, kwargs = vtraces.captured[(T, B)]
    out, ref = vtrace_cuda.vtrace_cuda(**kwargs), vtrace_reference(**kwargs)
    errors["vtrace"] = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    for shape, (args, _) in cells.captured.items():
        out, ref = lstm_cuda.lstm_cell_cuda(*args), lstm.lstm_reference(*args)
        errors["lstm_cell_" + "x".join(map(str, shape))] = max(
            float((a - b).abs().max()) for a, b in zip(out, ref))
    for shape, (args, _) in sorted(blocks.captured.items()):
        out, ref = conv_block_cuda.resblock_cuda(*args), conv_block.block_reference(*args)
        key = "resblock_" + "x".join(map(str, shape))
        torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_ULP, atol=BF16_ULP)
        errors[key] = float((out.float() - ref.float()).abs().max())
        equal[key] = float((out == ref).float().mean())
    lstm_err = max(v for k, v in errors.items() if k.startswith("lstm"))
    if (errors["vtrace"] > 1e-5 or lstm_err > LSTM_ATOL or len(blocks.captured) != 3
            or min(equal.values()) < 0.99):
        failures.append(f"kernels vs plain {errors}, equal {equal}")
    accumulators = {
        "params": sorted({str(p.dtype) for p in learner.params.values()}),
        "nu": sorted({str(v.dtype) for v in learner._optimizer.nu.values()}),
    }
    if accumulators != {"params": ["torch.float32"], "nu": ["torch.float32"]}:
        failures.append(f"accumulators {accumulators}")

    # On one fixed batch with non-zero LSTM start states: which grads of
    # the bf16 step are bf16-representable, by family.
    rng = np.random.default_rng(9)
    start = tuple(
        torch.from_numpy(rng.normal(size=(B, cfg.lstm_size)).astype(np.float32) * 0.5).to(device)
        for _ in range(2)
    )
    batch = fixed_batch(cfg, device, start)
    grads, _ = learner._grads(batch)
    rounded = collections.defaultdict(list)
    for name, g in zip(learner.params, grads):
        family = "lstm" if name.startswith("lstm.") else "heads" if "_head." in name else "torso"
        rounded[family].append(bool(torch.equal(g.bfloat16().float(), g)))
    contract = {family: all(flags) if family != "lstm" else not any(flags)
                for family, flags in rounded.items()}
    if contract != {"torso": True, "lstm": True, "heads": True}:
        failures.append(f"rounding contract {dict(rounded)}")

    # The bf16 train step alone against the f32 one (the same preset,
    # bf16 torso), from the run's final state on the fixed batch, twice.
    state = learner.get_state()
    del learner, run["learner"]
    alone = {"bfloat16": [], "float32": []}
    for dtype in ("bfloat16", "float32", "bfloat16", "float32"):
        step = accum_step(dataclasses.replace(cfg, train_dtype=dtype), device, state, batch,
                          1, False, {}, timed=True)
        alone[dtype].append({k: step[k] for k in (
            "events_ms", "device_busy_ms", "kernels_per_step", "peak_mb", "step_peak_mb")})
    emit({
        "phase": "breakout_bf16_checks",
        "card": smi,
        "launches_per_learner_step": {k: launches[k] / steps for k in ("vtrace", "lstm_cell", "resblock")},
        "resblock_learner_launches_per_learner_step": learner_blocks / steps,
        "max_abs_err_on_the_runs_inputs": errors,
        "resblock_equal_share": equal,
        "accumulator_dtypes_after_the_run": accumulators,
        "grads_bf16_representable": {k: f"{sum(v)}/{len(v)}" for k, v in rounded.items()},
        "greedy_action_gate": {"ok": gate_ok, "mismatches": gate_mismatches, "probe_actions": 8 * 4},
        "train_step_alone": alone,
        "failures": failures,
    })
    if failures:
        raise AssertionError(f"breakout_bf16: {failures}")
    return launches


ACCUM_G = 2
ACCUM_PUBLISH_INTERVAL = 2
# One step at G = 2 with remat against one at G = 1 without, from the same
# state, each held by the relative L2 distance of the two param steps,
# ||p_a - p_b|| / ||p_b - p_0||, which no single element dominates:
# RMSProp divides each grad by its own history, so an element whose grad
# sums cancel to near 0 can land relatively far off (PERF.md §6). With an
# f32 torso only the sum order changes, but a conv weight's grad sums
# N * H * W = 672 * 42 * 42 = 1.2e6 products at the first section:
# sqrt(1.2e6) * 2^-24 = 6.5e-5 of rounding walk, up to ten times that
# where the sum cancels, so the distance and the grad norm within 1e-3.
# With the preset's bf16 torso an activation can also round to the other
# bf16 neighbour where cuDNN runs another algorithm at the microbatch's
# N: the distance must stay below the bf16 torso's own distance from the
# f32 torso (G = 1, no remat), and the grad norm within the bf16 torso's
# own grad-norm change plus the f32 allowance.
ACCUM_F32_RTOL = 1e-3


def step_distance(a, b, before) -> float:
    """||a - b|| / ||b - before|| over every param (float64 sums)."""
    num = sum(float(((a[k] - b[k]).double() ** 2).sum()) for k in a)
    den = sum(float(((b[k] - before[k]).double() ** 2).sum()) for k in a)
    return math.sqrt(num / den)


def accum_step(cfg, device, state, batch, grad_accum, remat, learner_fields, breakdown=False,
               timed=False):
    """A learner for `cfg` with `grad_accum` and `remat_torso=remat`, set to
    `state`, takes one warm-up step on `batch` and is set to `state` again;
    then one measured step. Returns its params after the step, logs,
    launches, peak MB and peak MB above what was allocated before the
    step, with `breakdown` where a third step from `state` peaks
    (`profiling.peak_live_blocks`; not with remat, whose recompute inside
    the fused block's backward the allocator's stack recording does not
    survive), and with `timed` the median of 10 further steps between CUDA
    events and the profiler's device-busy ms and kernels a step over 5;
    the learner is dropped, so the next one's peak does not count it."""
    import torch

    from torched_impala_tpu_torch import configs
    from torched_impala_tpu_torch.ops import profiling
    from torched_impala_tpu_torch.runtime.learner import Learner

    cfg = dataclasses.replace(cfg, remat_torso=remat)
    learner = Learner(
        agent=configs.make_agent(cfg, seed=0),
        optimizer=configs.make_optimizer(cfg),
        config=dataclasses.replace(
            configs.make_learner_config(cfg), **dict(learner_fields, grad_accum=grad_accum)
        ),
        device=device,
    )
    learner.set_state(state)
    learner.train_step(batch)
    learner.set_state(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    zero_launches()
    logs = learner.train_step(batch)
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    out = dict(params={k: v.detach().clone() for k, v in learner.params.items()}, logs=logs,
               launches=launches, peak_mb=peak / 2**20, step_peak_mb=(peak - before) / 2**20)
    if breakdown:
        learner.set_state(state)
        out["breakdown"] = profiling.peak_live_blocks(lambda: learner.train_step(batch))
    if timed:
        out["events_ms"] = time_cuda(lambda: learner.train_step(batch), iters=10, warmup=2)
        busy_us, out["kernels_per_step"] = profiling.device_us(
            lambda: learner.train_step(batch), calls=5)
        out["device_busy_ms"] = None if busy_us is None else busy_us / 1e3
    return out


def phase_breakout_accum(device, smi):
    """The BREAKOUT preset at full width with both memory levers, the
    batch-scaled lr with warmup and a publish interval: `loop.train` for
    BREAKOUT_STEPS steps on 4 thread actors x 8 envs, then checks of one
    train step alone on a fixed batch (module docstring, phase 14)."""
    import torch

    from torched_impala_tpu_torch import configs
    from torched_impala_tpu_torch.optim import RMSProp
    from torched_impala_tpu_torch.runtime.param_store import ParamStore

    cfg = dataclasses.replace(
        configs.BREAKOUT,
        actor_mode="thread",
        num_actors=4,
        envs_per_actor=8,
        fused_conv=True,
        remat_torso=True,
        lr_scale_ref_batch=16,
        lr_warmup_steps=4,
    )
    fields = dict(grad_accum=ACCUM_G, publish_interval=ACCUM_PUBLISH_INTERVAL)
    assert cfg.num_actors * cfg.envs_per_actor == cfg.batch_size == 32
    steps = BREAKOUT_STEPS
    T, B = cfg.unroll_length, cfg.batch_size
    # Every publish (store, version) and every optimizer step (optimizer,
    # count, lr) of the run, recorded by wrapping the two methods.
    published, stepped = [], []
    publish, step = ParamStore.publish, RMSProp.step

    def recording_publish(store, version, params):
        published.append((id(store), version))
        return publish(store, version, params)

    def recording_step(opt, params, grads):
        count = opt.count
        step(opt, params, grads)
        stepped.append((id(opt), count, opt.last_lr))

    loop_state = {}

    def after(result, seen):
        learner = result.learner
        loop_state["state"] = learner.get_state()
        loop_state["versions"] = [v for store, v in published if store == id(learner.param_store)]
        loop_state["lrs"] = {c: lr for opt, c, lr in stepped if opt == id(learner._optimizer)}
        return dict(published_versions=loop_state["versions"], lr_by_count=loop_state["lrs"])

    ParamStore.publish, RMSProp.step = recording_publish, recording_step
    try:
        launches = drive("breakout_accum", cfg, steps, device, after=after, learner_fields=fields,
                         profiled=False)
    finally:
        ParamStore.publish, RMSProp.step = publish, step
    # The loop's own checks: kernels of the path, publishes on crossings,
    # the lr of each count.
    if launches["vtrace"] < ACCUM_G * steps:
        raise AssertionError(f"breakout_accum: {launches['vtrace']} vtrace launches < 2 a step")
    if launches["lstm_cell"] < ACCUM_G * (T + 1) * steps:
        raise AssertionError(f"breakout_accum: {launches['lstm_cell']} lstm launches < 42 a step")
    if launches["resblock"] < 2 * 6 * ACCUM_G * steps:
        raise AssertionError(f"breakout_accum: {launches['resblock']} resblock launches < 24 a step")
    versions = loop_state["versions"]
    frames = T * B
    want_versions = [k * frames for k in range(0, steps + 1, ACCUM_PUBLISH_INTERVAL)]
    if versions != want_versions:
        raise AssertionError(f"breakout_accum: published versions {versions}, want {want_versions}")
    schedule = configs.make_lr_schedule(cfg)
    lrs = loop_state["lrs"]
    for count in range(6):
        if lrs.get(count) != schedule(count):
            raise AssertionError(f"breakout_accum: lr {lrs.get(count)} at count {count}, "
                                 f"schedule {schedule(count)}")

    # One train step alone from the loop's final state, on a fixed batch
    # with non-zero LSTM start states.
    rng = np.random.default_rng(9)
    start = tuple(
        torch.from_numpy(rng.normal(size=(B, cfg.lstm_size)).astype(np.float32) * 0.5).to(device)
        for _ in range(2)
    )
    batch = fixed_batch(cfg, device, start)
    state = loop_state["state"]
    runs = {}
    for key in ((1, False), (1, False), (ACCUM_G, False), (1, True), (ACCUM_G, True)):
        runs.setdefault(key, []).append(
            accum_step(cfg, device, state, batch, *key, fields, breakdown=key == (1, False)))
    def differing(a, b):
        """The params (and the grad norm) in which two steps' bits differ,
        with the largest difference of each."""
        pa, pb = a["params"], b["params"]
        out = {k: float((pa[k] - pb[k]).abs().max()) for k in pa if not torch.equal(pa[k], pb[k])}
        if not torch.equal(a["logs"]["grad_norm_unclipped"], b["logs"]["grad_norm_unclipped"]):
            out["grad_norm_unclipped"] = float(
                (a["logs"]["grad_norm_unclipped"] - b["logs"]["grad_norm_unclipped"]).abs())
        return out

    def bit_checks():
        pairs = {"two plain steps": runs[(1, False)]}
        for G in (1, ACCUM_G):
            pairs[f"remat on and off at G = {G}"] = (runs[(G, True)][0], runs[(G, False)][0])
        return {name: diff for name, pair in pairs.items() if (diff := differing(*pair))}

    # cuDNN may run convolutions with non-deterministic algorithms: if any
    # pair differs, every step is taken again with deterministic ones and
    # the pairs must then agree; the line reports both.
    without_deterministic = bit_checks()
    cudnn_deterministic = bool(without_deterministic)
    failures = []
    if cudnn_deterministic:
        torch.backends.cudnn.deterministic = True
        try:
            for key in list(runs):
                runs[key] = [accum_step(cfg, device, state, batch, *key, fields,
                                        breakdown=key == (1, False)) for _ in runs[key]]
        finally:
            torch.backends.cudnn.deterministic = False
        failures += [f"with deterministic cuDNN, {name} differ: {diff}"
                     for name, diff in bit_checks().items()]

    before = {k: v.to(device) for k, v in state["params"].items()}
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    f32 = {key: accum_step(cfg32, device, state, batch, *key, fields)
           for key in ((1, False), (ACCUM_G, True))}
    base, lever = runs[(1, False)][0], runs[(ACCUM_G, True)][0]
    agreement = {}
    for torso, (a, b) in (("f32", (f32[(ACCUM_G, True)], f32[(1, False)])), ("bf16", (lever, base))):
        gn_a, gn_b = (float(r["logs"]["grad_norm_unclipped"]) for r in (a, b))
        agreement[torso] = dict(step_distance=step_distance(a["params"], b["params"], before),
                                grad_norm_G1=gn_b, grad_norm_G2_remat=gn_a)
    gn_f32 = agreement["f32"]["grad_norm_G1"]
    agreement["bf16"]["bf16_torso_step_distance_from_f32"] = step_distance(
        base["params"], f32[(1, False)]["params"], before)
    agreement["bf16"]["bf16_torso_grad_norm_change_from_f32"] = abs(
        agreement["bf16"]["grad_norm_G1"] - gn_f32)
    failures += [f"G2 + remat against G1, {name}: {agreement}" for name, ok in {
        "f32 step distance": agreement["f32"]["step_distance"] <= ACCUM_F32_RTOL,
        "f32 grad norm": abs(agreement["f32"]["grad_norm_G2_remat"] - gn_f32)
        <= ACCUM_F32_RTOL * gn_f32,
        "bf16 step distance": agreement["bf16"]["step_distance"]
        < agreement["bf16"]["bf16_torso_step_distance_from_f32"],
        "bf16 grad norm": abs(agreement["bf16"]["grad_norm_G2_remat"]
                              - agreement["bf16"]["grad_norm_G1"])
        <= agreement["bf16"]["bf16_torso_grad_norm_change_from_f32"] + ACCUM_F32_RTOL * gn_f32,
    }.items() if not ok]

    def label(G, remat):
        return f"G{G}_remat_{'on' if remat else 'off'}"

    step_launches = {label(*key): runs[key][0]["launches"] for key in runs}
    want = {"vtrace": ACCUM_G, "lstm_cell": ACCUM_G * (T + 1), "resblock": 2 * 6 * ACCUM_G}
    got = {k: step_launches[f"G{ACCUM_G}_remat_on"][k] for k in want}
    if got != want:
        failures.append(f"one step launched {got}, want {want}")
    off = step_launches[f"G{ACCUM_G}_remat_off"]["resblock"]
    if off != 6 * ACCUM_G:
        failures.append(f"{off} resblock launches with remat off, want 12")
    peaks = {label(*key): runs[key][0]["peak_mb"] for key in runs}
    step_peaks = {label(*key): runs[key][0]["step_peak_mb"] for key in runs}
    breakdown = runs[(1, False)][0]["breakdown"]
    higher = [key for key, mb in peaks.items() if key != "G1_remat_off" and not mb < peaks["G1_remat_off"]]
    if higher:
        failures.append(f"the peak of {higher} is not below G1_remat_off's")
    emit(
        {
            "phase": "breakout_accum_step",
            "card": smi,
            "cudnn_deterministic": cudnn_deterministic,
            "bits_differ_without_deterministic_cudnn": {
                name: dict(list(diff.items())[:5]) for name, diff in without_deterministic.items()},
            "one_step_launches": step_launches,
            "peak_mb": peaks,
            "step_peak_mb_above_before": step_peaks,
            "where_G1_remat_off_peaks": breakdown,
            "G2_remat_vs_G1": agreement,
            "failures": failures,
        }
    )
    if failures:
        raise AssertionError(f"breakout_accum: {failures}")
    return launches


def phase_breakout_superbatch(device):
    """BREAKOUT fused at 2 steps a dispatch (the queue feed's superbatch
    assembly) on 4 thread actors x 8 envs for 6 dispatches; the LSTM cell
    and the residual block held to their plain versions on the run's own
    learner inputs (module docstring, phase 15)."""
    import torch

    from torched_impala_tpu_torch import configs
    from torched_impala_tpu_torch.ops import conv_block, conv_block_cuda, lstm, lstm_cuda

    K = BREAKOUT_SUPERBATCH_K
    steps = K * BREAKOUT_SUPERBATCH_DISPATCHES
    cfg = dataclasses.replace(configs.BREAKOUT, actor_mode="thread", num_actors=4,
                              envs_per_actor=8, fused_conv=True, steps_per_dispatch=K)
    T, B = cfg.unroll_length, cfg.batch_size
    assert cfg.num_actors * cfg.envs_per_actor == B == 32
    learner_n = (T + 1) * B
    cells = CaptureInputs(lstm_cuda, "lstm_cell_cuda",
                          lambda a, kw: tuple(a[0].shape) if a[0].shape[0] == B else None)
    blocks = CaptureInputs(conv_block_cuda, "resblock_cuda",
                           lambda a, kw: tuple(a[0].shape) if a[0].shape[0] == learner_n else None)
    with cells, blocks:
        launches = drive("breakout_superbatch", cfg, steps, device, standalone=False,
                         profiled=False)
    if launches["vtrace"] != steps:
        raise AssertionError(f"breakout_superbatch: {launches['vtrace']} vtrace launches, want {steps}")
    if launches["lstm_cell"] < (T + 1) * steps:
        raise AssertionError(f"breakout_superbatch: {launches['lstm_cell']} lstm launches < 21 a step")
    if launches["resblock"] < 6 * steps:
        raise AssertionError(f"breakout_superbatch: {launches['resblock']} resblock launches < 6 a step")
    errors = {}
    for shape, (args, _) in cells.captured.items():
        out, ref = lstm_cuda.lstm_cell_cuda(*args), lstm.lstm_reference(*args)
        errors["lstm_cell_" + "x".join(map(str, shape))] = max(
            float((a - b).abs().max()) for a, b in zip(out, ref))
    equal = {}
    for shape, (args, _) in blocks.captured.items():
        out, ref = conv_block_cuda.resblock_cuda(*args), conv_block.block_reference(*args)
        key = "resblock_" + "x".join(map(str, shape))
        torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_ULP, atol=BF16_ULP)
        errors[key] = float((out.float() - ref.float()).abs().max())
        equal[key] = float((out == ref).float().mean())
    if len(cells.captured) != 1 or len(blocks.captured) != 3:
        raise AssertionError(f"breakout_superbatch: captured {list(cells.captured)} "
                             f"{list(blocks.captured)}")
    lstm_err = max(v for k, v in errors.items() if k.startswith("lstm"))
    if not lstm_err <= LSTM_ATOL or min(equal.values()) < 0.99:
        raise AssertionError(f"breakout_superbatch: kernels vs plain {errors}, equal {equal}")
    emit({
        "phase": "breakout_superbatch_checks",
        "launches_per_learner_step": {k: launches[k] / steps for k in ("vtrace", "lstm_cell", "resblock")},
        "max_abs_err_on_the_runs_inputs": errors,
        "resblock_equal_share": equal,
    })
    return launches


def phase_procgen(device, smi):
    """The PROCGEN preset as `run.py --config procgen --fake-envs
    --num-actors 64 --fused-conv` configures it (module docstring, phase
    17): V-trace at [20, 64] and the bf16 block at the learner's N = 1344
    and the async waves' N, each held to its plain version on the run's
    own inputs."""
    import torch

    from torched_impala_tpu_torch import configs, run
    from torched_impala_tpu_torch.ops import conv_block, conv_block_cuda, vtrace_cuda
    from torched_impala_tpu_torch.ops.vtrace import vtrace_reference

    steps = PROCGEN_STEPS
    cfg = run.build_config(run.parse_args(
        ["--config", "procgen", "--fake-envs", "--total-steps", str(steps),
         "--num-actors", str(PROCGEN_WORKERS), "--fused-conv"]))
    assert (cfg.actor_mode, cfg.pool_mode, cfg.pool_ready_fraction, cfg.num_actors,
            cfg.envs_per_actor) == ("process", "async", 0.5, PROCGEN_WORKERS, 1)
    assert (cfg.obs_shape, cfg.num_actions, cfg.unroll_length, cfg.batch_size, cfg.use_lstm,
            cfg.fused_conv, cfg.dp_devices) == ((64, 64, 3), 15, 20, 64, False, True, -1)
    dp = configs.resolve_dp_devices(cfg.dp_devices, device)
    T, B = cfg.unroll_length, cfg.batch_size
    learner_n = (T + 1) * B
    vtraces = CaptureInputs(vtrace_cuda, "vtrace_cuda", lambda a, kw: tuple(kw["log_rhos"].shape))
    blocks = CaptureInputs(conv_block_cuda, "resblock_cuda", lambda a, kw: tuple(a[0].shape))
    launches = drive(
        "procgen", cfg, steps, device, at_step5=processes_mid_run,
        after=lambda r, seen: check_workers("procgen", r, seen, count=PROCGEN_WORKERS),
        during=(vtraces, blocks),
    )
    # The actors' waves launch most blocks; the learner's own, at N =
    # (T + 1) * B, are counted apart.
    learner_blocks = sum(n for s, n in blocks.calls.items() if s[0] == learner_n)
    if launches["vtrace"] < steps or vtraces.calls.get((T, B), 0) < steps:
        raise AssertionError(f"procgen: {launches['vtrace']} vtrace launches, "
                             f"{vtraces.calls} calls by shape, < {steps} steps")
    if learner_blocks < 6 * steps:
        raise AssertionError(f"procgen: {learner_blocks} resblock launches at N = {learner_n} "
                             f"< 6 a step")
    args, kwargs = vtraces.captured[(T, B)]
    out, ref = vtrace_cuda.vtrace_cuda(**kwargs), vtrace_reference(**kwargs)
    vtrace_err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    if not vtrace_err <= 1e-5:
        raise AssertionError(f"procgen: vtrace vs plain {vtrace_err}")
    errors, equal = {}, {}
    for shape, (args, _) in sorted(blocks.captured.items()):
        out, ref = conv_block_cuda.resblock_cuda(*args), conv_block.block_reference(*args)
        key = "x".join(map(str, shape))
        torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_ULP, atol=BF16_ULP)
        errors[key] = float((out.float() - ref.float()).abs().max())
        equal[key] = float((out == ref).float().mean())
    learner_keys = ["x".join(map(str, s)) for s in BLOCK_PROCGEN_LEARNER_SHAPES]
    actor_ns = sorted({s[0] for s in blocks.captured if s[0] != learner_n})
    if not set(learner_keys) <= set(errors) or not actor_ns or min(equal.values()) < 0.99:
        raise AssertionError(f"procgen: blocks vs plain {errors}, equal {equal}")
    emit({
        "phase": "procgen_checks",
        "card": smi,
        "dp_devices_resolved": dp,
        "launches_per_learner_step": {k: launches[k] / steps for k in ("vtrace", "resblock")},
        "resblock_learner_launches_per_learner_step": learner_blocks / steps,
        "vtrace_max_abs_err_on_the_runs_input": vtrace_err,
        "resblock_learner_max_abs_err": {k: errors[k] for k in learner_keys},
        "resblock_learner_equal_share": {k: equal[k] for k in learner_keys},
        "resblock_actor_block_ns": actor_ns,
        "resblock_actor_max_abs_err": max(v for k, v in errors.items() if k not in learner_keys),
        "resblock_actor_min_equal_share": min(v for k, v in equal.items() if k not in learner_keys),
    })
    return launches


def phase_pong_transformer(device):
    from torched_impala_tpu_torch import configs

    cfg = dataclasses.replace(
        configs.PONG_TRANSFORMER,
        actor_mode="thread",
        num_actors=4,
        envs_per_actor=8,
        transformer_dense_kernel="kernel",
        fused_epilogue=True,
    )
    assert cfg.num_actors * cfg.envs_per_actor == cfg.batch_size == 32
    steps = PONG_TRANSFORMER_STEPS
    launches = drive("pong_transformer", cfg, steps, device)
    # Each learner step unrolls the two layers over T + 1 = 21 queries
    # (the actors' T = 1 steps take the einsum branch) and runs the fused
    # loss in place of V-trace.
    for key in ("attention_fwd", "attention_bwd"):
        if launches[key] < cfg.transformer_layers * steps:
            raise AssertionError(f"pong_transformer: {launches[key]} {key} launches < 2 a step")
    for key in ("fused_loss_fwd", "fused_loss_bwd"):
        if launches[key] < steps:
            raise AssertionError(f"pong_transformer: {launches[key]} {key} launches < 1 a step")
    if launches["vtrace"] != 0:
        raise AssertionError(f"pong_transformer: {launches['vtrace']} vtrace launches, fused")
    return launches


# The health phase: the `--health` run's steps, each logged, so the
# staleness correlation has its 8 samples; the crash run's learner crash.
HEALTH_RUN_STEPS = 10
HEALTH_CRASH_AT = 3
# Fused against unfused health logs on one step: the loss's keys agree far
# closer (both take log_rhos and vs from the V-trace kernel); the grad
# norms and update ratios carry the two losses' grads.
HEALTH_RTOL, HEALTH_ATOL = 1e-4, 1e-5


def health_step(cfg, device, batch, fused):
    """One health-on train step of `cfg` (seed 0) on `batch` with the fused
    or the separate loss, cuDNN deterministic: its float logs, its
    launches, and the V-trace kernel's captured input."""
    import torch

    from torched_impala_tpu_torch import configs
    from torched_impala_tpu_torch.ops import vtrace_cuda
    from torched_impala_tpu_torch.runtime.learner import Learner

    cfg = dataclasses.replace(cfg, fused_epilogue=fused)
    learner = Learner(agent=configs.make_agent(cfg, seed=0), optimizer=configs.make_optimizer(cfg),
                      config=configs.make_learner_config(cfg), device=device)
    vtraces = CaptureInputs(vtrace_cuda, "vtrace_cuda", lambda a, kw: tuple(kw["log_rhos"].shape))
    torch.backends.cudnn.deterministic = True
    try:
        zero_launches()
        with vtraces:
            logs = learner.train_step(batch)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    return {k: float(v) for k, v in logs.items()}, read_launches(), vtraces


def phase_health(device, smi):
    """The training-health plane on the card (module docstring, phase 18):
    (a) one health-on step of the Breakout preset (fused blocks) with the
    fused loss against one with the separate loss, from the same params on
    a fixed batch; (b) the fused step's diagnostic V-trace launch against
    its plain version on the step's own input; (c) the train step's
    kernels with health off and on, Breakout on the fused loss and Pong on
    the separate one (`compare_builds.train_step_numbers`, as it times the
    parent's tree); (d) `run.py --config pong --fake-envs --health`: every
    health gauge of the Pong net in the registry, finite; then the same
    with a `crash_learner` plan: ChaosError and exactly one crash bundle,
    each of its three files loading."""
    import tempfile

    import torch

    from torched_impala_tpu_torch import configs, run
    from torched_impala_tpu_torch.ops import compare_builds, vtrace_cuda
    from torched_impala_tpu_torch.ops.vtrace import vtrace_reference
    from torched_impala_tpu_torch.resilience import ChaosError
    from torched_impala_tpu_torch.telemetry import get_registry, health, validate_chrome_trace

    failures = []
    marks = [time.monotonic()]
    # (a) and (b).
    cfg = dataclasses.replace(configs.BREAKOUT, fused_conv=True, health_diagnostics=True)
    T, B = cfg.unroll_length, cfg.batch_size
    rng = np.random.default_rng(9)
    start = tuple(
        torch.from_numpy(rng.normal(size=(B, cfg.lstm_size)).astype(np.float32) * 0.5).to(device)
        for _ in range(2)
    )
    batch = fixed_batch(cfg, device, start)
    fused_logs, fused_launches, vtraces = health_step(cfg, device, batch, fused=True)
    sep_logs, sep_launches, _ = health_step(cfg, device, batch, fused=False)
    keys = sorted(k for k in sep_logs if k.startswith("health_"))
    if sorted(k for k in fused_logs if k.startswith("health_")) != keys or len(keys) != 15 + 2 * 4:
        failures.append(f"health keys: fused {sorted(fused_logs)}, separate {keys}")
    diffs = {k: abs(fused_logs[k] - sep_logs[k]) for k in keys if k in fused_logs}
    off = {k: d for k, d in diffs.items() if not d <= HEALTH_ATOL + HEALTH_RTOL * abs(sep_logs[k])}
    if off or not all(math.isfinite(v) for v in fused_logs.values()):
        failures.append(f"fused vs separate health logs past the gate: {off}")
    if (fused_launches["vtrace"], fused_launches["fused_loss_fwd"],
            fused_launches["fused_loss_bwd"], sep_launches["vtrace"]) != (1, 1, 1, 1):
        failures.append(f"launches: fused {fused_launches}, separate {sep_launches}")
    _, kwargs = vtraces.captured[(T, B)]
    out, ref = vtrace_cuda.vtrace_cuda(**kwargs), vtrace_reference(**kwargs)
    vtrace_err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    if not vtrace_err <= 1e-5:
        failures.append(f"diagnostic V-trace vs plain {vtrace_err}")

    # (c): the step's kernels, health off and on, timed as compare_builds
    # times each tree's.
    marks.append(time.monotonic())
    step_line, added = {}, {}
    for name, preset in (
        ("breakout_fused_loss", compare_builds.train_presets()["breakout_fused_loss"]),
        ("pong", configs.PONG),
    ):
        by_name = {}
        for flag in ("off", "on"):
            numbers = compare_builds.train_step_numbers(
                dataclasses.replace(preset, health_diagnostics=flag == "on"), device)
            step_line[f"{name}_health_{flag}"] = {
                k: numbers[k] for k in ("events_ms", "device_busy_ms", "kernels")}
            by_name[flag] = {k: n for k, (n, _) in numbers["kernels_by_name"].items()}
        diff = {k: by_name["on"].get(k, 0) - by_name["off"].get(k, 0)
                for k in by_name["on"].keys() | by_name["off"].keys()}
        added[name] = {k: d for k, d in diff.items() if d}
        if any(d < 0 for d in diff.values()):
            failures.append(f"{name}: health on launches fewer of {added[name]}")

    # (d): run.py --health, then a crash_learner plan.
    marks.append(time.monotonic())
    names = [k for k, _ in configs.make_agent(configs.PONG, seed=0).net.named_parameters()]
    expected = expected_health_gauges(names)
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--config", "pong", "--fake-envs", "--health", "--total-steps",
                str(HEALTH_RUN_STEPS), "--log-every", "1"]
        zero_launches()
        t0 = time.monotonic()
        run.main(argv + ["--postmortem-dir", os.path.join(tmp, "run")])
        run_s = time.monotonic() - t0
        run_launches = read_launches()
        snap = get_registry().snapshot()
        gauges = {k[len("telemetry/"):]: v for k, v in snap.items()
                  if k.startswith("telemetry/health/")}
        if not expected <= set(gauges) or not all(math.isfinite(gauges[k]) for k in expected):
            failures.append(f"--health gauges {gauges}, expected {sorted(expected)}")
        if run_launches["vtrace"] < HEALTH_RUN_STEPS:
            failures.append(f"--health run: {run_launches['vtrace']} vtrace launches")
        run_bundles = sorted(os.listdir(os.path.join(tmp, "run"))) if os.path.isdir(
            os.path.join(tmp, "run")) else []
        plan = os.path.join(tmp, "plan.json")
        with open(plan, "w") as f:
            json.dump([{"kind": "crash_learner", "at": HEALTH_CRASH_AT}], f)
        crash_dir = os.path.join(tmp, "crash")
        crashed = None
        try:
            run.main(argv + ["--postmortem-dir", crash_dir, "--chaos-plan", plan])
        except ChaosError as e:
            crashed = repr(e)
        bundles = sorted(os.listdir(crash_dir)) if os.path.isdir(crash_dir) else []
        loaded = {}
        if crashed is None or len(bundles) != 1 or not bundles[0].endswith("_crash"):
            failures.append(f"crash run: error {crashed}, bundles {bundles}")
        else:
            path = os.path.join(crash_dir, bundles[0])
            with open(os.path.join(path, health.BUNDLE_MANIFEST)) as f:
                manifest = json.load(f)
            with open(os.path.join(path, health.BUNDLE_TRACE)) as f:
                trace_problems = validate_chrome_trace(json.load(f))
            with open(os.path.join(path, health.BUNDLE_SNAPSHOTS)) as f:
                rows = [json.loads(line) for line in f]
            loaded = {"files": sorted(os.listdir(path)), "reason": manifest["reason"],
                      "counters": manifest["counters"], "trace_problems": trace_problems,
                      "snapshot_rows": len(rows)}
            if (loaded["files"] != sorted([health.BUNDLE_MANIFEST, health.BUNDLE_TRACE,
                                            health.BUNDLE_SNAPSHOTS])
                    or manifest["reason"] != "crash" or trace_problems or not rows):
                failures.append(f"crash bundle {loaded}")
    marks.append(time.monotonic())
    emit({
        "phase": "health",
        "card": smi,
        "seconds_by_part": dict(zip(("a_b", "c", "d"), np.diff(marks).tolist())),
        "fused_vs_separate_max_abs_diff": max(diffs.values()) if diffs else None,
        "fused_vs_separate_abs_diff": diffs,
        "step_launches": {"fused": fused_launches, "separate": sep_launches},
        "diagnostic_vtrace_max_abs_err": vtrace_err,
        "train_step": step_line,
        "health_on_added_kernels_by_name": added,
        "health_run_s": run_s,
        "health_run_launches": run_launches,
        "health_gauges": gauges,
        "health_run_bundles": run_bundles,
        "crash_run": {"error": crashed, "bundles": bundles, **loaded},
        "failures": failures,
    })
    if failures:
        raise AssertionError(f"health: {failures}")


# The resume phase. Run 1's fault plan: one env worker killed (the 60th
# pool-site event: a lockstep step of either pool), actor 0 raised at an
# unroll start, the third save (step 12) corrupted, the learner crashed
# at step 14.
RESUME_STEPS = 16
RESUME_INTERVAL = 4
RESUME_PLAN = [
    {"kind": "kill_env_worker", "at": 60},
    {"kind": "raise_in_actor", "at": 2, "target": 0},
    {"kind": "corrupt_checkpoint", "at": 3},
    {"kind": "crash_learner", "at": 14},
]
# Run 3, the synchronous checkpointer: saves every 4 steps, a crash at
# step 6, then a resume to step 8.
SYNC_STEPS, SYNC_CRASH = 8, 6
# Saves timed against a train step on a fixed batch (device-side).
SAVE_TIMING_REPS = 10


def step_state(agent, optimizer, num_steps, frames_per_step) -> dict:
    """`Learner.get_state()`'s content at a step, read from the objects the
    learner shares with its caller (the agent's net holds the learner's
    params, the optimizer its `nu`) on the learner thread, as clones
    queued on its current stream, the train step's: what a synchronous
    save writes at that step, taken with no host sync, so the learner and
    an async writer run on as they would without it. `states_equal`
    reads it after the run."""
    import torch

    opt = optimizer.state_dict()  # clones `nu` on the current stream
    with torch.no_grad():
        params = {k: v.detach().clone() for k, v in agent.net.named_parameters()}
    return {
        "params": params,
        "opt_state": {"count": opt["count"], "nu": opt["nu"]},
        "num_frames": num_steps * frames_per_step,
        "num_steps": num_steps,
    }


def states_equal(a, b) -> bool:
    """Bit-for-bit equality of two `get_state()`-shaped dicts."""
    import torch

    from torched_impala_tpu_torch.utils.checkpoint import flat_state

    fa, fb = flat_state(a), flat_state(b)
    if fa.keys() != fb.keys():
        return False
    for key, x in fa.items():
        y = fb[key]
        if isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or not torch.equal(x.cpu(), y.cpu()):
                return False
        elif int(x) != int(y):
            return False
    return True


def recording_injector(plan):
    """A `ChaosInjector` that also keeps every pool it hooks and every
    worker pid it sees, for the no-process-left check."""
    from torched_impala_tpu_torch.resilience import ChaosInjector

    class Recording(ChaosInjector):
        def __init__(self, plan):
            super().__init__(plan)
            self.pools, self.pids = {}, set()

        def pool_hook(self, pool):
            self.pools[id(pool)] = pool
            self.pids.update(pool.pids)
            super().pool_hook(pool)

    return Recording(plan)


def check_pools_gone(name, injector) -> None:
    """Every worker the run's pools ever had has exited, each pool is
    closed and its shared-memory segment unlinked."""
    alive = [p for p in injector.pids if os.path.exists(f"/proc/{p}")]
    shm = [p.shm_name for p in injector.pools.values()
           if os.path.exists(f"/dev/shm/{p.shm_name.lstrip('/')}")]
    if not injector.pools or alive or shm or not all(p._closed for p in injector.pools.values()):
        raise AssertionError(f"{name}: pools {len(injector.pools)}, workers alive {alive}, shm {shm}")


def median(xs):
    return statistics.median(xs) if xs else None


def resume_runs(cfg, device, directory, min_step_s=0.0, after_run1=None) -> dict:
    """Run 1 (async checkpointer and RESUME_PLAN: ends in ChaosError), the
    restore alone, run 2 (resume="auto" to RESUME_STEPS) and run 3 (the
    synchronous checkpointer, a crash and a resume) with preset `cfg` in
    `directory`, through `loop.train`; raises on a failed check and
    returns the numbers. Each step takes at least `min_step_s` seconds,
    and 0.1 s more until the supervisor's first restart shows in the
    logs, so the crash cannot come before its monitor has looked.
    `after_run1()` runs once run 1 has ended."""
    import contextlib
    import io

    import torch

    from torched_impala_tpu_torch import configs
    from torched_impala_tpu_torch.resilience import (
        AsyncCheckpointer, ChaosError, ChaosPlan, config_fingerprint, recovery,
    )
    from torched_impala_tpu_torch.runtime import loop
    from torched_impala_tpu_torch.runtime.learner import Learner
    from torched_impala_tpu_torch.runtime.vector_actor import VectorActor
    from torched_impala_tpu_torch.utils.checkpoint import (
        CheckpointCorruptError, Checkpointer, load_state_file,
    )

    cuda = device.type == "cuda"
    frames = cfg.unroll_length * cfg.batch_size
    fp = config_fingerprint(cfg)
    out = {"config_hash": fp}

    def run(rec, seed, on_step, **kwargs):
        """`loop.train` from fresh params of `seed`; `rec` gets the
        logged (step, time, supervisor restarts, pool restarts), the
        run's stderr, the agent and the optimizer. With an async
        checkpointer, the step before each due save waits for its writer
        to be idle, so no due save is skipped for a busy writer and the
        saves land where the checks expect them (the skip itself is held
        to JAX's by the CPU tests)."""
        ck = kwargs.get("async_checkpointer")

        def on_learner_step(n):
            if ck is not None and (n + 1) % RESUME_INTERVAL == 0:
                ck.wait()
            on_step(rec, n)

        rec.update(logs=[], stderr="", agent=configs.make_agent(cfg, seed=seed),
                   optimizer=configs.make_optimizer(cfg))

        def logger(logs):
            rec["logs"].append((logs["num_steps"], time.perf_counter(),
                                logs["actor_restarts"], logs["pool_restarts"]))
            time.sleep(min_step_s + (0.1 if logs["actor_restarts"] == 0 else 0.0))

        err = io.StringIO()
        try:
            with contextlib.redirect_stderr(err):
                return loop.train(
                    agent=rec["agent"], total_steps=kwargs.pop("total_steps"), logger=logger,
                    log_every=1, on_learner_step=on_learner_step, config_hash=fp,
                    **dict(train_args(cfg, device), optimizer=rec["optimizer"]), **kwargs,
                )
        finally:
            rec["stderr"] = err.getvalue()
            sys.stderr.write(rec["stderr"])

    def probe_at(step, key):
        def on_step(rec, n):
            if n == step and key not in rec:
                rec[key] = step_state(rec["agent"], rec["optimizer"], n, frames)
        return on_step

    # Run 1: the async checkpointer under the fault plan.
    ck = AsyncCheckpointer(directory, keep=3, interval_steps=RESUME_INTERVAL, config_hash=fp)
    injector = recording_injector(ChaosPlan.from_dicts(RESUME_PLAN))
    r1 = {}
    try:
        run(r1, 0, probe_at(8, "state8"), total_steps=RESUME_STEPS, async_checkpointer=ck,
            chaos=injector)
    except ChaosError as e:
        crash = repr(e)
    else:
        raise AssertionError("resume run 1 ended without ChaosError")
    finally:
        ck.close()
    if after_run1 is not None:
        after_run1()
    fired = sorted(f.kind for f in injector.fired)
    _, _, supervisor_restarts, pool_restarts = r1["logs"][-1]
    saves1 = list(ck.records)
    if (
        fired != sorted(f["kind"] for f in RESUME_PLAN)
        or "learner crash at step 14" not in crash
        or supervisor_restarts < 1
        or pool_restarts < 1
        or "[supervisor] restarting actor 0" not in r1["stderr"]
    ):
        raise AssertionError(
            f"resume run 1: fired {fired}, {crash}, supervisor restarts "
            f"{supervisor_restarts}, pool restarts {pool_restarts}"
        )
    if [s["step"] for s in saves1] != [4, 8, 12]:
        raise AssertionError(f"resume run 1: saves at {[s['step'] for s in saves1]}")
    check_pools_gone("resume run 1", injector)
    files = sorted(os.listdir(directory))
    if any(".tmp." in name for name in files):
        raise AssertionError(f"resume run 1: a half-written file in {files}")
    corrupt = []
    for step in recovery.list_manifest_steps(directory):
        try:
            load_state_file(recovery.checkpoint_path(directory, step), r1["state8"])
        except CheckpointCorruptError:
            corrupt.append(step)
    if corrupt != [12]:
        raise AssertionError(f"resume run 1: corrupt checkpoints {corrupt}")
    step8 = load_state_file(recovery.checkpoint_path(directory, 8), r1["state8"])
    if not states_equal(step8, r1["state8"]):
        raise AssertionError("resume run 1: the step-8 file differs from get_state() at step 8")
    with_save, without = step_windows(r1["logs"], {4, 8, 12})
    out["run1"] = dict(
        crash=crash, faults_fired=fired, saves=[4, 8, 12], corrupt=corrupt,
        supervisor_restarts=supervisor_restarts, pool_restarts=pool_restarts,
        step8_file_equals_get_state=True, files=files,
        loop_step_ms_with_save=median(with_save), loop_step_ms_without_save=median(without),
        loop_steps_with_save=len(with_save), loop_steps_without_save=len(without),
    )

    # The restore alone, into a fresh learner on the device.
    learner = Learner(agent=configs.make_agent(cfg, seed=1), optimizer=configs.make_optimizer(cfg),
                      config=configs.make_learner_config(cfg), device=device)
    target = learner.get_state()
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        manifest, state = recovery.restore_latest(directory, target, config_hash=fp)
    load_s = time.perf_counter() - t0
    learner.set_state(state)
    if cuda:
        torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    sys.stderr.write(err.getvalue())
    if manifest.step != 8 or "step 12 checkpoint unusable, falling back" not in err.getvalue():
        raise AssertionError(f"restore: step {manifest.step}, {err.getvalue()!r}")
    if not states_equal(learner.get_state(), step8):
        raise AssertionError("restore: the learner's state differs from the step-8 file")
    out["restore"] = dict(step=manifest.step, fell_back_past=12, seconds=restore_s,
                          load_seconds=load_s, bytes=os.path.getsize(
                              recovery.checkpoint_path(directory, 8)))

    # Run 2: resume="auto" on the same directory.
    ck2 = AsyncCheckpointer(directory, keep=3, interval_steps=RESUME_INTERVAL, config_hash=fp)
    versions = []
    real_load = VectorActor._load_latest

    def load_latest(actor):
        version = real_load(actor)
        versions.append(version)
        return version

    def first_state(rec, n):
        if "first" not in rec:
            rec["first"] = (n, step_state(rec["agent"], rec["optimizer"], n, frames))

    r2 = {}
    VectorActor._load_latest = load_latest
    zero_launches()
    try:
        result = run(r2, 1, first_state, total_steps=RESUME_STEPS, async_checkpointer=ck2,
                     resume="auto")
    finally:
        VectorActor._load_latest = real_load
        ck2.close()
    launches = read_launches()
    final = load_state_file(recovery.checkpoint_path(directory, RESUME_STEPS), step8)
    checks = {
        "restored step 8": r2["first"][0] == 8,
        "restored params equal the step-8 file": states_equal(r2["first"][1], step8),
        "fell back past step 12": "step 12 checkpoint unusable, falling back" in r2["stderr"],
        "resumed from the step-8 manifest": "[resume] manifest @ step 8" in r2["stderr"],
        "actors first acted on the restored version": bool(versions) and min(versions) == 8 * frames,
        "reached step 16": result.learner.num_steps == RESUME_STEPS,
        "final save at step 16": ck2.all_steps()[-1] == RESUME_STEPS
        and states_equal(final, result.learner.get_state()),
        ">= 8 vtrace launches": not cuda or launches["vtrace"] >= RESUME_STEPS - 8,
    }
    if not all(checks.values()):
        raise AssertionError(f"resume run 2: {checks}")
    saves2 = list(ck2.records)
    out["run2"] = dict(checks=list(checks), saves=[s["step"] for s in saves2],
                       retained=ck2.all_steps(), vtrace_launches=launches["vtrace"],
                       first_actor_version=min(versions))

    # The train step on a fixed batch, alone and with an async save's
    # copies and write in its window (CUDA events); the clone's host ms
    # with no actor threads about.
    if cuda:
        learner = result.learner
        batch = fixed_batch(cfg, device, learner._agent.initial_state(cfg.batch_size))
        alone = time_cuda(lambda: learner.train_step(batch), iters=20, warmup=3)
        ck4 = AsyncCheckpointer(os.path.join(directory, "timing"), keep=1, interval_steps=1)
        in_window = []
        try:
            for rep in range(SAVE_TIMING_REPS):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                if not ck4.maybe_save(rep + 1, learner.get_state_device):
                    raise AssertionError("resume: the timing save was not taken")
                start.record()
                learner.train_step(batch)
                end.record()
                end.synchronize()
                in_window.append(start.elapsed_time(end))
                ck4.wait()
        finally:
            ck4.close()
        out["train_step_alone_ms"] = alone
        out["train_step_with_save_ms"] = statistics.median(in_window)
        out["clone_ms_alone"] = median([r["submit_s"] * 1e3 for r in ck4.records])
        saves2 += list(ck4.records)

    interval_saves = saves1 + saves2
    out["saves"] = dict(
        count=len(interval_saves),
        # maybe_save's call of get_state_device and the event it records,
        # in the loop's post-step hook (actor threads running).
        clone_ms_on_learner_thread=median([s["submit_s"] * 1e3 for s in saves1 + list(ck2.records)
                                            if s["interval"]]),
        writer_s=median([s["write_s"] for s in interval_saves]),
        writer_copy_s=median([s["copy_s"] for s in interval_saves]),
        bytes=median([s["bytes"] for s in interval_saves]),
        all=interval_saves,
    )

    # Run 3: the synchronous checkpointer, a crash, then a resume.
    sync_dir = os.path.join(directory, "sync")
    ck3 = Checkpointer(sync_dir, max_to_keep=3)
    save_s = []
    real_save = ck3.save

    def timed_save(step, state):
        t0 = time.perf_counter()
        saved = real_save(step, state)
        save_s.append(time.perf_counter() - t0)
        return saved

    ck3.save = timed_save
    r3 = {}
    try:
        run(r3, 2, probe_at(4, "state4"), total_steps=SYNC_STEPS, checkpointer=ck3,
            checkpoint_interval=RESUME_INTERVAL,
            chaos=ChaosPlan.from_dicts([{"kind": "crash_learner", "at": SYNC_CRASH}]))
    except ChaosError:
        pass
    else:
        raise AssertionError("resume run 3: no ChaosError")
    if ck3.all_steps() != [4] or not states_equal(ck3.restore(r3["state4"]), r3["state4"]):
        raise AssertionError(f"resume run 3: saved {ck3.all_steps()}")
    r3b = {}
    result = run(r3b, 3, first_state, total_steps=SYNC_STEPS, checkpointer=ck3,
                 checkpoint_interval=RESUME_INTERVAL, resume="auto")
    if (
        r3b["first"][0] != 4
        or not states_equal(r3b["first"][1], r3["state4"])
        or result.learner.num_steps != SYNC_STEPS
        or ck3.all_steps() != [4, SYNC_STEPS]
    ):
        raise AssertionError(f"resume run 3: first {r3b['first'][0]}, saved {ck3.all_steps()}")
    out["run3"] = dict(saves=ck3.all_steps(), resumed_from=4, sync_save_s=median(save_s))
    return out


def step_windows(logs, saved):
    """Host ms of each learner step's window (from the last step's log to
    its own), split into steps that follow a save (the writer runs in
    their window) and the rest; steps before the supervisor's first
    restart (slowed on purpose) and the first step are left out."""
    with_save, without = [], []
    for (s0, t0, restarts, _), (s1, t1, _, _) in zip(logs, logs[1:]):
        if restarts == 0:
            continue
        (with_save if s0 in saved else without).append((t1 - t0) * 1e3)
    return with_save, without


def phase_resume(device, smi):
    """The Pong preset as configured (32 worker processes, queue feed)
    crashed under a fault plan with the async checkpointer, restored, and
    resumed to its target; then the same with the synchronous one."""
    import shutil
    import tempfile

    from torched_impala_tpu_torch import configs
    from torched_impala_tpu_torch.runtime import env_pool

    cfg = configs.PONG
    assert (cfg.actor_mode, cfg.num_actors, cfg.envs_per_actor, cfg.traj_ring) == (
        "process", 32, 1, False
    )

    def no_process_left():
        # The pools' helpers outlive them (a later pool starts them again).
        env_pool.stop_helpers()
        deadline = time.monotonic() + 5
        while (left := descendants(os.getpid())) and time.monotonic() < deadline:
            time.sleep(0.05)
        if left:
            raise AssertionError(f"resume run 1: processes left {left}")

    directory = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        numbers = resume_runs(cfg, device, directory, after_run1=no_process_left)
    finally:
        shutil.rmtree(directory)
    saves = numbers["saves"]
    emit({"phase": "resume", "card": smi, **{k: numbers[k] for k in ("run1", "run2", "run3")},
          "restore": numbers["restore"], "saves": {k: v for k, v in saves.items() if k != "all"}})
    emit({"resume_train_step_ms": {
        "alone": numbers["train_step_alone_ms"], "with_save_in_window": numbers["train_step_with_save_ms"],
        "loop_window_with_save": numbers["run1"]["loop_step_ms_with_save"],
        "loop_window_without_save": numbers["run1"]["loop_step_ms_without_save"]}, "card": smi})
    emit({"resume_clone_ms_on_learner_thread": {"in_the_loop": saves["clone_ms_on_learner_thread"],
                                                 "alone": numbers["clone_ms_alone"]}, "card": smi})
    emit({"resume_writer_per_save": {"seconds": saves["writer_s"], "copy_seconds": saves["writer_copy_s"],
                                     "bytes": saves["bytes"]}, "card": smi})
    emit({"resume_restore_seconds": numbers["restore"]["seconds"], "card": smi})
    return numbers


def expected_health_gauges(param_names) -> set:
    """The `health/*` gauges a `--health` run of a net with these param
    names publishes once its staleness correlation has 8 samples: the
    loss's diagnostics, each param group's grad norm and update ratio,
    the grad-spike ratio and the staleness correlation."""
    from torched_impala_tpu_torch.ops.losses import HEALTH_LOGRHO_EDGES
    from torched_impala_tpu_torch.runtime.learner import health_param_groups

    groups = health_param_groups(param_names)
    return {f"health/{k}" for k in (
        "clip_rho_frac", "clip_c_frac", "clip_logrho_mean", "clip_logrho_std",
        *(f"clip_logrho_bin{i}" for i in range(len(HEALTH_LOGRHO_EDGES) + 1)),
        "entropy_mean", "kl_behaviour_learner", "ev_value",
        *(f"{kind}_{g}" for kind in ("grad_norm", "update_ratio") for g in groups),
        "grad_spike_ratio", "staleness_clip_corr",
    )}


def stop_children() -> None:
    """Stop every process this run started: the env pools' forkserver and
    resource tracker (they outlive the pools), then wait up to 5 s for
    every descendant to exit. One still alive is killed and fails the run."""
    env_pool = sys.modules.get("torched_impala_tpu_torch.runtime.env_pool")
    if env_pool is not None:
        env_pool.stop_helpers()
    deadline = time.monotonic() + 5
    while (left := descendants(os.getpid())) and time.monotonic() < deadline:
        time.sleep(0.05)
    for pid in left:
        try:
            os.kill(pid, 9)
            os.waitpid(pid, 0)
        except (ProcessLookupError, ChildProcessError):
            pass
    if left:
        raise AssertionError(f"processes left running at the end, killed: {left}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    try:
        kernels, smi = run_phases()
    finally:
        stop_children()
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit(
        {
            "ok": True,
            "device": {
                "platform": "gpu",
                "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count(),
            },
        }
    )
    return 0


def run_phases():
    """Every phase; returns the kernels line's entries and the card's
    name and power limit."""
    from torched_impala_tpu_torch import resolve_device

    device = resolve_device()
    smi = phase_env()
    sources = phase_build()
    if sources != ["attention_bwd", "attention_fwd", "attention_wide", "fused_loss", "lstm_cell",
                   "resblock", "vtrace"]:
        raise AssertionError(f"built {sources}, but chip_smoke checks seven sources")
    checked = {
        "vtrace": dict(phase_vtrace(device), library_ms=None),
        "lstm_cell": phase_lstm(device),
        **phase_resblock(device),
        **phase_fused_loss(device),
        **phase_attention(device),
    }
    phase_model(device)
    # Each kernel's launches come from the main path that runs it.
    launches = {"vtrace": phase_pong(device)["vtrace"]}
    phase_pong_superbatch(device, smi)
    phase_resume(device, smi)
    launches["lstm_cell"] = phase_breakout(device, fused=False)["lstm_cell"]
    launches["resblock"] = phase_breakout(device, fused=True)["resblock"]
    phase_breakout_bf16(device, smi)
    phase_breakout_accum(device, smi)
    phase_breakout_superbatch(device)
    phase_procgen(device, smi)
    transformer_launches = phase_pong_transformer(device)
    phase_health(device, smi)
    for name in ("fused_loss_fwd", "fused_loss_bwd", "attention_fwd", "attention_bwd"):
        launches[name] = transformer_launches[name]
    # No preset reaches the general kernels' shapes: their main-path count
    # is what the runs above launched of them.
    for name in ("resblock_general", "attention_wide_fwd", "attention_wide_bwd"):
        launches[name] = transformer_launches[name]
    replaces = {
        "vtrace": "torched_impala_tpu/ops/vtrace_pallas.py:92",
        "lstm_cell": "torched_impala_tpu/ops/lstm_pallas.py:78",
        "resblock": "torched_impala_tpu/ops/conv_pallas.py:76",
        "fused_loss_fwd": "torched_impala_tpu/ops/vtrace_pallas.py:267",
        "fused_loss_bwd": "torched_impala_tpu/ops/vtrace_pallas.py:384",
        "attention_fwd": "torched_impala_tpu/ops/attention_pallas.py:251",
        "attention_bwd": "torched_impala_tpu/ops/attention_pallas.py:409",
        "resblock_general": "torched_impala_tpu/ops/conv_pallas.py:76",
        "attention_wide_fwd": "torched_impala_tpu/ops/attention_pallas.py:251",
        "attention_wide_bwd": "torched_impala_tpu/ops/attention_pallas.py:409",
    }
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": f"torched_impala_tpu_torch/csrc/{SOURCES.get(name, name)}.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            **{
                k: checked[name][k]
                for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
            },
        }
        for name in replaces
    ]
    return kernels, smi


if __name__ == "__main__":
    sys.exit(main())
