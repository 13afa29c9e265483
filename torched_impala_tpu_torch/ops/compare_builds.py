"""Time another checkout of the port against this one on one card, in turns.

    python -m torched_impala_tpu_torch.ops.compare_builds BASE_ROOT

BASE_ROOT is the root of another checkout (for example a parent commit
unpacked with `git archive <rev> | tar -x -C DIR`); a variant of a kernel
is timed the same way, from a copy of this checkout with its `csrc/`
changed. Each tree's `measure()` runs in a process of its own, with that
tree's root first on `sys.path`, in the order base, this, this, base, so
that both see the same card and clocks; each builds its own kernels. A
process measures through the wrappers and entry points, so the base tree
must have the same ones. Both are read through this tree's
`ops/profiling.py` (profiler device time, mean of 100 calls unless said):

- the LSTM cell (`lstm_cuda.lstm_cell_cuda`) at the Breakout learner's
  (B, F, H) = (32, 256, 256) and its actors' (8, 256, 256);
- the attention forward kernel (`attention_cuda.attention_forward_cuda`)
  and one backward call (`attention_backward_cuda`, every kernel in it
  summed) at the pong_transformer learner's (B, T, H, dh, W) =
  (32, 21, 4, 64, 128) and at a long unroll (2, 1024, 4, 64, 128), f32,
  every slot of the same episode; and the forward again at the learner's
  shape on ragged episodes (resets mid-unroll, a cache partly of an older
  episode or empty), where masked fragments are skipped;
- V-trace (`vtrace_cuda.vtrace_cuda`) at B = 32 for T = 20, 100 and 1000;
- one fused-loss call and its backward (`losses.impala_loss` with
  `fused_epilogue`, then `torch.autograd.grad`) at each (T, B, A) of
  LOSS_SHAPES: device µs with every kernel summed, kernels a call, the
  fused-loss kernels' own device µs, and events ms;
- `Learner.train_step` on a fixed batch for each of `train_presets()`:
  Pong, Breakout unfused, with `fused_conv` and with the fused loss too,
  and pong_transformer
  (with `fused_epilogue=True` and the attention kernels): events ms
  (median of 20 steps), device-busy ms and kernels a step (10 steps),
  and each kernel's launches and device µs a step by name
  (`profiling.kernels_by_name`).

Before them, in this process, this tree's attention forward at each tile
plan of FWD_PLANS and its backward at each plan of BWD_PLANS, twice each
(the plans in order, then reversed), through the same wrappers with
`fwd_tiles` / `bwd_tiles` answering the plan.

Prints one JSON line with the card's name and power limit, each tree's
numbers by pass and the plan timings. Without a CUDA card, or without
exactly one BASE_ROOT, it exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import runpy
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

THIS_ROOT = Path(__file__).resolve().parents[2]
LSTM_SHAPES = [(32, 256, 256), (8, 256, 256)]  # B, F, H
ATTN_SHAPES = {"learner": (32, 21, 4, 64, 128), "long": (2, 1024, 4, 64, 128)}  # B, T, H, dh, W
VTRACE_T = (20, 100, 1000)
# T, B, A: the pong_transformer learner's, then batches wider than any
# preset's, where the fused forward's 8 blocks take 32 columns a block
# (B = 256) or walk several column tiles each (B = 1024).
LOSS_SHAPES = {"learner": (20, 32, 6), "wide": (20, 256, 18), "wider": (20, 1024, 18)}
# (key_warps, query_groups) of the forward and of the backward timed at
# each shape.
FWD_PLANS = {
    "learner": [(6, 2), (5, 2), (4, 2), (3, 2), (2, 2), (12, 1), (8, 1), (4, 1)],
    "long": [(3, 4), (2, 4), (1, 4), (6, 2), (4, 2), (3, 2), (12, 1), (6, 1)],
}
BWD_PLANS = {
    "learner": [(10, 1), (12, 1), (5, 1), (4, 2), (3, 2), (2, 2)],
    "long": [(4, 3), (4, 2), (3, 4), (3, 3), (2, 4), (6, 2), (4, 1)],
}
CALLS = 100
STEP_CALLS = 10
STEP_EVENTS = 20


def _profiling():
    """This tree's `ops/profiling.py`, loaded by path: every tree is read
    through the same profiler code, whichever tree's modules it measures."""
    import types

    return types.SimpleNamespace(**runpy.run_path(str(Path(__file__).with_name("profiling.py"))))


def _events_ms(fn, iters=50, warmup=5) -> float:
    """Median ms of `fn` between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _device_us(fn, kernel: str | None) -> float:
    """Mean device µs a call of `fn` spends in kernels named `kernel` (in
    every kernel it launches when `kernel` is None)."""
    fn()
    us, _ = _profiling().device_us(fn, calls=CALLS, name=kernel)
    if us is None:
        raise RuntimeError(f"the profiler saw no device time in {kernel}")
    return us


def ragged_segments(rng, B: int, T: int, W: int):
    """(seg_q [B, T], seg_ctx [B, W + T]) of episodes that reset
    mid-unroll, with a cache whose slots are of this episode, of an older
    one, or empty (-1)."""
    base = rng.integers(1, 4, size=(B, 1))
    seg_q = base + np.cumsum(rng.uniform(size=(B, T)) < 4.0 / max(T, 4), axis=1)
    cache = np.where(rng.uniform(size=(B, W)) < 0.6, base, rng.choice([-1, 0], size=(B, W)))
    return seg_q, np.concatenate([cache, seg_q], axis=1)


def attention_calls(device) -> dict:
    """name -> (kernel name or None, fn) of the attention workloads; the
    backward's fn holds the forward's outputs as its saved tensors."""
    from torched_impala_tpu_torch.ops import attention_cuda

    rng = np.random.default_rng(1)

    def f32(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    calls = {}
    for label, (B, T, H, dh, W), ragged in (
        *((label, shape, False) for label, shape in ATTN_SHAPES.items()),
        ("ragged_learner", ATTN_SHAPES["learner"], True),
    ):
        S = W + T
        q, k, v, g = f32(B, T, H, dh), f32(B, S, H, dh), f32(B, S, H, dh), f32(B, T, H, dh)
        if ragged:
            seg_q, seg_ctx = (i32(a) for a in ragged_segments(rng, B, T, W))
        else:
            seg_q = torch.ones(B, T, dtype=torch.int32, device=device)
            seg_ctx = torch.ones(B, S, dtype=torch.int32, device=device)
        args = (q, k, v, seg_q, seg_ctx, W)
        calls[f"attention_fwd_{label}"] = (
            "attention_fwd_kernel", lambda args=args: attention_cuda.attention_forward_cuda(*args))
        if not ragged:
            o, lse = attention_cuda.attention_forward_cuda(*args)
            bwd = (q, k, v, g, o, lse, seg_q, seg_ctx, W)
            calls[f"attention_bwd_call_{label}"] = (
                None, lambda bwd=bwd: attention_cuda.attention_backward_cuda(*bwd))
    return calls


def train_presets() -> dict:
    """name -> config of each train step timed: Pong, Breakout with its
    preset's unfused blocks, with `fused_conv`, and with `fused_conv` and
    `fused_epilogue`, and pong_transformer with `fused_epilogue` and the
    attention kernels."""
    from torched_impala_tpu_torch import configs

    return {
        "pong": configs.PONG,
        "breakout_unfused": configs.BREAKOUT,
        "breakout_fused": dataclasses.replace(configs.BREAKOUT, fused_conv=True),
        "breakout_fused_loss": dataclasses.replace(
            configs.BREAKOUT, fused_conv=True, fused_epilogue=True),
        "pong_transformer": dataclasses.replace(
            configs.PONG_TRANSFORMER, fused_epilogue=True, transformer_dense_kernel="kernel"),
    }


def train_step_numbers(cfg, device) -> dict:
    """`Learner.train_step` of `cfg` on a fixed full-size batch from a zero
    start state, after 3 warm-up steps: events ms (median of STEP_EVENTS
    steps), device-busy ms and kernels a step (STEP_CALLS steps), and each
    kernel's launches and device µs a step by name."""
    from torched_impala_tpu_torch import configs
    from torched_impala_tpu_torch.runtime.learner import Learner

    rng = np.random.default_rng(0)
    agent = configs.make_agent(cfg, seed=0)
    learner = Learner(agent=agent, optimizer=configs.make_optimizer(cfg),
                      config=configs.make_learner_config(cfg), device=device)
    T, B, A = cfg.unroll_length, cfg.batch_size, cfg.num_actions
    batch = (
        torch.from_numpy(rng.integers(0, 256, size=(T + 1, B, *cfg.obs_shape),
                                      dtype=np.uint8)).to(device),
        torch.zeros(T + 1, B, dtype=torch.bool, device=device),
        torch.from_numpy(rng.integers(0, A, size=(T, B))).to(device),
        torch.from_numpy(rng.normal(size=(T, B, A)).astype(np.float32)).to(device),
        torch.from_numpy((rng.uniform(size=(T, B)) < 0.05).astype(np.float32)).to(device),
        torch.ones(T, B, device=device),
        agent.net.initial_state(B),
    )
    step = lambda: learner.train_step(batch)  # noqa: E731
    for _ in range(3):
        step()
    # One profiled window: the step's device-busy time and kernels are
    # the sums of its rows by name.
    by_name = _profiling().kernels_by_name(step, calls=STEP_CALLS)
    return dict(
        events_ms=_events_ms(step, iters=STEP_EVENTS, warmup=0),
        device_busy_ms=sum(us for _, us in by_name.values()) / 1e3,
        kernels=sum(n for n, _ in by_name.values()),
        params=len(learner.params),
        kernels_by_name=by_name,
    )


def measure() -> dict:
    """This process's tree, timed on the card (see the module note)."""
    from torched_impala_tpu_torch import resolve_device
    from torched_impala_tpu_torch.ops import losses, lstm_cuda, vtrace_cuda

    profiling = _profiling()

    device = resolve_device()
    rng = np.random.default_rng(0)

    def f32(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(device)

    out = {"device_us": {}}
    for B, F, H in LSTM_SHAPES:
        args = (f32(B, F), f32(B, H), f32(B, H), f32(F, 4 * H, scale=F**-0.5),
                f32(H, 4 * H, scale=H**-0.5), f32(4 * H, scale=0.1))
        out["device_us"][f"lstm_cell_{B}x{F}x{H}"] = _device_us(
            lambda args=args: lstm_cuda.lstm_cell_cuda(*args), "lstm_cell_kernel")
    for name, (kernel, fn) in attention_calls(device).items():
        out["device_us"][name] = _device_us(fn, kernel)

    out["vtrace_device_us_by_T"] = {}
    for T in VTRACE_T:
        x = dict(log_rhos=f32(T, 32, scale=0.5), discounts=torch.full((T, 32), 0.99, device=device),
                 rewards=f32(T, 32), values=f32(T, 32), bootstrap_value=f32(32))
        out["vtrace_device_us_by_T"][str(T)] = _device_us(
            lambda x=x: vtrace_cuda.vtrace_cuda(**x), "vtrace_kernel")

    cfg = losses.ImpalaLossConfig(fused_epilogue=True)
    out["fused_loss_call"] = {}
    for label, (T, B, A) in LOSS_SHAPES.items():
        x = dict(
            target_logits=f32(T, B, A), values=f32(T, B), behaviour_logits=f32(T, B, A),
            bootstrap_value=f32(B),
            actions=torch.from_numpy(rng.integers(0, A, size=(T, B))).to(device),
            rewards=f32(T, B), discounts=torch.full((T, B), 0.99, device=device),
            mask=torch.from_numpy((rng.uniform(size=(T, B)) > 0.2).astype(np.float32)).to(device),
        )

        def loss_call(x=x):
            leaves = {k: x[k].clone().requires_grad_() for k in ("target_logits", "values")}
            total = losses.impala_loss(**{**x, **leaves}, config=cfg).total
            torch.autograd.grad(total, list(leaves.values()))

        loss_call()
        us, kernels = profiling.device_us(loss_call, calls=CALLS)
        fused_us, fused_kernels = profiling.device_us(loss_call, calls=CALLS, name="fused_loss")
        out["fused_loss_call"][label] = dict(
            shape=[T, B, A], device_us=us, kernels=kernels, fused_loss_kernels_us=fused_us,
            fused_loss_kernels=fused_kernels, events_ms=_events_ms(loss_call))

    out["train_step"] = {name: train_step_numbers(cfg, device) for name, cfg in train_presets().items()}
    return out


@contextlib.contextmanager
def _plan(module, name: str, plan):
    """`module.<name>` (a tile-plan function) answers `plan` inside."""
    saved = getattr(module, name)
    setattr(module, name, lambda *_: plan)
    try:
        yield
    finally:
        setattr(module, name, saved)


def plan_sweeps(device) -> dict:
    """{"fwd" | "bwd": {shape: {plan: [device µs, ...]}}} of this tree's
    attention kernels at each plan of FWD_PLANS / BWD_PLANS."""
    from torched_impala_tpu_torch.ops import attention_cuda

    calls = attention_calls(device)
    plans: dict[str, dict[str, dict[str, list[float]]]] = {"fwd": {}, "bwd": {}}
    for kind, all_plans, tiles, job in (
        ("fwd", FWD_PLANS, "fwd_tiles", "attention_fwd_{}"),
        ("bwd", BWD_PLANS, "bwd_tiles", "attention_bwd_call_{}"),
    ):
        for shape, shape_plans in all_plans.items():
            kernel, fn = calls[job.format(shape)]
            for plan in shape_plans + shape_plans[::-1]:
                with _plan(attention_cuda, tiles, plan):
                    us = _device_us(fn, kernel)
                plans[kind].setdefault(shape, {}).setdefault(str(list(plan)), []).append(us)
    return plans


def _run_tree(root: Path) -> dict:
    """`measure()` in a fresh process whose imports resolve to `root`."""
    code = (
        "import json, runpy, sys; sys.path.insert(0, sys.argv[1]); "
        "print('MEASURE ' + json.dumps(runpy.run_path(sys.argv[2])['measure']()))"
    )
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run(
        [sys.executable, "-c", code, str(root), str(Path(__file__).resolve())],
        cwd=root, env=env, capture_output=True, text=True,
    )
    lines = [line for line in proc.stdout.splitlines() if line.startswith("MEASURE ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"measuring {root} failed (rc {proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1][len("MEASURE "):])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_builds: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    from torched_impala_tpu_torch import resolve_device

    trees = {"base": Path(argv[0]).resolve(), "this": THIS_ROOT}
    # The plans first, while this process is young (ops/profiling.py:
    # an older process's trace loses more of a window's first launches).
    plans = plan_sweeps(resolve_device())
    passes = [{"tree": label, **_run_tree(trees[label])} for label in ("base", "this", "this", "base")]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(json.dumps({"card": smi, "base": str(trees["base"]), "passes": passes,
                      "fwd_plans_device_us": plans["fwd"], "bwd_plans_device_us": plans["bwd"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
