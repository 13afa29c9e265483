"""Time this checkout's LSTM-cell and attention kernels against the same
kernels built from another source tree, in turns on one card.

    python -m torched_impala_tpu_torch.ops.compare_builds BASE_CSRC

BASE_CSRC is another tree's `torched_impala_tpu_torch/csrc` (for example
a parent commit's, unpacked with `git archive <rev>
torched_impala_tpu_torch/csrc | tar -x -C DIR`). Both trees are built by
`_build.build_all`, each under the hash of its own sources. Each workload
is timed by the profiler's device time (mean of 100 calls) in the order
base, this, this, base, so that both builds see the same card and clocks:
the LSTM cell at the Breakout learner's (B, F, H) = (32, 256, 256) and
its actors' (8, 256, 256); the attention forward kernel; and one attention
backward call with every kernel inside it summed, at the pong_transformer
learner's (B, T, H, dh, W) = (32, 21, 4, 64, 128) and at a long unroll
(2, 1024, 4, 64, 128), f32, every slot of the same episode; and the
forward again at the learner's shape on ragged episodes (resets
mid-unroll, a cache partly of an older episode or empty), where masked
fragments are skipped. A tree whose library exports
`attention_fwd_plan_launch` runs the forward at `fwd_tiles`' plan; an
older tree's `attention_fwd_launch` takes no plan. A tree whose library
exports `attention_bwd_launch` makes one backward call through it; an
older tree's call is D = `attention.row_term(o, dO)` in PyTorch, then its
`attention_dq_launch` and `attention_dkv_launch`. Then this tree's
forward alone at each tile plan of FWD_PLANS and its backward alone at
each plan of BWD_PLANS, twice each (the plans in order, then reversed).
Prints one JSON line with the card's name and power limit. Without a
CUDA card it exits 2 and prints no result.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from torched_impala_tpu_torch.ops import _build, attention, attention_cuda, lstm_cuda, profiling

LSTM_SHAPES = [(32, 256, 256), (8, 256, 256)]  # B, F, H
ATTN_SHAPES = {"learner": (32, 21, 4, 64, 128), "long": (2, 1024, 4, 64, 128)}  # B, T, H, dh, W
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
SOURCES = ("lstm_cell", "attention_fwd", "attention_bwd")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Every entry point either tree may export: this tree's, the forward of
# the trees before it took a tile plan, and the two backward kernels of
# the trees before the backward was one kernel.
SIGNATURES = {
    "lstm_cell_launch": lstm_cuda._ARGTYPES,
    **{fn: args for entries in attention_cuda._SIGNATURES.values() for fn, args in entries.items()},
    "attention_fwd_launch": [_P] * 7 + [_I] * 6 + [_F, _I, _I, _P],
    "attention_dq_launch": [_P] * 9 + [_I] * 6 + [_F, _I, _I, _P],
    "attention_dkv_launch": [_P] * 10 + [_I] * 6 + [_F, _I, _I, _P],
}
CALLS = 100


def load(csrc: Path) -> dict[str, ctypes.CDLL]:
    """The three kernels of `csrc`, built (`_build.build_all`) and loaded
    with the signatures of the entry points they export."""
    libs = {}
    for name, path in _build.build_all(list(SOURCES), csrc).items():
        lib = ctypes.CDLL(str(path))
        for fn_name, argtypes in SIGNATURES.items():
            if hasattr(lib, fn_name):
                getattr(lib, fn_name).argtypes = argtypes
                getattr(lib, fn_name).restype = ctypes.c_int
        libs[name] = lib
    return libs


def device_us(fn, kernel: str | None) -> float:
    """Mean device µs a call of `fn` spends in kernels named `kernel` (in
    every kernel it launches when `kernel` is None)."""
    fn()
    us, _ = profiling.device_us(fn, calls=CALLS, name=kernel)
    if us is None:
        raise RuntimeError(f"the profiler saw no device time in {kernel}")
    return us


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with cudaError {rc}")


def workloads(device) -> dict:
    """name -> (kernel name, fn(libs)) for each timed call; a kernel name
    of None times every kernel the call launches. Each fn holds its
    tensors, so the pointers it passes stay valid."""
    rng = np.random.default_rng(0)

    def f32(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(device)

    stream = torch.cuda.current_stream(device).cuda_stream
    jobs = {}
    for B, F, H in LSTM_SHAPES:
        args = [f32(B, F), f32(B, H), f32(B, H), f32(F, 4 * H, scale=F**-0.5),
                f32(H, 4 * H, scale=H**-0.5), f32(4 * H, scale=0.1)]
        outs = [torch.empty(B, H, device=device), torch.empty(B, H, device=device),
                torch.empty(B, 4 * H, device=device)]

        def lstm_call(libs, tensors=args + outs, B=B, F=F, H=H):
            ptrs = [t.data_ptr() for t in tensors]
            _check(libs["lstm_cell"].lstm_cell_launch(*ptrs, B, F, H, device.index, stream), "lstm_cell")

        jobs[f"lstm_cell_{B}x{F}x{H}"] = ("lstm_cell_kernel", lstm_call)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

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
        out, lse = attention.windowed_attention_reference(q, k, v, seg_q, seg_ctx, W)
        o, lse_out, dq, dk, dv = (torch.empty_like(t) for t in (q, lse, q, k, k))
        tail = (B, T, S, H, dh, W)
        launch_tail = (dh**-0.5, 0, device.index, stream)

        def fwd_call(libs, plan=None, tensors=(q, k, v, seg_q, seg_ctx, o, lse_out), tail=tail,
                     launch_tail=launch_tail):
            lib = libs["attention_fwd"]
            ptrs = [t.data_ptr() for t in tensors]
            if hasattr(lib, "attention_fwd_plan_launch"):
                plan = plan or attention_cuda.fwd_tiles(tail[1], tail[2], tail[4])
                rc = lib.attention_fwd_plan_launch(*ptrs, *tail, *plan, *launch_tail)
            else:
                rc = lib.attention_fwd_launch(*ptrs, *tail, *launch_tail)
            _check(rc, "attention_fwd")

        jobs[f"attention_fwd_{label}"] = ("attention_fwd_kernel", fwd_call)
        if ragged:
            continue

        def bwd_call(libs, plan=None, tensors=(q, k, v, g, out, lse, seg_q, seg_ctx), tail=tail,
                     launch_tail=launch_tail, outs=(dq, dk, dv), S=S):
            lib = libs["attention_bwd"]
            if hasattr(lib, "attention_bwd_launch"):
                key_warps, query_groups = plan or attention_cuda.bwd_tiles(S, tail[4])
                tiles = -(-S // (attention_cuda.BWD_ROWS * key_warps))
                part = torch.empty((tiles, *outs[0].shape), device=device) if tiles > 1 else None
                ptrs = [t.data_ptr() for t in (*tensors, outs[0])]
                rc = lib.attention_bwd_launch(
                    *ptrs, None if part is None else part.data_ptr(), outs[1].data_ptr(),
                    outs[2].data_ptr(), *tail, key_warps, query_groups, *launch_tail,
                )
                _check(rc, "attention_bwd")
                return
            q_, k_, v_, g_, o_, lse_, segq_, segc_ = tensors
            dcap = attention.row_term(o_, g_)
            ptrs = [t.data_ptr() for t in (q_, k_, v_, g_, lse_, dcap, segq_, segc_)]
            _check(lib.attention_dq_launch(*ptrs, outs[0].data_ptr(), *tail, *launch_tail), "attention_dq")
            _check(lib.attention_dkv_launch(*ptrs, outs[1].data_ptr(), outs[2].data_ptr(), *tail,
                                            *launch_tail), "attention_dkv")

        jobs[f"attention_bwd_call_{label}"] = (None, bwd_call)
    return jobs


def ragged_segments(rng, B: int, T: int, W: int):
    """(seg_q [B, T], seg_ctx [B, W + T]) of episodes that reset
    mid-unroll, with a cache whose slots are of this episode, of an older
    one, or empty (-1)."""
    base = rng.integers(1, 4, size=(B, 1))
    seg_q = base + np.cumsum(rng.uniform(size=(B, T)) < 4.0 / max(T, 4), axis=1)
    cache = np.where(rng.uniform(size=(B, W)) < 0.6, base, rng.choice([-1, 0], size=(B, W)))
    return seg_q, np.concatenate([cache, seg_q], axis=1)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_builds: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    from torched_impala_tpu_torch import resolve_device

    device = resolve_device()
    trees = {"base": Path(argv[0]), "this": _build.CSRC}
    libs = {label: load(csrc) for label, csrc in trees.items()}
    times: dict[str, dict[str, list[float]]] = {}
    jobs = workloads(device)
    for name, (kernel, fn) in jobs.items():
        for label in ("base", "this", "this", "base"):
            us = device_us(lambda: fn(libs[label]), kernel)
            times.setdefault(name, {}).setdefault(label, []).append(us)
    plans: dict[str, dict[str, dict[str, list[float]]]] = {"fwd": {}, "bwd": {}}
    for kind, all_plans, job, kernel in (
        ("fwd", FWD_PLANS, "attention_fwd_{}", "attention_fwd_kernel"),
        ("bwd", BWD_PLANS, "attention_bwd_call_{}", None),
    ):
        for shape, shape_plans in all_plans.items():
            _, fn = jobs[job.format(shape)]
            for plan in shape_plans + shape_plans[::-1]:
                us = device_us(lambda: fn(libs["this"], plan), kernel)
                plans[kind].setdefault(shape, {}).setdefault(str(list(plan)), []).append(us)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(json.dumps({"card": smi, "base": str(trees["base"]), "device_us": times,
                      "fwd_plans_device_us": plans["fwd"], "bwd_plans_device_us": plans["bwd"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
