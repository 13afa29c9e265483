"""Time this checkout's LSTM-cell and attention kernels against the same
kernels built from another source tree, in turns on one card.

    python -m torched_impala_tpu_torch.ops.compare_builds BASE_CSRC

BASE_CSRC is another tree's `torched_impala_tpu_torch/csrc` (for example
a parent commit's, unpacked with `git archive <rev>
torched_impala_tpu_torch/csrc | tar -x -C DIR`). Its kernels must have
the same C entry points as this checkout's. Both trees are built by
`_build.build_all`, each under the hash of its own sources. Each kernel
is then timed by the profiler's device time (mean of 100 calls) at the
presets' shapes, in the order base, this, this, base, so that both
builds see the same card and clocks: the LSTM cell
at the Breakout learner's (B, F, H) = (32, 256, 256) and its actors'
(8, 256, 256), and the attention forward, dQ and dK/dV at the
pong_transformer learner's (B, T, H, dh, W) = (32, 21, 4, 64, 128).
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
ATTN_SHAPE = (32, 21, 4, 64, 128)  # B, T, H, dh, W
SOURCES = ("lstm_cell", "attention_fwd", "attention_bwd")
SIGNATURES = {
    "lstm_cell": {"lstm_cell_launch": lstm_cuda._ARGTYPES},
    **attention_cuda._SIGNATURES,
}
CALLS = 100


def load(csrc: Path) -> dict[str, ctypes.CDLL]:
    """The three kernels of `csrc`, built (`_build.build_all`) and loaded
    with their entry points' signatures."""
    libs = {}
    for name, path in _build.build_all(list(SOURCES), csrc).items():
        lib = ctypes.CDLL(str(path))
        for fn_name, argtypes in SIGNATURES[name].items():
            getattr(lib, fn_name).argtypes = argtypes
            getattr(lib, fn_name).restype = ctypes.c_int
        libs[name] = lib
    return libs


def device_us(fn, kernel: str) -> float:
    """Mean device µs a call of `fn` spends in kernels named `kernel`."""
    fn()
    us, _ = profiling.device_us(fn, calls=CALLS, name=kernel)
    if us is None:
        raise RuntimeError(f"the profiler saw no device time in {kernel}")
    return us


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with cudaError {rc}")


def workloads(device) -> dict:
    """name -> (kernel name, fn(libs)) for each timed launch. Each fn holds
    its tensors, so the pointers it passes stay valid."""
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

    B, T, H, dh, W = ATTN_SHAPE
    S = W + T
    q, k, v, g = f32(B, T, H, dh), f32(B, S, H, dh), f32(B, S, H, dh), f32(B, T, H, dh)
    seg_q = torch.ones(B, T, dtype=torch.int32, device=device)
    seg_ctx = torch.ones(B, S, dtype=torch.int32, device=device)
    out, lse = attention.windowed_attention_reference(q, k, v, seg_q, seg_ctx, W)
    dcap = attention.row_term(out, g)
    o, lse_out, dq, dk, dv = (torch.empty_like(t) for t in (q, lse, q, k, k))
    tail = (B, T, S, H, dh, W, dh**-0.5, 0, device.index, stream)
    fwd = (q, k, v, seg_q, seg_ctx, o, lse_out)
    bwd = (q, k, v, g, lse, dcap, seg_q, seg_ctx)

    def attention_call(source, entry, tensors):
        def call(libs):
            ptrs = [t.data_ptr() for t in tensors]
            _check(getattr(libs[source], entry)(*ptrs, *tail), entry)

        return call

    jobs["attention_fwd"] = ("attention_fwd_kernel", attention_call("attention_fwd", "attention_fwd_launch", fwd))
    jobs["attention_dq"] = ("attention_dq_kernel", attention_call("attention_bwd", "attention_dq_launch", (*bwd, dq)))
    jobs["attention_dkv"] = ("attention_dkv_kernel", attention_call("attention_bwd", "attention_dkv_launch", (*bwd, dk, dv)))
    return jobs


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
    for name, (kernel, fn) in workloads(device).items():
        for label in ("base", "this", "this", "base"):
            us = device_us(lambda: fn(libs[label]), kernel)
            times.setdefault(name, {}).setdefault(label, []).append(us)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(json.dumps({"card": smi, "base": str(trees["base"]), "device_us": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
