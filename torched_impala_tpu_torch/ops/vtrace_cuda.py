"""Wrapper of the hand-written V-trace CUDA kernel (`csrc/vtrace.cu`).

Replaces the Pallas TPU kernel `vtrace_pallas` of
`torched_impala_tpu/ops/vtrace_pallas.py` (kernel `_vtrace_kernel`). The
source's header note gives the design (one thread per batch column, the
reverse recursion in registers) and the bound (launch latency at the
Pong shape). Its plain version is `ops/vtrace.py:vtrace_reference`.

The wrapper checks its inputs, allocates the outputs and launches on
PyTorch's current stream. It has no fallback: a CPU, non-f32 or
non-contiguous tensor, a failed build or a refused launch raises.
`LAUNCHES` counts the launches this process made.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from torched_impala_tpu_torch.ops import _build
from torched_impala_tpu_torch.ops._build import check_input
from torched_impala_tpu_torch.ops.vtrace import VTraceOutput, threshold

LAUNCHES = 0

_ARGTYPES = (
    [ctypes.c_void_p] * 8
    + [ctypes.c_int, ctypes.c_int]
    + [ctypes.c_float] * 4
    + [ctypes.c_int, ctypes.c_void_p]
)


def _library() -> ctypes.CDLL:
    lib = _build.load("vtrace")
    fn = lib.vtrace_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def vtrace_cuda(
    *,
    log_rhos: torch.Tensor,
    discounts: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    clip_rho_threshold: Optional[float] = 1.0,
    clip_c_threshold: Optional[float] = 1.0,
    clip_pg_rho_threshold: Optional[float] = 1.0,
    lambda_: float = 1.0,
) -> VTraceOutput:
    """V-trace on the card. Same contract as `vtrace_reference`."""
    global LAUNCHES
    if log_rhos.dim() != 2 or min(log_rhos.shape) < 1:
        raise ValueError(
            f"vtrace_cuda: log_rhos must be a non-empty [T, B], got "
            f"{tuple(log_rhos.shape)}"
        )
    T, B = log_rhos.shape
    device = log_rhos.device
    inputs = {
        "log_rhos": log_rhos,
        "discounts": discounts,
        "rewards": rewards,
        "values": values,
    }
    f32 = (torch.float32,)
    for name, x in inputs.items():
        check_input("vtrace_cuda", name, x, (T, B), f32, device)
    check_input("vtrace_cuda", "bootstrap_value", bootstrap_value, (B,), f32, device)
    # The outputs are targets: no gradient flows through the kernel.
    ins = [x.detach() for x in (*inputs.values(), bootstrap_value)]
    vs, pg, err = (torch.empty((T, B), dtype=torch.float32, device=device) for _ in range(3))
    lib = _library()
    rc = lib.vtrace_launch(
        *(x.data_ptr() for x in ins),
        vs.data_ptr(),
        pg.data_ptr(),
        err.data_ptr(),
        T,
        B,
        threshold(clip_rho_threshold),
        threshold(clip_c_threshold),
        threshold(clip_pg_rho_threshold),
        float(lambda_),
        device.index,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"vtrace_cuda: kernel launch failed with cudaError {rc}")
    LAUNCHES += 1
    return VTraceOutput(vs=vs, pg_advantages=pg, errors=err)
