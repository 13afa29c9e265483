"""Wrapper of the hand-written fused-loss CUDA kernel (`csrc/fused_loss.cu`).

Replaces the Pallas TPU kernel `_fused_sums_kernel_call` of
`torched_impala_tpu/ops/vtrace_pallas.py` (kernel `_fused_loss_kernel`).
The source's header note gives the design (one thread per batch column,
per-block partial sums added in a fixed order) and the bound (launch
latency at the Pong shape). Its plain version is
`ops/fused_loss.py:fused_sums_reference`.

The wrapper checks its inputs, allocates the outputs and launches on
PyTorch's current stream. It has no fallback: a CPU, non-f32 or
non-contiguous tensor, a failed build or a refused launch raises.
`LAUNCHES` counts the launches this process made.
"""

from __future__ import annotations

import ctypes

import torch

from torched_impala_tpu_torch.ops import _build
from torched_impala_tpu_torch.ops._build import check_input
from torched_impala_tpu_torch.ops.fused_loss import FusedSums

LAUNCHES = 0

_ARGTYPES = (
    [ctypes.c_void_p] * 11
    + [ctypes.c_int, ctypes.c_int]
    + [ctypes.c_float] * 4
    + [ctypes.c_int, ctypes.c_void_p]
)


def _library() -> ctypes.CDLL:
    lib = _build.load("fused_loss")
    fn = lib.fused_loss_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.fused_loss_blocks.argtypes = [ctypes.c_int]
        lib.fused_loss_blocks.restype = ctypes.c_int
    return lib


def fused_sums_cuda(
    log_pi_a, ent, values, bootstrap, log_rhos, discounts, rewards, mask,
    *, clip_rho=1.0, clip_c=1.0, clip_pg_rho=1.0, lambda_=1.0,
) -> FusedSums:
    """The fused sums on the card. Same contract as `fused_sums_reference`."""
    global LAUNCHES
    if log_pi_a.dim() != 2 or min(log_pi_a.shape) < 1:
        raise ValueError(
            f"fused_sums_cuda: log_pi_a must be a non-empty [T, B], got "
            f"{tuple(log_pi_a.shape)}"
        )
    T, B = log_pi_a.shape
    device = log_pi_a.device
    tb = {
        "log_pi_a": log_pi_a,
        "ent": ent,
        "values": values,
        "log_rhos": log_rhos,
        "discounts": discounts,
        "rewards": rewards,
        "mask": mask,
    }
    f32 = (torch.float32,)
    for name, x in tb.items():
        check_input("fused_sums_cuda", name, x, (T, B), f32, device)
    check_input("fused_sums_cuda", "bootstrap", bootstrap, (B,), f32, device)
    # The outputs are targets and loss sums: no gradient flows through
    # the kernel (the autograd.Function's backward is closed-form).
    ins = [x.detach() for x in (log_pi_a, ent, values, bootstrap, log_rhos,
                                discounts, rewards, mask)]
    lib = _library()
    vs, adv = (torch.empty((T, B), dtype=torch.float32, device=device) for _ in range(2))
    partials = torch.empty(
        (lib.fused_loss_blocks(B), 3), dtype=torch.float32, device=device
    )
    rc = lib.fused_loss_launch(
        *(x.data_ptr() for x in ins),
        vs.data_ptr(),
        adv.data_ptr(),
        partials.data_ptr(),
        T,
        B,
        float(clip_rho),
        float(clip_c),
        float(clip_pg_rho),
        float(lambda_),
        device.index,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused_sums_cuda: kernel launch failed with cudaError {rc}")
    LAUNCHES += 1
    pg, bl, ent_sum = partials.sum(dim=0)
    return FusedSums(pg=pg, bl=bl, ent=ent_sum, vs=vs, adv=adv)
