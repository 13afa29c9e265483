"""Wrappers of the hand-written fused-loss CUDA kernels (`csrc/fused_loss.cu`).

Replace the Pallas TPU kernel `_fused_sums_kernel_call` of
`torched_impala_tpu/ops/vtrace_pallas.py` (kernel `_fused_loss_kernel`)
together with the XLA around it in `_fused_core_fwd` and
`_fused_core_bwd`. The source's header note gives the design (the
forward: clusters of 8 blocks, each a tile of the batch columns, one
cluster where B <= 64; rows of the logits by lane groups, the staged
V-trace, the sums in a fixed order across each cluster and then across
the clusters; the backward: one thread an element of the logit cube) and the bound (launch latency at the learner's shape). Their
plain versions are `ops/fused_loss.py:fused_core_reference` and
`fused_core_backward_reference`.

Each wrapper checks its inputs, allocates the outputs and launches on
PyTorch's current stream. They have no fallback: a CPU, mistyped or
non-contiguous tensor, a failed build or a refused launch raises.
`LAUNCHES` counts the launches this process made, by kernel.
"""

from __future__ import annotations

import ctypes

import torch

from torched_impala_tpu_torch.ops import _build
from torched_impala_tpu_torch.ops._build import check_input
from torched_impala_tpu_torch.ops.fused_loss import FusedCoreOut

LAUNCHES = {"fwd": 0, "bwd": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "fused_loss_fwd_launch": [_P] * 14 + [_I] * 3 + [_F] * 4 + [_I, _P],
    "fused_loss_bwd_launch": [_P] * 13 + [ctypes.c_long, _I, _I, _P],
}


def _library() -> ctypes.CDLL:
    lib = _build.load("fused_loss")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _check_cube(kernel: str, target_logits: torch.Tensor) -> tuple[int, int, int]:
    if target_logits.dim() != 3 or min(target_logits.shape) < 1:
        raise ValueError(
            f"{kernel}: target_logits must be a non-empty [T, B, A], got "
            f"{tuple(target_logits.shape)}"
        )
    return tuple(target_logits.shape)


def _launch(name: str, kernel: str, *args) -> None:
    rc = getattr(_library(), name)(*args)
    if rc != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with cudaError {rc}")


def fused_loss_fwd(
    target_logits, behaviour_logits, actions, values, bootstrap, discounts, rewards, mask,
    *, clip_rho=1.0, clip_c=1.0, clip_pg_rho=1.0, lambda_=1.0,
) -> FusedCoreOut:
    """The fused loss's forward on the card. Same contract as
    `fused_core_reference`."""
    T, B, A = _check_cube("fused_loss_fwd", target_logits)
    device = target_logits.device
    f32 = (torch.float32,)
    for name, x in (("target_logits", target_logits), ("behaviour_logits", behaviour_logits)):
        check_input("fused_loss_fwd", name, x, (T, B, A), f32, device)
    check_input("fused_loss_fwd", "actions", actions, (T, B), (torch.int64,), device)
    for name, x in (("values", values), ("discounts", discounts), ("rewards", rewards),
                    ("mask", mask)):
        check_input("fused_loss_fwd", name, x, (T, B), f32, device)
    check_input("fused_loss_fwd", "bootstrap", bootstrap, (B,), f32, device)
    # The outputs are targets, loss sums and residuals: the Function's
    # backward is the other kernel.
    ins = [x.detach() for x in (target_logits, behaviour_logits, actions, values, bootstrap,
                                discounts, rewards, mask)]
    vs, adv, lse, ent = (torch.empty((T, B), dtype=torch.float32, device=device)
                         for _ in range(4))
    sums = torch.empty((5,), dtype=torch.float32, device=device)
    # Each cluster's five sums where B takes more than one (at most one
    # cluster per 64 columns), added in order by the launch's fold kernel.
    partials = torch.empty((-(-B // 64), 5), dtype=torch.float32, device=device)
    _launch(
        "fused_loss_fwd_launch", "fused_loss_fwd",
        *(x.data_ptr() for x in (*ins, vs, adv, lse, ent, sums, partials)),
        T, B, A,
        float(clip_rho), float(clip_c), float(clip_pg_rho), float(lambda_),
        device.index, torch.cuda.current_stream(device).cuda_stream,
    )
    LAUNCHES["fwd"] += 1
    return FusedCoreOut(sums=sums, vs=vs, adv=adv, lse=lse, ent=ent)


def fused_loss_bwd(
    target_logits, lse, ent, adv, vs, values, mask, actions, g_pg, g_bl, g_ent,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused loss's backward on the card: (dL/dz, dL/dvalues). Same
    contract as `fused_core_backward_reference`; the three cotangents are
    0-dim f32 tensors on the card, read there (no host sync)."""
    T, B, A = _check_cube("fused_loss_bwd", target_logits)
    device = target_logits.device
    f32 = (torch.float32,)
    check_input("fused_loss_bwd", "target_logits", target_logits, (T, B, A), f32, device)
    for name, x in (("lse", lse), ("ent", ent), ("adv", adv), ("vs", vs), ("values", values),
                    ("mask", mask)):
        check_input("fused_loss_bwd", name, x, (T, B), f32, device)
    check_input("fused_loss_bwd", "actions", actions, (T, B), (torch.int64,), device)
    for name, g in (("g_pg", g_pg), ("g_bl", g_bl), ("g_ent", g_ent)):
        check_input("fused_loss_bwd", name, g, (), f32, device)
    ins = [x.detach() for x in (target_logits, lse, ent, adv, vs, values, mask, actions,
                                g_pg, g_bl, g_ent)]
    g_z = torch.empty((T, B, A), dtype=torch.float32, device=device)
    g_values = torch.empty((T, B), dtype=torch.float32, device=device)
    _launch(
        "fused_loss_bwd_launch", "fused_loss_bwd",
        *(x.data_ptr() for x in (*ins, g_z, g_values)),
        T * B, A, device.index, torch.cuda.current_stream(device).cuda_stream,
    )
    LAUNCHES["bwd"] += 1
    return g_z, g_values
