"""Wrappers of the hand-written windowed-attention CUDA kernels
(`csrc/attention_fwd.cu`, `csrc/attention_bwd.cu`).

Replace the Pallas TPU kernels of `torched_impala_tpu/ops/attention_pallas.py`:
`_forward` (kernel `_fwd_kernel`) and the two calls of `_bwd_pallas`
(`_dq_kernel`, `_dkv_kernel`). The sources' header notes give the
designs and the bounds. The plain versions are
`ops/attention.py:windowed_attention_reference`, `attention_dq_reference`
and `attention_dkv_reference`.

The wrappers check their inputs, allocate the outputs and launch on
PyTorch's current stream. They have no fallback: a CPU tensor, a dtype
other than float32 or bfloat16 (int32 for the segments), a head width
other than 16, 32 or 64, a non-contiguous tensor, a failed build or a
refused launch raises. `LAUNCHES` counts each kernel's launches in this
process: "fwd", "dq" and "dkv", one per wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from torched_impala_tpu_torch.ops import _build
from torched_impala_tpu_torch.ops._build import check_input
from torched_impala_tpu_torch.ops.attention import row_term

LAUNCHES = {"fwd": 0, "dq": 0, "dkv": 0}
HEAD_DIMS = (16, 32, 64)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "attention_fwd": {"attention_fwd_launch": [_P] * 7 + [_I] * 6 + [_F, _I, _I, _P]},
    "attention_bwd": {
        "attention_dq_launch": [_P] * 9 + [_I] * 6 + [_F, _I, _I, _P],
        "attention_dkv_launch": [_P] * 10 + [_I] * 6 + [_F, _I, _I, _P],
    },
}


def _library(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    for fn_name, argtypes in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _check(kernel: str, q, k_ctx, v_ctx, seg_q, seg_ctx, W: int):
    """Check the operands both kernels share; return (B, T, S, H, dh,
    is_bf16)."""
    if q.dim() != 4 or k_ctx.dim() != 4 or min(q.shape) < 1 or k_ctx.shape[1] < 1:
        raise ValueError(
            f"{kernel}: expected non-empty q [B, T, H, dh] and k_ctx [B, S, H, dh], "
            f"got {tuple(q.shape)} and {tuple(k_ctx.shape)}"
        )
    B, T, H, dh = q.shape
    S = k_ctx.shape[1]
    if dh not in HEAD_DIMS:
        raise ValueError(f"{kernel}: head width {dh} not in {HEAD_DIMS}")
    if not 0 <= W <= S:
        raise ValueError(f"{kernel}: W={W} outside [0, S={S}]")
    device = q.device
    check_input(kernel, "q", q, (B, T, H, dh), (torch.float32, torch.bfloat16), device)
    for name, t, shape, dtypes in (
        ("k_ctx", k_ctx, (B, S, H, dh), (q.dtype,)),
        ("v_ctx", v_ctx, (B, S, H, dh), (q.dtype,)),
        ("seg_q", seg_q, (B, T), (torch.int32,)),
        ("seg_ctx", seg_ctx, (B, S), (torch.int32,)),
    ):
        check_input(kernel, name, t, shape, dtypes, device)
    return B, T, S, H, dh, int(q.dtype == torch.bfloat16)


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def attention_forward_cuda(q, k_ctx, v_ctx, seg_q, seg_ctx, W: int):
    """(out `[B, T, H, dh]` f32, lse `[B, H, T]` f32) on the card. Same
    contract as `windowed_attention_reference`."""
    B, T, S, H, dh, bf16 = _check("attention_fwd", q, k_ctx, v_ctx, seg_q, seg_ctx, W)
    device = q.device
    out = torch.empty((B, T, H, dh), dtype=torch.float32, device=device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=device)
    rc = _library("attention_fwd").attention_fwd_launch(
        *(t.data_ptr() for t in (q, k_ctx, v_ctx, seg_q, seg_ctx, out, lse)),
        B, T, S, H, dh, W, 1.0 / dh**0.5, bf16, device.index, _stream(device),
    )
    if rc != 0:
        raise RuntimeError(f"attention_fwd: kernel launch failed with cudaError {rc}")
    LAUNCHES["fwd"] += 1
    return out, lse


def _backward_args(kernel, q, k_ctx, v_ctx, g, lse, dcap, seg_q, seg_ctx, W):
    B, T, S, H, dh, bf16 = _check(kernel, q, k_ctx, v_ctx, seg_q, seg_ctx, W)
    device = q.device
    check_input(kernel, "g", g, (B, T, H, dh), (q.dtype,), device)
    check_input(kernel, "lse", lse, (B, H, T), (torch.float32,), device)
    check_input(kernel, "dcap", dcap, (B, T, H), (torch.float32,), device)
    ptrs = [t.data_ptr() for t in (q, k_ctx, v_ctx, g, lse, dcap, seg_q, seg_ctx)]
    tail = (B, T, S, H, dh, W, 1.0 / dh**0.5, bf16, device.index, _stream(device))
    return (B, T, S, H, dh), ptrs, tail


def attention_dq_cuda(q, k_ctx, v_ctx, g, lse, dcap, seg_q, seg_ctx, W: int):
    """dq `[B, T, H, dh]` f32 on the card. Same contract as
    `attention_dq_reference`."""
    (B, T, S, H, dh), ptrs, tail = _backward_args(
        "attention_dq", q, k_ctx, v_ctx, g, lse, dcap, seg_q, seg_ctx, W
    )
    dq = torch.empty((B, T, H, dh), dtype=torch.float32, device=q.device)
    rc = _library("attention_bwd").attention_dq_launch(*ptrs, dq.data_ptr(), *tail)
    if rc != 0:
        raise RuntimeError(f"attention_dq: kernel launch failed with cudaError {rc}")
    LAUNCHES["dq"] += 1
    return dq


def attention_dkv_cuda(q, k_ctx, v_ctx, g, lse, dcap, seg_q, seg_ctx, W: int):
    """(dk, dv) `[B, S, H, dh]` f32 on the card. Same contract as
    `attention_dkv_reference`."""
    (B, T, S, H, dh), ptrs, tail = _backward_args(
        "attention_dkv", q, k_ctx, v_ctx, g, lse, dcap, seg_q, seg_ctx, W
    )
    dk, dv = (torch.empty((B, S, H, dh), dtype=torch.float32, device=q.device) for _ in range(2))
    rc = _library("attention_bwd").attention_dkv_launch(
        *ptrs, dk.data_ptr(), dv.data_ptr(), *tail
    )
    if rc != 0:
        raise RuntimeError(f"attention_dkv: kernel launch failed with cudaError {rc}")
    LAUNCHES["dkv"] += 1
    return dk, dv


def attention_backward_cuda(q, k_ctx, v_ctx, g, o, lse, seg_q, seg_ctx, W: int):
    """(dq, dk, dv), each f32, on the card: D from the saved output, then
    the dQ kernel and the dK/dV kernel. Same contract as
    `windowed_attention_backward_reference`."""
    args = (q, k_ctx, v_ctx, g, lse, row_term(o, g), seg_q, seg_ctx, W)
    return (attention_dq_cuda(*args), *attention_dkv_cuda(*args))
