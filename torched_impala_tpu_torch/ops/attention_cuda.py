"""Wrappers of the hand-written windowed-attention CUDA kernels
(`csrc/attention_fwd.cu`, `csrc/attention_bwd.cu`, and
`csrc/attention_wide.cu` for head widths above MAX_HEAD_DIM).

Replace the Pallas TPU kernels of `torched_impala_tpu/ops/attention_pallas.py`:
`_forward` (kernel `_fwd_kernel`) and `_bwd_pallas` (both of its calls,
`_dq_kernel` and `_dkv_kernel`, and its D = sum_d O * dO), the backward
as one kernel that returns dq, dk and dv together. Both run their
products on the tensor cores, and each takes its tile plan from a pure
function here (`fwd_tiles`, `bwd_tiles`). The sources' header notes give
the designs and the bounds. The plain versions are
`ops/attention.py:windowed_attention_reference` and
`windowed_attention_backward_reference`.

The wrappers check their inputs, allocate the outputs (and the
backward's dQ scratch) and launch on PyTorch's current stream; neither
launches a PyTorch kernel of its own. They have no fallback: a CPU
tensor, a dtype other than float32 or bfloat16 (int32 for the segments,
float32 for the saved output and lse), a non-contiguous tensor, a failed
build or a refused launch raises. Every head width from 1 to
MAX_HEAD_DIM runs on the tiled tensor-core kernels: they are built at
padded widths and take the true one at run time. A wider head
(`takes_wide`) runs on the simple general kernels of
`csrc/attention_wide.cu`, one block a row, whose row vectors live in
shared memory (`wide_smem_bytes`); past what those rows fit it raises.
`LAUNCHES` counts the tiled wrappers' calls in this process ("fwd" and
"bwd"), `WIDE_LAUNCHES` the general kernels' ("fwd" and "bwd").
"""

from __future__ import annotations

import ctypes

import torch

from torched_impala_tpu_torch.ops import _build
from torched_impala_tpu_torch.ops._build import check_input

LAUNCHES = {"fwd": 0, "bwd": 0}
WIDE_LAUNCHES = {"fwd": 0, "bwd": 0}
# The widest instantiation of the tiled kernels (csrc/attention_common.cuh);
# wider heads take the general kernels of csrc/attention_wide.cu.
MAX_HEAD_DIM = 256
# The general kernels' block (csrc/attention_wide.cu:kThreads) and the
# shared memory a block may use.
WIDE_THREADS = 128
SMEM_CEILING = 232448
# The forward's tiles (csrc/attention_fwd.cu): a warp owns FWD_ROWS query
# rows and takes FWD_ROWS context slots a step; a block has at most
# FWD_MAX_WARPS warps, key_warps x query_groups x max(1, DP / 64), and
# owns query tiles of at most FWD_MAX_QUERY_GROUPS groups. Two groups and
# six key warps were the fastest of the plans timed at the learner's shape
# and at a long unroll (PERF.md §6).
FWD_ROWS = 16
FWD_MAX_WARPS = 12
FWD_MAX_QUERY_GROUPS = 2
# The backward's tiles (csrc/attention_bwd.cu): a warp owns BWD_ROWS key
# slots and BWD_ROWS rows of each query tile; a block has at most
# BWD_MAX_WARPS warps, key_warps x query_groups x max(1, DP / 64).
BWD_ROWS = 16
BWD_MAX_WARPS = 12
# Where one key tile cannot cover the context: its warps and query groups.
BWD_SPLIT = (4, 3)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "attention_fwd": {"attention_fwd_plan_launch": [_P] * 7 + [_I] * 8 + [_F, _I, _I, _P]},
    "attention_bwd": {"attention_bwd_launch": [_P] * 12 + [_I] * 8 + [_F, _I, _I, _P]},
    "attention_wide": {
        "attention_wide_fwd_launch": [_P] * 7 + [_I] * 6 + [_F, _I, _I, _P],
        "attention_wide_bwd_launch": [_P] * 12 + [_I] * 6 + [_F, _I, _I, _P],
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


def takes_wide(dh: int) -> bool:
    """Whether head width `dh` runs on the general kernels of
    csrc/attention_wide.cu (past the tiled kernels' MAX_HEAD_DIM)."""
    return dh > MAX_HEAD_DIM


def wide_smem_bytes(dh: int) -> dict[str, int]:
    """Shared memory of each general kernel's block at head width `dh`:
    the block sums' warp pairs, then the row vectors it keeps (forward: q
    and the accumulator; dq: q, dO and dq; dk/dv: k, v, dk and dv)."""
    pairs = WIDE_THREADS // 32 * 8
    return {"fwd": pairs + 2 * 4 * dh, "dq": pairs + 3 * 4 * dh, "dkv": pairs + 4 * 4 * dh}


def _check_wide(kernel: str, dh: int) -> None:
    if max(wide_smem_bytes(dh).values()) > SMEM_CEILING:
        raise ValueError(
            f"{kernel}: head width {dh} does not fit the general kernels' shared "
            f"memory ({max(wide_smem_bytes(dh).values())} > {SMEM_CEILING} bytes)"
        )


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _padded(dh: int) -> int:
    return next(p for p in (16, 32, 64, 128, 256) if dh <= p)


def fwd_tiles(T: int, S: int, dh: int) -> tuple[int, int]:
    """(key_warps, query_groups) of the forward: query tiles of FWD_ROWS x
    query_groups rows, as many groups as cover T up to
    FWD_MAX_QUERY_GROUPS (one tile, so K and V read once, where T <= 32),
    then as many key warps as the block has left for them, no more than
    the context's FWD_ROWS-slot tiles."""
    warps = FWD_MAX_WARPS // max(1, _padded(dh) // 64)
    query_groups = min(-(-T // FWD_ROWS), FWD_MAX_QUERY_GROUPS, warps)
    key_warps = max(1, min(-(-S // FWD_ROWS), warps // query_groups))
    return key_warps, query_groups


def attention_forward_cuda(q, k_ctx, v_ctx, seg_q, seg_ctx, W: int):
    """(out `[B, T, H, dh]` f32, lse `[B, H, T]` f32) on the card, one
    kernel at the tile plan of `fwd_tiles`. Same contract as
    `windowed_attention_reference`."""
    B, T, S, H, dh, bf16 = _check("attention_fwd", q, k_ctx, v_ctx, seg_q, seg_ctx, W)
    device = q.device
    if takes_wide(dh):
        return _wide_forward(q, k_ctx, v_ctx, seg_q, seg_ctx, W, B, T, S, H, dh, bf16)
    key_warps, query_groups = fwd_tiles(T, S, dh)
    out = torch.empty((B, T, H, dh), dtype=torch.float32, device=device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=device)
    rc = _library("attention_fwd").attention_fwd_plan_launch(
        *(t.data_ptr() for t in (q, k_ctx, v_ctx, seg_q, seg_ctx, out, lse)),
        B, T, S, H, dh, W, key_warps, query_groups, 1.0 / dh**0.5, bf16, device.index,
        _stream(device),
    )
    if rc != 0:
        raise RuntimeError(f"attention_fwd: kernel launch failed with cudaError {rc}")
    LAUNCHES["fwd"] += 1
    return out, lse


def bwd_tiles(S: int, dh: int) -> tuple[int, int]:
    """(key_warps, query_groups) of the backward: a key tile of BWD_ROWS x
    key_warps slots and query tiles of BWD_ROWS x query_groups rows. One key
    tile over the whole context where a block's warps cover it (no dQ
    shares to sum, no second launch), else BWD_SPLIT, within the warps a
    block has at this head width."""
    warps = BWD_MAX_WARPS // max(1, _padded(dh) // 64)
    whole = -(-S // BWD_ROWS)
    if whole <= warps:
        return whole, 1
    key_warps = min(BWD_SPLIT[0], warps)
    return key_warps, max(1, min(BWD_SPLIT[1], warps // key_warps))


def attention_backward_cuda(q, k_ctx, v_ctx, g, o, lse, seg_q, seg_ctx, W: int):
    """(dq, dk, dv), each f32, on the card: one kernel computes D from the
    saved f32 output `o`, P and dS once for each pair of a query tile and a
    key tile, and the three gradients; where the context takes more than
    one key tile, a second kernel adds the tiles' dQ shares. Same contract
    as `windowed_attention_backward_reference`."""
    kernel = "attention_bwd"
    B, T, S, H, dh, bf16 = _check(kernel, q, k_ctx, v_ctx, seg_q, seg_ctx, W)
    device = q.device
    check_input(kernel, "g", g, (B, T, H, dh), (q.dtype,), device)
    check_input(kernel, "o", o, (B, T, H, dh), (torch.float32,), device)
    check_input(kernel, "lse", lse, (B, H, T), (torch.float32,), device)
    if takes_wide(dh):
        return _wide_backward(q, k_ctx, v_ctx, g, o, lse, seg_q, seg_ctx, W, B, T, S, H, dh, bf16)
    key_warps, query_groups = bwd_tiles(S, dh)
    tiles = -(-S // (BWD_ROWS * key_warps))
    dq = torch.empty((B, T, H, dh), dtype=torch.float32, device=device)
    dk, dv = (torch.empty((B, S, H, dh), dtype=torch.float32, device=device) for _ in range(2))
    part = torch.empty((tiles, B, T, H, dh), dtype=torch.float32, device=device) if tiles > 1 else None
    rc = _library(kernel).attention_bwd_launch(
        *(t.data_ptr() for t in (q, k_ctx, v_ctx, g, o, lse, seg_q, seg_ctx, dq)),
        None if part is None else part.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, T, S, H, dh, W, key_warps, query_groups, 1.0 / dh**0.5, bf16, device.index,
        _stream(device),
    )
    if rc != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with cudaError {rc}")
    LAUNCHES["bwd"] += 1
    return dq, dk, dv


def _wide_forward(q, k_ctx, v_ctx, seg_q, seg_ctx, W, B, T, S, H, dh, bf16):
    """The forward on csrc/attention_wide.cu: one block a query row."""
    kernel = "attention_wide_fwd"
    _check_wide(kernel, dh)
    device = q.device
    out = torch.empty((B, T, H, dh), dtype=torch.float32, device=device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=device)
    rc = _library("attention_wide").attention_wide_fwd_launch(
        *(t.data_ptr() for t in (q, k_ctx, v_ctx, seg_q, seg_ctx, out, lse)),
        B, T, S, H, dh, W, 1.0 / dh**0.5, bf16, device.index, _stream(device),
    )
    if rc != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with cudaError {rc}")
    WIDE_LAUNCHES["fwd"] += 1
    return out, lse


def _wide_backward(q, k_ctx, v_ctx, g, o, lse, seg_q, seg_ctx, W, B, T, S, H, dh, bf16):
    """The backward on csrc/attention_wide.cu: dq (and D, into a scratch)
    one block a query row, then dk and dv one block a context slot."""
    kernel = "attention_wide_bwd"
    _check_wide(kernel, dh)
    device = q.device
    dq = torch.empty((B, T, H, dh), dtype=torch.float32, device=device)
    dk, dv = (torch.empty((B, S, H, dh), dtype=torch.float32, device=device) for _ in range(2))
    dcap = torch.empty((B, H, T), dtype=torch.float32, device=device)
    rc = _library("attention_wide").attention_wide_bwd_launch(
        *(t.data_ptr() for t in (q, k_ctx, v_ctx, g, o, lse, seg_q, seg_ctx, dq, dk, dv, dcap)),
        B, T, S, H, dh, W, 1.0 / dh**0.5, bf16, device.index, _stream(device),
    )
    if rc != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with cudaError {rc}")
    WIDE_LAUNCHES["bwd"] += 1
    return dq, dk, dv
