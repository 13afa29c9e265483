"""Wrapper of the hand-written residual-block CUDA kernels (`csrc/resblock.cu`).

Replaces the Pallas TPU kernel `_block_forward` of
`torched_impala_tpu/ops/conv_pallas.py` (kernel `_residual_block_kernel`).
The source's header note gives the design and the bound. Its plain
version is `ops/conv_block.py:block_reference`.

The wrapper takes the JAX layout: x NHWC `[N, H, W, C]` contiguous, f32
or bf16; k1, k2 HWIO `[3, 3, C, C]` and b1, b2 `[C]`, all f32 (the
kernels round the kernels to x's dtype as they stage them). x's dtype
picks the kernel: bf16 runs the wgmma implicit GEMM on the tensor cores,
launched by `bf16_launch_plan`; f32 runs the CUDA-core kernel, whose f32
products keep the JAX function's f32 numbers. Both stage a conv's whole
kernel in shared memory; a shape past what that holds (`route`) runs the
general kernel of the same source instead, in two launches and a scratch
of x's dtype, for either dtype and any C and W. It checks its inputs,
allocates the output and launches on PyTorch's current stream. It has no
fallback: a CPU, wrongly typed or non-contiguous tensor, a wrong shape, a
failed build or a refused launch raises. `LAUNCHES` counts the tuned
kernels' launches this process made, `GENERAL_LAUNCHES` the general
kernel's (one a block, for its two launches).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from torched_impala_tpu_torch.ops import _build
from torched_impala_tpu_torch.ops._build import check_input

LAUNCHES = 0
GENERAL_LAUNCHES = 0

SMEM_CEILING = 227 * 1024  # bytes a block may use; every launch sets it
SM_SMEM = 228 * 1024  # shared memory of one SM
BLOCK_RESERVED = 1024  # shared memory the card keeps for each resident block
SMS = 132  # H100 SXM streaming multiprocessors
# Padded channels up to which both bf16 kernels [3, 3, C, C] stay in shared
# memory and the kernel's launch bounds allow two blocks an SM; above it
# (up to MAX_CHANNELS) each conv's kernel is staged before that conv and
# one block takes an SM.
BOTH_KERNELS_CHANNELS = 64
MAX_CHANNELS = 80

_F32_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_BF16_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_GENERAL_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How the bf16 kernel covers an `[N, H, W, C]` input: `bands` bands
    of `rows` output rows an image (the last may be shorter), N x bands
    items walked by `blocks` persistent blocks, `resident` of them an SM,
    `smem_bytes` of shared memory a block, channels padded to
    `channels`."""

    rows: int
    bands: int
    blocks: int
    resident: int
    smem_bytes: int
    channels: int


def bf16_smem_bytes(rows: int, W: int, channels: int) -> int:
    """Shared memory of one block at band height `rows`, as the launcher
    works it out (`csrc/resblock.cu:bf16_smem_bytes`; the launch passes
    only `rows` and the grid): both kernels in bf16 (one above
    `BOTH_KERNELS_CHANNELS`), both biases in f32, a 16-byte trash row,
    the input band (rows + 4) x (W + 2) and the intermediate
    (rows + 2) x (W + 2) in bf16."""
    kernels = 2 if channels <= BOTH_KERNELS_CHANNELS else 1
    weights = kernels * 2 * 9 * channels * channels
    bands = 2 * (2 * rows + 6) * (W + 2) * channels
    return weights + 2 * 4 * channels + 16 + bands


def bf16_launch_plan(N: int, H: int, W: int, C: int) -> LaunchPlan:
    """The bf16 kernel's band height, grid and shared memory.

    As many blocks an SM as the launch bounds allow (two up to
    `BOTH_KERNELS_CHANNELS`) and a one-row band lets fit, each with the
    card's `BLOCK_RESERVED`; the tallest band that keeps them there
    (fewer halo rows computed twice), cut so there are at least `SMS`
    items where H allows (the actors' N = 8), then evened out over H; one
    block an item, up to `resident` x `SMS` blocks. Raises ValueError
    where C > 80 or a one-row band does not fit."""
    channels = -(-C // 16) * 16
    if channels > MAX_CHANNELS:
        raise ValueError(
            f"resblock_cuda: bf16 takes C <= {MAX_CHANNELS} (a conv's kernel "
            f"lives in shared memory), got C = {C}"
        )
    if bf16_smem_bytes(1, W, channels) > SMEM_CEILING:
        raise ValueError(f"resblock_cuda: W = {W} is too wide for one band of one row")
    most = 2 if channels <= BOTH_KERNELS_CHANNELS else 1
    resident = max(
        (k for k in range(1, most + 1)
         if k * (bf16_smem_bytes(1, W, channels) + BLOCK_RESERVED) <= SM_SMEM),
        default=1,
    )
    target = min(SMEM_CEILING, SM_SMEM // resident - BLOCK_RESERVED)
    fit = max(r for r in range(1, H + 1) if bf16_smem_bytes(r, W, channels) <= target)
    rows = min(fit, max(1, H // -(-SMS // N)))
    bands = -(-H // rows)
    rows = -(-H // bands)
    bands = -(-H // rows)
    blocks = min(N * bands, resident * SMS)
    return LaunchPlan(
        rows, bands, blocks, resident, bf16_smem_bytes(rows, W, channels), channels
    )


def f32_smem_bytes(rows: int, W: int, C: int) -> int:
    """Shared memory of the f32 kernel's block at band height `rows`
    (`csrc/resblock.cu:launch_f32`): both [3, 3, C, C] kernels, the input
    band (rows + 4) x (W + 2) and the intermediate (rows + 2) x (W + 2),
    all f32."""
    return (2 * 9 * C * C + (2 * rows + 6) * (W + 2) * C) * 4


def route(dtype: torch.dtype, W: int, C: int) -> str:
    """The kernel that takes an [N, H, W, C] block of `dtype`: "bf16" (the
    wgmma kernel) or "f32" (the CUDA-core kernel) where a band of one row
    and the conv kernels they stage fit a block's shared memory, else
    "general"."""
    if dtype == torch.bfloat16:
        channels = -(-C // 16) * 16
        fits = channels <= MAX_CHANNELS and bf16_smem_bytes(1, W, channels) <= SMEM_CEILING
        return "bf16" if fits else "general"
    return "f32" if f32_smem_bytes(1, W, C) <= SMEM_CEILING else "general"


def _library() -> ctypes.CDLL:
    lib = _build.load("resblock")
    for fn, argtypes in (
        (lib.resblock_f32_launch, _F32_ARGTYPES),
        (lib.resblock_bf16_launch, _BF16_ARGTYPES),
        (lib.resblock_general_launch, _GENERAL_ARGTYPES),
    ):
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def resblock_cuda(x, k1, b1, k2, b2):
    """The residual block on the card. Same contract as `block_reference`."""
    global LAUNCHES, GENERAL_LAUNCHES
    if x.dim() != 4 or min(x.shape) < 1:
        raise ValueError(
            f"resblock_cuda: x must be a non-empty NHWC [N, H, W, C], got "
            f"{tuple(x.shape)}"
        )
    N, H, W, C = x.shape
    device = x.device
    check_input(
        "resblock_cuda", "x", x, (N, H, W, C), (torch.float32, torch.bfloat16), device
    )
    f32 = (torch.float32,)
    for name, t, shape in (
        ("k1", k1, (3, 3, C, C)),
        ("b1", b1, (C,)),
        ("k2", k2, (3, 3, C, C)),
        ("b2", b2, (C,)),
    ):
        check_input("resblock_cuda", name, t, shape, f32, device)
    out = torch.empty_like(x)
    pointers = [t.data_ptr() for t in (x, k1, b1, k2, b2, out)]
    stream = torch.cuda.current_stream(device).cuda_stream
    lib = _library()
    kernel = route(x.dtype, W, C)
    if kernel == "general":
        y1 = torch.empty_like(x)
        rc = lib.resblock_general_launch(
            *pointers, y1.data_ptr(), N, H, W, C, int(x.dtype == torch.bfloat16),
            device.index, stream,
        )
    elif kernel == "bf16":
        plan = bf16_launch_plan(N, H, W, C)
        rc = lib.resblock_bf16_launch(
            *pointers, N, H, W, C, plan.rows, plan.blocks, device.index, stream,
        )
    else:
        rc = lib.resblock_f32_launch(*pointers, N, H, W, C, device.index, stream)
    if rc != 0:
        raise RuntimeError(f"resblock_cuda: kernel launch failed with cudaError {rc}")
    if kernel == "general":
        GENERAL_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out
