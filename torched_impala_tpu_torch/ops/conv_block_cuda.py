"""Wrapper of the hand-written residual-block CUDA kernel (`csrc/resblock.cu`).

Replaces the Pallas TPU kernel `_block_forward` of
`torched_impala_tpu/ops/conv_pallas.py` (kernel `_residual_block_kernel`).
The source's header note gives the design and the bound. Its plain
version is `ops/conv_block.py:block_reference`.

The wrapper takes the JAX layout: x NHWC `[N, H, W, C]` contiguous, f32
or bf16; k1, k2 HWIO `[3, 3, C, C]` and b1, b2 `[C]`, all f32 (the
kernel rounds the kernels to x's dtype as it stages them). It checks its
inputs, allocates the output and launches on PyTorch's current stream.
It has no fallback: a CPU, wrongly typed or non-contiguous tensor, a
wrong shape, a failed build or a refused launch raises. `LAUNCHES` counts
the launches this process made.
"""

from __future__ import annotations

import ctypes

import torch

from torched_impala_tpu_torch.ops import _build
from torched_impala_tpu_torch.ops._build import check_input

LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _library() -> ctypes.CDLL:
    lib = _build.load("resblock")
    fn = lib.resblock_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def resblock_cuda(x, k1, b1, k2, b2):
    """The residual block on the card. Same contract as `block_reference`."""
    global LAUNCHES
    if x.dim() != 4 or min(x.shape) < 1:
        raise ValueError(
            f"resblock_cuda: x must be a non-empty NHWC [N, H, W, C], got "
            f"{tuple(x.shape)}"
        )
    N, H, W, C = x.shape
    device = x.device
    check_input("resblock_cuda", "x", x, (N, H, W, C), tuple(_DTYPE_CODES), device)
    f32 = (torch.float32,)
    for name, t, shape in (
        ("k1", k1, (3, 3, C, C)),
        ("b1", b1, (C,)),
        ("k2", k2, (3, 3, C, C)),
        ("b2", b2, (C,)),
    ):
        check_input("resblock_cuda", name, t, shape, f32, device)
    out = torch.empty_like(x)
    rc = _library().resblock_launch(
        *(t.data_ptr() for t in (x, k1, b1, k2, b2, out)),
        N,
        H,
        W,
        C,
        _DTYPE_CODES[x.dtype],
        device.index,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"resblock_cuda: kernel launch failed with cudaError {rc}")
    LAUNCHES += 1
    return out
