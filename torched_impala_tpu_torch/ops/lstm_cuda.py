"""Wrapper of the hand-written LSTM-cell CUDA kernel (`csrc/lstm_cell.cu`).

Replaces the Pallas TPU kernel `_lstm_forward` of
`torched_impala_tpu/ops/lstm_pallas.py` (kernel `_lstm_cell_kernel`).
The source's header note gives the design and the bound. Its plain
version is `ops/lstm.py:lstm_reference`.

The wrapper checks its inputs, allocates the outputs and launches on
PyTorch's current stream. It has no fallback: a CPU, non-f32 or
non-contiguous tensor, a wrong shape, a failed build or a refused launch
raises. `LAUNCHES` counts the launches this process made.
"""

from __future__ import annotations

import ctypes

import torch

from torched_impala_tpu_torch.ops import _build
from torched_impala_tpu_torch.ops._build import check_input

LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _library() -> ctypes.CDLL:
    lib = _build.load("lstm_cell")
    fn = lib.lstm_cell_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def lstm_cell_cuda(x, h, c, wi, wh, b):
    """(new_c, new_h, acts) on the card. Same contract as `lstm_reference`:
    x `[B, F]`, h, c `[B, H]`, wi `[F, 4H]`, wh `[H, 4H]`, b `[4H]`, f32."""
    global LAUNCHES
    if c.dim() != 2 or x.dim() != 2 or min(*c.shape, x.shape[1]) < 1:
        raise ValueError(
            f"lstm_cell_cuda: expected non-empty x [B, F] and c [B, H], got "
            f"{tuple(x.shape)} and {tuple(c.shape)}"
        )
    B, H = c.shape
    F = x.shape[1]
    device = c.device
    f32 = (torch.float32,)
    for name, t, shape in (
        ("x", x, (B, F)),
        ("h", h, (B, H)),
        ("c", c, (B, H)),
        ("wi", wi, (F, 4 * H)),
        ("wh", wh, (H, 4 * H)),
        ("b", b, (4 * H,)),
    ):
        check_input("lstm_cell_cuda", name, t, shape, f32, device)
    new_c = torch.empty((B, H), dtype=torch.float32, device=device)
    new_h = torch.empty((B, H), dtype=torch.float32, device=device)
    acts = torch.empty((B, 4 * H), dtype=torch.float32, device=device)
    rc = _library().lstm_cell_launch(
        *(t.data_ptr() for t in (x, h, c, wi, wh, b, new_c, new_h, acts)),
        B,
        F,
        H,
        device.index,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"lstm_cell_cuda: kernel launch failed with cudaError {rc}")
    LAUNCHES += 1
    return new_c, new_h, acts
