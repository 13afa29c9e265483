"""Device selection and the float32 precision settings of the port.

`resolve_device` is the one place an entry point turns its `device`
argument into a `torch.device`. It never falls back: asking for the card
(the default) on a host without CUDA raises, so a run that was meant for
the GPU cannot quietly measure the CPU.

TF32. On the card cuDNN runs float32 convolutions in TF32 by default
(`torch.backends.cudnn.allow_tf32 = True`), while float32 matmuls run in
full float32 (`torch.backends.cuda.matmul.allow_tf32 = False`). The port
sets BOTH to False here: its float32 path is held to the JAX package's
float32 numbers (tests/test_torch_port_*.py, chip_smoke.py), and TF32
keeps about three decimal digits. The bf16 torso does not use TF32 at
all, so the Pong preset's speed is unaffected by this choice.
"""

from __future__ import annotations

import torch


def configure_precision() -> dict:
    """Turn TF32 off for float32 convolutions and matmuls (module
    docstring) and return the settings now in force."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return {
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
    }


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` or a `cuda` device -> that CUDA device (raises when CUDA is
    absent); `"cpu"` -> the CPU, where kernels run their plain versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    configure_precision()
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
