"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each kernel is one `csrc/<name>.cu` with a plain C entry point. It is
compiled with nvcc for Hopper (`sm_90a`) into a shared library under
`build/torch_kernels/<sha>/` at the root of the checkout, where `<sha>`
hashes every file in `csrc/` and the compiler flags, so an edited source
never loads a stale library. The build happens at first use; a failed
build raises with the compiler's output.

Nothing here is imported or run unless a kernel is launched on a CUDA
tensor: the CPU paths never need nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _build(name: str) -> Path:
    lib = build_dir() / f"lib{name}.so"
    if lib.exists():
        return lib
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(f"no CUDA source for kernel {name!r}: {src}")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
    proc = subprocess.run(
        ["nvcc", *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name} (rc {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    # Atomic publish: a concurrent process never loads a partial file.
    os.replace(tmp, lib)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name)))
            _loaded[name] = lib
        return lib
