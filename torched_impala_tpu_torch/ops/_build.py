"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each kernel is one `csrc/<name>.cu` with a plain C entry point. It is
compiled with nvcc for Hopper (`sm_90a`) into a shared library under
`build/torch_kernels/<sha>/` at the root of the checkout, where `<sha>`
hashes every file in `csrc/` and the compiler flags, so an edited source
never loads a stale library. The build happens at first use; a failed
build raises with the compiler's output. `build_all` starts one nvcc per
source, all at once, and waits for them together.

Nothing here is imported or run unless a kernel is launched on a CUDA
tensor: the CPU paths never need nvcc. `check_input` is the wrappers'
shared check of what a kernel takes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
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


def kernel_names() -> list[str]:
    """Every kernel that has a source in `csrc/`, sorted."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_dir(csrc: Path = CSRC) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(csrc.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all(names: list[str], csrc: Path = CSRC) -> dict[str, Path]:
    """Compile every kernel of `names` from `csrc` not built yet, one nvcc
    process per source, all running at once; return each kernel's library
    path. Another tree's sources (`csrc`) build beside this checkout's,
    under the hash of that tree."""
    out_dir = build_dir(csrc)
    libs = {name: out_dir / f"lib{name}.so" for name in names}
    running = []
    for name, lib in libs.items():
        if lib.exists():
            continue
        src = csrc / f"{name}.cu"
        if not src.exists():
            raise FileNotFoundError(f"no CUDA source for kernel {name!r}: {src}")
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
        proc = subprocess.Popen(
            ["nvcc", *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        running.append((name, lib, tmp, proc))
    failures = []
    for name, lib, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name} (rc {proc.returncode}):\n{log}")
        else:
            # Atomic publish: a concurrent process never loads a partial file.
            os.replace(tmp, lib)
    if failures:
        raise RuntimeError("\n".join(failures))
    return libs


def check_input(kernel: str, name: str, t, shape: tuple, dtypes, device) -> None:
    """Raise unless `t` is a contiguous CUDA tensor on `device` with this
    shape and one of `dtypes` (shared by the port's kernel wrappers)."""
    if not t.is_cuda:
        raise ValueError(f"{kernel}: {name} must be a CUDA tensor, got {t.device}")
    if t.device != device:
        raise ValueError(f"{kernel}: {name} on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise ValueError(f"{kernel}: {name} must be {names}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{kernel}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _loaded[name] = lib
        return lib


def sass_counts(name: str, opcode: str) -> dict[str, int]:
    """How many `opcode` instructions (e.g. "HGMMA") each function of the
    built library of kernel `name` holds, by mangled function name."""
    lib = build_all([name])[name]
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run(
        [tool, "-sass", str(lib)], capture_output=True, text=True, check=True
    ).stdout
    counts: dict[str, int] = {}
    function = None
    for line in sass.splitlines():
        if "Function :" in line:
            function = line.split("Function :", 1)[1].strip()
            counts[function] = 0
        elif function is not None and opcode in line:
            counts[function] += 1
    return counts
