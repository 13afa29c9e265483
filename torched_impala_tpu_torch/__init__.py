"""torched_impala_tpu_torch: the PyTorch / CUDA port of torched_impala_tpu.

The JAX package `torched_impala_tpu` is the reference; this package grows
beside it slice by slice (ROADMAP.md) and never imports it, nor JAX.
The first slice is the Pong actor-learner loop: Nature-CNN torso with a
bf16 compute path, thread actors, a learner whose V-trace recursion runs
in a hand-written CUDA kernel (`ops/vtrace_cuda.py`, `csrc/vtrace.cu`).

Entry points run on the CUDA card unless the caller passes
`device="cpu"` (`device.resolve_device`); on the CPU every kernel's
plain PyTorch version runs instead.
"""

from torched_impala_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
