"""torched_impala_tpu_torch: the PyTorch / CUDA port of torched_impala_tpu.

The JAX package `torched_impala_tpu` is the reference; this package grows
beside it slice by slice (ROADMAP.md) and never imports it, nor JAX.
It trains the Pong preset (Nature-CNN, bf16 torso) and the Breakout
preset (IMPALA deep ResNet, bf16 torso, LSTM core with episode resets)
with thread actors and a learner on the card. Three TPU kernels run as
hand-written CUDA kernels (`csrc/`): the V-trace recursion
(`ops/vtrace_cuda.py`), the fused LSTM cell (`ops/lstm_cuda.py`) and the
fused residual block (`ops/conv_block_cuda.py`, with `--fused-conv`).

Entry points run on the CUDA card unless the caller passes
`device="cpu"` (`device.resolve_device`); on the CPU every kernel's
plain PyTorch version runs instead.
"""

from torched_impala_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
