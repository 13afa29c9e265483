"""torched_impala_tpu_torch: the PyTorch / CUDA port of torched_impala_tpu.

The JAX package `torched_impala_tpu` is the reference; this package grows
beside it slice by slice (ROADMAP.md) and never imports it, nor JAX.
It trains the Pong preset (Nature-CNN, bf16 torso), the Breakout preset
(IMPALA deep ResNet, bf16 torso, LSTM core with episode resets), the
pong_transformer preset (Nature-CNN bf16 torso, transformer core with a
sliding-window KV cache) and the PROCGEN preset (IMPALA deep ResNet
without a core on 64x64x3 pixels, async worker pool) with thread or
process actors and a learner on one card.
Every TPU kernel of the JAX package runs as a hand-written CUDA kernel
(`csrc/`): the V-trace recursion (`ops/vtrace_cuda.py`), the fused
V-trace loss (`ops/fused_loss_cuda.py`, with `--fused-epilogue`), the
fused LSTM cell (`ops/lstm_cuda.py`), the fused residual block
(`ops/conv_block_cuda.py`, with `--fused-conv`) and the windowed flash
attention forward, dQ and dK/dV (`ops/attention_cuda.py`).

Entry points run on the CUDA card unless the caller passes
`device="cpu"` (`device.resolve_device`); on the CPU every kernel's
plain PyTorch version runs instead.
"""

from torched_impala_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
