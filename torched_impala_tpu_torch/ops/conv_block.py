"""The fused residual block (counterpart of
`torched_impala_tpu/ops/conv_pallas.py`).

    out = x + conv2(relu(conv1(relu(x)) + b1)) + b2

with 3x3 SAME convs on NHWC `[N, H, W, C]` and kernels in flax's HWIO
`[3, 3, C, C]`. The numbers are those of the TPU kernel, not those of the
unfused block (models/torsos.py): operands in x's dtype, products summed
in float32, b1 and b2 added in float32, the relu'd intermediate rounded to
x's dtype before conv2, the skip added in float32, one cast at the end.

`block_reference` is the plain PyTorch version. `fused_residual_block`
is a `torch.autograd.Function` whose forward runs where the tensors lie
(the hand-written kernel of `ops/conv_block_cuda.py` for CUDA tensors,
the plain version for CPU tensors) and whose backward is the closed form
of the JAX `_block_bwd` in float32, which JAX computes outside its
kernel: conv1's pre-activation recomputed, then transposed convs and
kernel gradients.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _oihw(k: torch.Tensor) -> torch.Tensor:
    return k.permute(3, 2, 0, 1)


def _conv_f32(x_nchw: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv in float32 of an NCHW view with an HWIO kernel."""
    return F.conv2d(x_nchw.float(), _oihw(k).float(), padding=1)


def block_reference(x, k1, b1, k2, b2):
    """The block in plain PyTorch. x `[N, H, W, C]` f32 or bf16, k `[3, 3,
    C, C]`, b `[C]`; returns x's shape and dtype."""
    dtype = x.dtype
    xr = _nchw(torch.relu(x))
    # Products of operands rounded to x's dtype are exact in float32, so a
    # float32 conv of the rounded operands is the dtype-in/f32-sum product.
    a1 = _conv_f32(xr, k1.to(dtype)) + b1.float()[:, None, None]
    y1 = torch.relu(a1).to(dtype)
    a2 = _conv_f32(y1, k2.to(dtype)) + b2.float()[:, None, None]
    return (x.float() + _nhwc(a2)).to(dtype)


def block_forward(x, k1, b1, k2, b2):
    """The block on the tensors' device: the CUDA kernel for CUDA tensors,
    `block_reference` for CPU tensors."""
    if x.is_cuda:
        from torched_impala_tpu_torch.ops import conv_block_cuda

        return conv_block_cuda.resblock_cuda(x, k1, b1, k2, b2)
    if x.device.type == "cpu":
        return block_reference(x, k1, b1, k2, b2)
    raise ValueError(f"fused_residual_block: no implementation for device {x.device}")


def block_backward(saved, dout):
    """Closed-form block backward in float32 (the JAX `_block_bwd`). With
    xr = relu(x), a1 = conv1(xr) + b1, y1 = relu(a1):

      db2 = sum dout              dk2 = kernel grad of (y1, dout)
      dy1 = conv2^T(dout)         da1 = dy1 [a1 > 0]
      db1 = sum da1               dk1 = kernel grad of (xr, da1)
      dx  = dout + conv1^T(da1) [x > 0]

    Each f32 `[N, C, H, W]` intermediate is dropped, or overwritten in
    place, as soon as no later line reads it: at the learner's widest
    block three of them are alive at once, not eight (the block's
    backward held the learner step's peak device memory). The values are
    those of the formulas above, operation for operation.
    """
    x, k1, b1, k2, b2 = saved
    k1f, k2f = _oihw(k1.float()), _oihw(k2.float())
    grad_weight = torch.nn.grad.conv2d_weight
    xr = _nchw(torch.relu(x).float())  # relu is exact in x's dtype
    dout_f = dout.float()
    dout_c = _nchw(dout_f)
    db2 = dout_c.sum(dim=(0, 2, 3))
    a1 = F.conv2d(xr, k1f, padding=1)
    a1 += b1.float()[:, None, None]
    on1 = a1 > 0
    y1 = a1.relu_()
    dk2 = grad_weight(y1, k2f.shape, dout_c, padding=1)
    del a1, y1
    da1 = F.conv_transpose2d(dout_c, k2f, padding=1).mul_(on1)
    del on1
    db1 = da1.sum(dim=(0, 2, 3))
    dk1 = grad_weight(xr, k1f.shape, da1, padding=1)
    del xr
    dx = _nhwc(F.conv_transpose2d(da1, k1f, padding=1))
    del da1
    dx = dx.mul_(x > 0).add_(dout_f)
    hwio = (2, 3, 1, 0)  # OIHW -> HWIO
    return (
        dx.to(x.dtype, memory_format=torch.contiguous_format),
        dk1.permute(hwio).to(k1.dtype),
        db1.to(b1.dtype),
        dk2.permute(hwio).to(k2.dtype),
        db2.to(b2.dtype),
    )


class _ResidualBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k1, b1, k2, b2):
        ctx.save_for_backward(x, k1, b1, k2, b2)
        return block_forward(x, k1, b1, k2, b2)

    @staticmethod
    def backward(ctx, dout):
        return block_backward(ctx.saved_tensors, dout)


def fused_residual_block(x, k1, b1, k2, b2):
    """relu -> conv3x3 SAME -> relu -> conv3x3 SAME -> +skip, fused.

    x `[N, H, W, C]` in the block's compute dtype (f32 or bf16); k1, k2
    `[3, 3, C, C]` and b1, b2 `[C]` float32 params. Returns x's shape and
    dtype."""
    return _ResidualBlock.apply(x, k1, b1, k2, b2)
