"""Observation torsos: MLP, Nature-CNN and the IMPALA deep ResNet
(counterparts of `torched_impala_tpu/models/torsos.py:MLPTorso,
AtariShallowTorso, ResidualBlock, AtariDeepTorso`).

Public boundary: observations are `[N, ...obs]` in the JAX package's
layout, so pixels arrive NHWC uint8 `[N, 84, 84, 4]`. Submodules keep the
flax names (`Conv_0`, `Dense_0`, ...) so `models/convert.py` maps a flax
param tree onto them by name.

Precision: params are float32 masters. With `dtype="bfloat16"` the
forward casts the input and each weight and bias to bf16, adds the bias
in bf16 and returns bf16, as flax's `dtype=` does; autograd brings the
gradients back to the f32 params through the casts. (`torch.autocast` is
not used: its per-op lists differ from that rule.)

Layout hazards pinned by tests/test_torch_port_models.py:
- flax conv kernels are HWIO, torch's OIHW (convert.py transposes);
- flax flattens the last conv's NHWC output in (h, w, c) order, so the
  forward permutes to NHWC before the flatten and `Dense_0`'s rows keep
  the flax order;
- for uint8 input the 1/255 scale folds onto the first conv's kernel
  (`conv(x/255, w) == conv(x, w/255)`), as the JAX `_FirstPixelConv`
  does; its space-to-depth rewrite is a TPU-only reshaping of the same
  sum, so the port runs the plain 8x8/4 VALID conv;
- flax's SAME max-pool 3x3/2 pads low = total // 2 and high the rest
  with -inf (84 -> 42: (0, 1); 21 -> 11: (1, 1)); torch's `padding=1`
  pads both sides and shifts the windows by one at even sizes, with the
  same output sizes, so `max_pool_same` pads explicitly.

Rematerialization: `forward(x, remat=True)` runs each stage (a dense
layer, a conv with its relu or its pool, a residual block) through its
own non-reentrant `torch.utils.checkpoint`: only the stages' inputs are
kept for the backward, which runs each stage's forward again just
before its own backward, one stage at a time. The params and the
numbers are those of the plain forward. One checkpoint around the whole
torso would bring every stage's activations back at once when the
torso's backward begins; then the deep torso's widest stage, whose
backward holds the learner step's peak device memory, keeps the
max-pool's saved tensors alive under the residual blocks' backward as
without remat (PERF.md §6).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from torched_impala_tpu_torch.ops.conv_block import fused_residual_block
from torched_impala_tpu_torch.ops.precision import compute_dtype

# flax's lecun_normal: a normal truncated at 2 std, rescaled so the
# truncated distribution's std is sqrt(1 / fan_in).
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(
    weight: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]
) -> None:
    x = torch.empty(weight.shape).normal_(generator=generator)
    bad = x.abs() > 2.0
    while bool(bad.any()):
        x[bad] = torch.empty(int(bad.sum())).normal_(generator=generator)
        bad = x.abs() > 2.0
    weight.copy_(x * (fan_in**-0.5 / _TRUNC_STD))


def init_dense_(layer: nn.Module, generator: Optional[torch.Generator]) -> None:
    """flax defaults for Dense and Conv: lecun_normal kernel, zero bias."""
    w = layer.weight
    lecun_normal_(w, w[0].numel(), generator)
    nn.init.zeros_(layer.bias)


def _conv(
    x, weight, bias, stride: int, dtype: torch.dtype, padding: int = 0
) -> torch.Tensor:
    y = F.conv2d(x, weight.to(dtype), stride=stride, padding=padding)
    return y + bias.to(dtype)[:, None, None]


def _dense(x, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x, layer.weight.to(dtype)) + layer.bias.to(dtype)


def _stage(fn, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """`fn(x)`, with `remat` through a non-reentrant checkpoint (module
    docstring). The torsos draw no random numbers: no RNG state to keep."""
    if not remat:
        return fn(x)
    return torch.utils.checkpoint.checkpoint(
        fn, x, use_reentrant=False, preserve_rng_state=False
    )


class MLPTorso(nn.Module):
    """ReLU MLP over vector observations `[N, F]` (CartPole config)."""

    def __init__(
        self,
        in_features: int,
        hidden_sizes: Sequence[int] = (64, 64),
        dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.dtype = compute_dtype(dtype)
        sizes = (in_features, *hidden_sizes)
        self.num_layers = len(hidden_sizes)
        for i in range(self.num_layers):
            layer = nn.Linear(sizes[i], sizes[i + 1])
            init_dense_(layer, generator)
            self.add_module(f"Dense_{i}", layer)
        self.feature_size = sizes[-1]

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(self.num_layers):
            x = _stage(functools.partial(self._layer, i), x, remat)
        return x

    def _layer(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return F.relu(_dense(x, getattr(self, f"Dense_{i}"), self.dtype))


class AtariShallowTorso(nn.Module):
    """Nature-CNN: 8x8/4 -> 4x4/2 -> 3x3/1 convs, all VALID (84 -> 20 -> 9
    -> 7), flatten 3136, Dense(512); ReLU after each."""

    feature_size = 512

    def __init__(
        self,
        in_channels: int = 4,
        dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.Conv_0 = nn.Conv2d(in_channels, 32, 8, stride=4)
        self.Conv_1 = nn.Conv2d(32, 64, 4, stride=2)
        self.Conv_2 = nn.Conv2d(64, 64, 3, stride=1)
        self.Dense_0 = nn.Linear(7 * 7 * 64, 512)
        for layer in (self.Conv_0, self.Conv_1, self.Conv_2, self.Dense_0):
            init_dense_(layer, generator)

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """`x`: NHWC `[N, 84, 84, C]`, uint8 pixels or float."""
        h = _stage(self._first_conv, x, remat)
        for i, stride in ((1, 2), (2, 1)):
            h = _stage(functools.partial(self._conv, i, stride), h, remat)
        return _stage(self._head, h, remat)

    def _first_conv(self, x: torch.Tensor) -> torch.Tensor:
        w0 = self.Conv_0.weight
        if x.dtype == torch.uint8:
            w0 = w0 * (1.0 / 255.0)
        # NHWC -> NCHW as a view: the strides stay channels-last.
        h = x.permute(0, 3, 1, 2).to(self.dtype)
        return F.relu(_conv(h, w0, self.Conv_0.bias, 4, self.dtype))

    def _conv(self, i: int, stride: int, h: torch.Tensor) -> torch.Tensor:
        conv = getattr(self, f"Conv_{i}")
        return F.relu(_conv(h, conv.weight, conv.bias, stride, self.dtype))

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        # Flatten in flax's (h, w, c) order.
        h = h.permute(0, 2, 3, 1).flatten(1)
        return F.relu(_dense(h, self.Dense_0, self.dtype))


def _same_pads(size: int, window: int, stride: int) -> tuple[int, int]:
    """flax/XLA SAME padding of one axis: (low, high), low = total // 2."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """flax `max_pool(window (3, 3), strides (2, 2), padding "SAME")` of an
    NCHW tensor: -inf padding split low = total // 2 (module docstring)."""
    top, bottom = _same_pads(x.shape[2], 3, 2)
    left, right = _same_pads(x.shape[3], 3, 2)
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, kernel_size=3, stride=2)


class ResidualBlock(nn.Module):
    """relu -> 3x3 SAME conv -> relu -> 3x3 SAME conv -> x + out.

    Unfused, each conv follows the torso's dtype rule (operands and bias
    in the compute dtype, bias added in it) and the skip is added in the
    compute dtype. With `fused=True` the block is one call of
    `ops/conv_block.py:fused_residual_block` (the CUDA kernel on the
    card), whose numbers are the TPU kernel's (f32 sums and bias adds);
    the params are the same either way."""

    def __init__(
        self,
        channels: int,
        dtype: str = "float32",
        fused: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.fused = fused
        self.Conv_0 = nn.Conv2d(channels, channels, 3)
        self.Conv_1 = nn.Conv2d(channels, channels, 3)
        for layer in (self.Conv_0, self.Conv_1):
            init_dense_(layer, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """`x`: NCHW in the compute dtype (a view over channels-last memory
        in the torso)."""
        c0, c1 = self.Conv_0, self.Conv_1
        if self.fused:
            hwio = (2, 3, 1, 0)  # OIHW -> HWIO, the kernel's layout
            out = fused_residual_block(
                x.permute(0, 2, 3, 1).contiguous(),
                c0.weight.permute(hwio).contiguous(),
                c0.bias,
                c1.weight.permute(hwio).contiguous(),
                c1.bias,
            )
            return out.permute(0, 3, 1, 2)
        dt = self.dtype
        out = F.relu(x)
        out = _conv(out, c0.weight, c0.bias, 1, dt, padding=1)
        out = F.relu(out)
        out = _conv(out, c1.weight, c1.bias, 1, dt, padding=1)
        return x + out


class AtariDeepTorso(nn.Module):
    """IMPALA deep ResNet: per section a 3x3 SAME conv, a SAME max-pool
    3x3/2 and `blocks_per_section` residual blocks; then relu, a flatten
    in flax's (h, w, c) order and Dense(hidden_size) + relu. At 84x84 with
    (16, 32, 32): 84 -> 42 -> 21 -> 11, flatten 11*11*32 = 3872.

    Submodules keep the flax names: `Conv_0..`, `ResidualBlock_0..` (each
    with `Conv_0`, `Conv_1`), `Dense_0`. `in_hw` is the observation's
    (height, width), which fixes Dense_0's input width."""

    def __init__(
        self,
        in_channels: int = 4,
        in_hw: tuple = (84, 84),
        channel_sections: Sequence[int] = (16, 32, 32),
        blocks_per_section: int = 2,
        hidden_size: int = 256,
        dtype: str = "float32",
        fused_blocks: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.num_sections = len(channel_sections)
        self.blocks_per_section = blocks_per_section
        h, w = in_hw
        c_in = in_channels
        for i, channels in enumerate(channel_sections):
            conv = nn.Conv2d(c_in, channels, 3)
            init_dense_(conv, generator)
            self.add_module(f"Conv_{i}", conv)
            for j in range(blocks_per_section):
                block = ResidualBlock(channels, dtype, fused_blocks, generator)
                self.add_module(f"ResidualBlock_{i * blocks_per_section + j}", block)
            c_in = channels
            h, w = -(-h // 2), -(-w // 2)
        self.Dense_0 = nn.Linear(h * w * c_in, hidden_size)
        init_dense_(self.Dense_0, generator)
        self.feature_size = hidden_size

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """`x`: NHWC `[N, H, W, C]`, uint8 pixels or float."""
        h = x
        for i in range(self.num_sections):
            h = _stage(functools.partial(self._conv_pool, i), h, remat)
            for j in range(self.blocks_per_section):
                block = getattr(self, f"ResidualBlock_{i * self.blocks_per_section + j}")
                h = _stage(block, h, remat)
        return _stage(self._head, h, remat)

    def _conv_pool(self, i: int, h: torch.Tensor) -> torch.Tensor:
        """Section i's conv and SAME max-pool; section 0 takes the NHWC
        input (uint8 pixels or float)."""
        conv = getattr(self, f"Conv_{i}")
        w = conv.weight
        if i == 0:
            if h.dtype == torch.uint8:
                w = w * (1.0 / 255.0)
            # NHWC -> NCHW as a view: the strides stay channels-last.
            h = h.permute(0, 3, 1, 2).to(self.dtype)
        return max_pool_same(_conv(h, w, conv.bias, 1, self.dtype, padding=1))

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        h = F.relu(h).permute(0, 2, 3, 1).flatten(1)
        return F.relu(_dense(h, self.Dense_0, self.dtype))
