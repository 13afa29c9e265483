"""Observation torsos: MLP and Nature-CNN (counterparts of
`torched_impala_tpu/models/torsos.py:MLPTorso, AtariShallowTorso`).

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
  sum, so the port runs the plain 8x8/4 VALID conv.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

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


def _conv(x, weight, bias, stride: int, dtype: torch.dtype) -> torch.Tensor:
    y = F.conv2d(x, weight.to(dtype), stride=stride)
    return y + bias.to(dtype)[:, None, None]


def _dense(x, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x, layer.weight.to(dtype)) + layer.bias.to(dtype)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(self.num_layers):
            x = F.relu(_dense(x, getattr(self, f"Dense_{i}"), self.dtype))
        return x


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """`x`: NHWC `[N, 84, 84, C]`, uint8 pixels or float."""
        dt = self.dtype
        w0 = self.Conv_0.weight
        if x.dtype == torch.uint8:
            w0 = w0 * (1.0 / 255.0)
        # NHWC -> NCHW as a view: the strides stay channels-last.
        h = x.permute(0, 3, 1, 2).to(dt)
        h = F.relu(_conv(h, w0, self.Conv_0.bias, 4, dt))
        h = F.relu(_conv(h, self.Conv_1.weight, self.Conv_1.bias, 2, dt))
        h = F.relu(_conv(h, self.Conv_2.weight, self.Conv_2.bias, 1, dt))
        # Flatten in flax's (h, w, c) order.
        h = h.permute(0, 2, 3, 1).flatten(1)
        return F.relu(_dense(h, self.Dense_0, dt))
