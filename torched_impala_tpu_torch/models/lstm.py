"""LSTMCell: the LSTM core's cell (counterpart of
`torched_impala_tpu/models/lstm.py:PallasLSTMCell`).

The params are the flax cell's eight `DenseParams` concatenated in gate
order (i, f, g, o), the layout `ops/lstm.py:lstm_cell_fused` takes:

- `wi` `[F, 4H]`: the input kernels `ii, if, ig, io` (no bias);
- `wh` `[H, 4H]`: the recurrent kernels `hi, hf, hg, ho`;
- `b` `[4H]`: the recurrent biases, the cell's only bias.

Init follows flax: lecun-normal input kernels (fan-in F), orthogonal
recurrent kernels (one `[H, H]` matrix per gate), zero bias, drawn from
an explicit `torch.Generator`. The carry is `(c, h)`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from torched_impala_tpu_torch.models.torsos import lecun_normal_
from torched_impala_tpu_torch.ops.lstm import lstm_cell_fused


@torch.no_grad()
def orthogonal_(weight: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """flax's `initializers.orthogonal()` for a square matrix: Q of the QR
    of a standard normal matrix, columns signed by diag(R)."""
    a = torch.empty(weight.shape).normal_(generator=generator)
    q, r = torch.linalg.qr(a)
    weight.copy_(q * torch.sign(torch.diagonal(r)))


class LSTMCell(nn.Module):
    def __init__(
        self,
        input_size: int,
        hidden_size: int,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.hidden_size = hidden_size
        H = hidden_size
        self.wi = nn.Parameter(torch.empty(input_size, 4 * H))
        self.wh = nn.Parameter(torch.empty(H, 4 * H))
        self.b = nn.Parameter(torch.zeros(4 * H))
        for g in range(4):
            lecun_normal_(self.wi[:, g * H : (g + 1) * H], input_size, generator)
            orthogonal_(self.wh[:, g * H : (g + 1) * H], generator)

    def forward(
        self, carry: tuple[torch.Tensor, torch.Tensor], x: torch.Tensor
    ) -> tuple[tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
        """((c, h), x `[B, F]`) -> ((new_c, new_h), new_h), float32."""
        c, h = carry
        new_c, new_h = lstm_cell_fused(x, h, c, self.wi, self.wh, self.b)
        return (new_c, new_h), new_h
