"""The fused LSTM cell (counterpart of `torched_impala_tpu/ops/lstm_pallas.py`).

One step of the LSTM core, everything in float32 (the carry is an
accumulator: ops/precision.py):

    gates = (h @ Wh + b) + x @ Wi        gates (i, f, g, o) along 4H
    i, f, o = sigmoid, g = tanh
    new_c = f * c + i * g,  new_h = o * tanh(new_c)

`lstm_reference` is the plain PyTorch version; it also returns the
activated gates that the backward reads. `lstm_cell_fused` is a
`torch.autograd.Function` whose forward runs where the tensors lie (the
hand-written kernel of `ops/lstm_cuda.py` for CUDA tensors, the plain
version for CPU tensors) and whose backward is the closed form of the
JAX `_lstm_bwd`: gate algebra plus four plain matmuls, as JAX computes
it outside its kernel.
"""

from __future__ import annotations

import torch


def lstm_reference(x, h, c, wi, wh, b):
    """(new_c, new_h, acts): one cell step in plain PyTorch, all f32.
    x `[B, F]`, h, c `[B, H]`, wi `[F, 4H]`, wh `[H, 4H]`, b `[4H]`."""
    hidden = c.shape[-1]
    gates = (h @ wh + b) + x @ wi
    i = torch.sigmoid(gates[:, :hidden])
    f = torch.sigmoid(gates[:, hidden : 2 * hidden])
    g = torch.tanh(gates[:, 2 * hidden : 3 * hidden])
    o = torch.sigmoid(gates[:, 3 * hidden :])
    new_c = f * c + i * g
    new_h = o * torch.tanh(new_c)
    return new_c, new_h, torch.cat([i, f, g, o], dim=-1)


def lstm_forward(x, h, c, wi, wh, b):
    """(new_c, new_h, acts) on the tensors' device: the CUDA kernel for
    CUDA tensors, `lstm_reference` for CPU tensors."""
    if x.is_cuda:
        from torched_impala_tpu_torch.ops import lstm_cuda

        return lstm_cuda.lstm_cell_cuda(x, h, c, wi, wh, b)
    if x.device.type == "cpu":
        return lstm_reference(x, h, c, wi, wh, b)
    raise ValueError(f"lstm_cell_fused: no implementation for device {x.device}")


def lstm_backward(saved, d_new_c, d_new_h):
    """Closed-form cell backward (the JAX `_lstm_bwd`). With the activated
    gates and tc = tanh(new_c):

      dcp     = dc' + dh' * o * (1 - tc^2)
      d_pre   = [dcp g i(1-i), dcp c f(1-f), dcp i (1-g^2), dh' tc o(1-o)]
      dx = d_pre Wi^T, dh = d_pre Wh^T, dc = dcp f,
      dWi = x^T d_pre, dWh = h^T d_pre, db = sum_b d_pre
    """
    x, h, c, wi, wh, acts, new_c = saved
    hidden = c.shape[-1]
    i = acts[:, :hidden]
    f = acts[:, hidden : 2 * hidden]
    g = acts[:, 2 * hidden : 3 * hidden]
    o = acts[:, 3 * hidden :]
    tc = torch.tanh(new_c)
    dcp = d_new_c + d_new_h * o * (1.0 - tc * tc)
    d_pre = torch.cat(
        [
            dcp * g * i * (1.0 - i),
            dcp * c * f * (1.0 - f),
            dcp * i * (1.0 - g * g),
            d_new_h * tc * o * (1.0 - o),
        ],
        dim=-1,
    )
    return (
        d_pre @ wi.T,
        d_pre @ wh.T,
        dcp * f,
        x.T @ d_pre,
        h.T @ d_pre,
        d_pre.sum(dim=0),
    )


class _LSTMCell(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h, c, wi, wh, b):
        new_c, new_h, acts = lstm_forward(x, h, c, wi, wh, b)
        ctx.save_for_backward(x, h, c, wi, wh, acts, new_c)
        return new_c, new_h

    @staticmethod
    def backward(ctx, d_new_c, d_new_h):
        return lstm_backward(ctx.saved_tensors, d_new_c, d_new_h)


def lstm_cell_fused(x, h, c, wi, wh, b):
    """One fused LSTM cell step -> (new_c, new_h), each `[B, H]` float32.

    Args as `lstm_reference`; every input is promoted to float32 first,
    as the JAX cell does."""
    args = [a.float() for a in (x, h, c, wi, wh, b)]
    return _LSTMCell.apply(*args)
