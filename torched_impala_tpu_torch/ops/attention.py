"""Windowed flash attention of the transformer core (counterpart of
`torched_impala_tpu/ops/attention_pallas.py`).

Masked attention of T queries over a context of S = W + T slots (W cache
slots, then the unroll's own keys), with visibility derived from the
segment (episode) ids instead of a materialised mask:

    visible(t, s) = seg_ctx[s] == seg_q[t]  and  (s < W  or  s - W <= t)

Layouts are the JAX package's: q `[B, T, H, dh]`, k/v `[B, S, H, dh]`,
seg_q `[B, T]` and seg_ctx `[B, S]` int32 (-1 marks an empty cache slot).
Logits are scaled by 1/sqrt(dh); masked logits are NEG_INF = -1e30.

- `windowed_attention_reference` is the forward's plain version: the f32
  output and the row logsumexp `[B, H, T]`. A row that sees nothing gives
  zeros and lse = NEG_INF, as the kernel does.
- `windowed_attention_backward_reference` is the backward kernel's plain
  version, with the kernel's formulas: D = sum_d O * dO (`row_term`), P
  recomputed from q, k and the saved lse, dS = P * (dP - D), dQ = dS K *
  scale (`attention_dq_reference`), dK = dS^T Q * scale and dV = P^T dO
  (`attention_dkv_reference`).
- `windowed_attention` is a `torch.autograd.Function` over the forward
  and the backward, run where the tensors lie: the hand-written kernels of
  `ops/attention_cuda.py` for CUDA tensors (one call each way), the plain
  versions for CPU tensors.

bf16 inputs keep bf16 operands with f32 sums, as the TPU kernels do: the
probabilities are rounded to v's dtype before the PV product, dS to k's
(dQ) or q's (dK) dtype and P to dO's dtype (dV).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _visibility(seg_q, seg_ctx, T: int, S: int, W: int) -> torch.Tensor:
    """The einsum branch's mask `[B, T, S]` bool (the tests' reference)."""
    t = torch.arange(T, device=seg_q.device)
    s = torch.arange(S, device=seg_q.device)
    pos_ok = (s[None, :] < W) | (s[None, :] - W <= t[:, None])  # [T, S]
    return (seg_q[:, :, None] == seg_ctx[:, None, :]) & pos_ok[None]


def _round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to `dtype` and back to f32 (a no-op for f32)."""
    return x.to(dtype).float()


def _probs(q, k, seg_q, seg_ctx, W, lse=None):
    """(P `[B, H, T, S]`, lse `[B, H, T]`) in f32: P = exp(logits - lse)
    where visible, exactly 0 elsewhere; the lse is computed unless given."""
    B, T, H, dh = q.shape
    S = k.shape[1]
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * (1.0 / dh**0.5)
    visible = _visibility(seg_q, seg_ctx, T, S, W)[:, None]
    if lse is None:
        m = torch.where(visible, logits, NEG_INF).amax(dim=-1)
        l = torch.where(visible, torch.exp(logits - m[..., None]), 0.0).sum(dim=-1)
        lse = m + torch.log(torch.where(l > 0, l, 1.0))
    return torch.where(visible, torch.exp(logits - lse[..., None]), 0.0), lse


@torch.no_grad()
def windowed_attention_reference(q, k_ctx, v_ctx, seg_q, seg_ctx, W: int):
    """(out `[B, T, H, dh]` f32, lse `[B, H, T]` f32) in plain PyTorch."""
    p, lse = _probs(q, k_ctx, seg_q, seg_ctx, W)
    out = torch.einsum("bhts,bshd->bthd", _round_to(p, v_ctx.dtype), v_ctx.float())
    # Contiguous, as the kernel's: the backward kernel reads it by rows.
    return out.contiguous(), lse


def row_term(o: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """D = sum_d O * dO `[B, T, H]` f32, the softmax-Jacobian row term,
    from the f32 forward output and dOut (the plain backward's; the kernel
    computes it inside)."""
    return torch.einsum("bthd,bthd->bth", o, g.float()).contiguous()


def _ds(q, k_ctx, v_ctx, g, lse, dcap, seg_q, seg_ctx, W):
    """(P, dS) `[B, H, T, S]` f32: P recomputed from q, k and the lse."""
    p, _ = _probs(q, k_ctx, seg_q, seg_ctx, W, lse)
    dp = torch.einsum("bthd,bshd->bhts", g.float(), v_ctx.float())
    return p, p * (dp - dcap.permute(0, 2, 1)[..., None])


@torch.no_grad()
def attention_dq_reference(q, k_ctx, v_ctx, g, lse, dcap, seg_q, seg_ctx, W: int):
    """dq `[B, T, H, dh]` f32 in plain PyTorch: `g` is dOut in q's dtype,
    `lse` `[B, H, T]`, `dcap` = row_term(out, g)."""
    _, ds = _ds(q, k_ctx, v_ctx, g, lse, dcap, seg_q, seg_ctx, W)
    dq = torch.einsum("bhts,bshd->bthd", _round_to(ds, k_ctx.dtype), k_ctx.float())
    return dq * (1.0 / q.shape[-1] ** 0.5)


@torch.no_grad()
def attention_dkv_reference(q, k_ctx, v_ctx, g, lse, dcap, seg_q, seg_ctx, W: int):
    """(dk, dv) `[B, S, H, dh]` f32 in plain PyTorch; args as
    `attention_dq_reference`."""
    p, ds = _ds(q, k_ctx, v_ctx, g, lse, dcap, seg_q, seg_ctx, W)
    dk = torch.einsum("bhts,bthd->bshd", _round_to(ds, q.dtype), q.float())
    dv = torch.einsum("bhts,bthd->bshd", _round_to(p, g.dtype), g.float())
    return dk * (1.0 / q.shape[-1] ** 0.5), dv


def windowed_attention_backward_reference(q, k_ctx, v_ctx, g, o, lse, seg_q, seg_ctx, W: int):
    """(dq, dk, dv), each f32 in its primal's shape, in plain PyTorch: `g`
    is dOut in q's dtype, `o` the f32 forward output, `lse` `[B, H, T]`."""
    args = (q, k_ctx, v_ctx, g, lse, row_term(o, g), seg_q, seg_ctx, W)
    return (attention_dq_reference(*args), *attention_dkv_reference(*args))


def _on_cuda(x: torch.Tensor) -> bool:
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"windowed_attention: no implementation for device {x.device}")


class _WindowedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k_ctx, v_ctx, seg_q, seg_ctx, W):
        if _on_cuda(q):
            from torched_impala_tpu_torch.ops import attention_cuda

            out, lse = attention_cuda.attention_forward_cuda(q, k_ctx, v_ctx, seg_q, seg_ctx, W)
        else:
            out, lse = windowed_attention_reference(q, k_ctx, v_ctx, seg_q, seg_ctx, W)
        # The f32 output (for D) and the row lse (for P) are all the
        # backward keeps: O(T) a row, never [T, S].
        ctx.save_for_backward(q, k_ctx, v_ctx, seg_q, seg_ctx, out, lse)
        ctx.W = W
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k_ctx, v_ctx, seg_q, seg_ctx, out, lse = ctx.saved_tensors
        args = (q, k_ctx, v_ctx, g.to(q.dtype).contiguous(), out, lse, seg_q, seg_ctx, ctx.W)
        if _on_cuda(q):
            from torched_impala_tpu_torch.ops import attention_cuda

            dq, dk, dv = attention_cuda.attention_backward_cuda(*args)
        else:
            dq, dk, dv = windowed_attention_backward_reference(*args)
        # Cotangents in the primals' dtypes (bf16 inputs get bf16 grads).
        return dq.to(q.dtype), dk.to(k_ctx.dtype), dv.to(v_ctx.dtype), None, None, None


def windowed_attention(q, k_ctx, v_ctx, seg_q, seg_ctx, W: int) -> torch.Tensor:
    """Masked flash attention `[B, T, H, dh]` in q's dtype (math in f32),
    differentiable in q, k_ctx and v_ctx. Args as the module docstring;
    W is the number of cache slots at the front of the context."""
    return _WindowedAttention.apply(q, k_ctx, v_ctx, seg_q, seg_ctx, int(W))
