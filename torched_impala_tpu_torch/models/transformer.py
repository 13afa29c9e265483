"""Transformer policy core: causal attention over the unroll's time axis
with a sliding-window KV cache as its recurrent state (counterpart of
`torched_impala_tpu/models/transformer.py` with `attention="dense"`).

- unroll mode processes the whole `[T, B]` unroll at once; step mode is
  the same code with T = 1, the cache carrying the context;
- episode boundaries are segment ids: each row carries a running episode
  counter, and a query sees only cache slots and unroll steps of its own
  episode (the analog of zeroing an LSTM carry); a `first` step opens a
  new segment;
- positions are rotary with absolute per-row step indices; the cache
  keeps post-rotary keys and raw values.

State (batch-major, like any recurrent state): k_cache/v_cache
`[B, L, W, D]` float32 whatever the compute dtype, kv_seg/kv_pos `[B, W]`
int32, pos `[B]` the next absolute position, seg `[B]` the episode
counter. A fresh state has kv_seg = -1 (matches no segment: an empty
cache).

Attention runs one of two branches (`dense_kernel`): "einsum", the JAX
package's einsum branch in plain PyTorch products, or "kernel" (also
spelled "pallas", the JAX package's name), the windowed flash attention
of `ops/attention.py` (the hand-written CUDA kernels on the card, their
plain versions on the CPU). Every head width runs on the kernels: up
to 256 on the tiled ones (`ops/attention_cuda.py:MAX_HEAD_DIM`), wider
on the general ones of `csrc/attention_wide.cu`. Step mode always
takes the einsum branch, as in JAX. The two branches agree where every
query sees at least itself, which the core guarantees.

Flax semantics the port keeps: LayerNorm epsilon 1e-6 (torch's default is
1e-5), statistics on the f32 input with the output cast to the compute
dtype; GELU is the tanh approximation (`nn.gelu`'s default; torch's
default is exact). Param names follow the flax tree (`in_proj`,
`ln_kv_{l}`, `k_proj_{l}`, `v_proj_{l}`, `block_{l}/{ln_attn, q_proj,
o_proj, ln_mlp, mlp_in, mlp_out}`, `ln_out`) so `models/convert.py` maps
them by path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from torched_impala_tpu_torch.models.torsos import init_dense_
from torched_impala_tpu_torch.ops import precision
from torched_impala_tpu_torch.ops.attention import NEG_INF, windowed_attention

LN_EPS = 1e-6  # flax.linen.LayerNorm's default


class TransformerCoreState(NamedTuple):
    k_cache: torch.Tensor  # [B, L, W, D] f32
    v_cache: torch.Tensor  # [B, L, W, D] f32
    kv_seg: torch.Tensor  # [B, W] int32, -1 = empty slot
    kv_pos: torch.Tensor  # [B, W] int32 absolute positions
    pos: torch.Tensor  # [B] int32 next absolute position
    seg: torch.Tensor  # [B] int32 current episode counter


def rotary(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary embeddings: x `[..., H, dh]`, positions `[...]`. The two
    halves of dh rotate together (not interleaved); angles in f32, the
    result in x's dtype."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (
        10000.0 ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    )
    angles = positions.float()[..., None, None] * freqs  # [..., 1, half]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _dense(in_features: int, out_features: int, generator) -> nn.Linear:
    layer = nn.Linear(in_features, out_features)
    init_dense_(layer, generator)
    return layer


def _apply(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax Dense(dtype=...): inputs and params cast to the compute dtype."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _layer_norm_f32(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax LayerNorm on the f32 input: f32 statistics and f32 scale and
    bias, whatever the params' dtype (bf16 ones are cast up, as flax
    promotes them)."""
    return F.layer_norm(
        x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(), ln.eps
    )


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Statistics on the f32 input, output in the compute dtype."""
    return _layer_norm_f32(ln, x).to(dtype)


def einsum_attention(q, k, v, mask) -> torch.Tensor:
    """The einsum branch: q `[B, T, H, dh]`, k/v `[B, S, H, dh]` in the
    compute dtype, mask `[B, T, S]` bool; logits and softmax in f32, the
    output `[B, T, H, dh]` in v's dtype."""
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) / (
        float(q.shape[-1]) ** 0.5
    )
    attn = torch.softmax(torch.where(mask[:, None], logits, NEG_INF), dim=-1)
    return torch.einsum("bhts,bshd->bthd", attn.to(v.dtype), v)


class _Block(nn.Module):
    """Pre-LN block: attention over explicit K/V context, then the MLP."""

    def __init__(self, d_model, num_heads, mlp_factor, dtype, generator):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.ln_attn = nn.LayerNorm(d_model, eps=LN_EPS)
        self.q_proj = _dense(d_model, d_model, generator)
        self.o_proj = _dense(d_model, d_model, generator)
        self.ln_mlp = nn.LayerNorm(d_model, eps=LN_EPS)
        self.mlp_in = _dense(d_model, mlp_factor * d_model, generator)
        self.mlp_out = _dense(mlp_factor * d_model, d_model, generator)

    def forward(self, x, k_ctx, v_ctx, mask, q_pos, kernel_ctx=None):
        """x `[B, T, D]`; k_ctx/v_ctx `[B, S, D]` (cache then current
        tokens, projected by the core); mask `[B, T, S]` bool for the
        einsum branch, or `kernel_ctx` (seg_q, seg_ctx, W) for the kernel
        branch; q_pos `[B, T]`."""
        B, T, D = x.shape
        H = self.num_heads
        dh = D // H
        cd = self.dtype
        h = _layer_norm(self.ln_attn, x, cd)
        q = rotary(_apply(self.q_proj, h, cd).reshape(B, T, H, dh), q_pos)
        k = k_ctx.reshape(B, -1, H, dh)
        v = v_ctx.reshape(B, -1, H, dh)
        if kernel_ctx is not None:
            seg_q, seg_ctx, W = kernel_ctx
            out = windowed_attention(q, k, v, seg_q, seg_ctx, W).reshape(B, T, D)
        else:
            out = einsum_attention(q, k, v, mask).reshape(B, T, D)
        x = x + _apply(self.o_proj, out, cd)
        h = _layer_norm(self.ln_mlp, x, cd)
        h = F.gelu(_apply(self.mlp_in, h, cd), approximate="tanh")
        return x + _apply(self.mlp_out, h, cd)


class TransformerCore(nn.Module):
    """L pre-LN blocks over time with a sliding-window KV cache.

    Call with features `[T, B, F]` (time-major), `first` `[T, B]` bool and
    a `TransformerCoreState` (or a plain tuple of its six leaves); returns
    (`[T, B, d_model]` f32, new state)."""

    def __init__(
        self,
        input_size: int,
        d_model: int = 256,
        num_layers: int = 2,
        num_heads: int = 4,
        window: int = 128,
        mlp_factor: int = 4,
        attention: str = "dense",
        dense_kernel: str = "einsum",
        dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if attention in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attention={attention!r} (sequence-parallel) is not ported yet: "
                "it needs the DP/SP port (ROADMAP.md queue 1: DP and multi-process training)"
            )
        if attention != "dense":
            raise ValueError(f"attention={attention!r}; expected 'dense'")
        if dense_kernel not in ("einsum", "kernel", "pallas"):
            raise ValueError(
                f"dense_kernel={dense_kernel!r}; expected 'einsum' or 'kernel' "
                "(or 'pallas', the JAX package's name for it; 'auto' is "
                "resolved by configs.make_agent)"
            )
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by {num_heads} heads")
        self.d_model, self.num_layers, self.num_heads = d_model, num_layers, num_heads
        self.window = window
        self.dense_kernel = "kernel" if dense_kernel == "pallas" else dense_kernel
        self.dtype = precision.compute_dtype(dtype)
        self.in_proj = _dense(input_size, d_model, generator)
        for layer in range(num_layers):
            # The kv projections live in the core, outside the blocks.
            self.add_module(f"ln_kv_{layer}", nn.LayerNorm(d_model, eps=LN_EPS))
            self.add_module(f"k_proj_{layer}", _dense(d_model, d_model, generator))
            self.add_module(f"v_proj_{layer}", _dense(d_model, d_model, generator))
            self.add_module(
                f"block_{layer}",
                _Block(d_model, num_heads, mlp_factor, self.dtype, generator),
            )
        self.ln_out = nn.LayerNorm(d_model, eps=LN_EPS)

    def initial_state(self, batch_size: int, device=None) -> TransformerCoreState:
        B, L, W, D = batch_size, self.num_layers, self.window, self.d_model
        i32 = dict(dtype=torch.int32, device=device)
        return TransformerCoreState(
            k_cache=torch.zeros((B, L, W, D), device=device),
            v_cache=torch.zeros((B, L, W, D), device=device),
            kv_seg=torch.full((B, W), -1, **i32),
            kv_pos=torch.zeros((B, W), **i32),
            pos=torch.zeros((B,), **i32),
            seg=torch.zeros((B,), **i32),
        )

    def forward(self, features, first, state):
        state = TransformerCoreState(*state)
        T, B, _ = features.shape
        W, D, H = self.window, self.d_model, self.num_heads
        cd = self.dtype
        first = first.transpose(0, 1)  # [B, T]
        # A step flagged `first` opens a new segment, so the cumsum counts it.
        seg_q = state.seg[:, None] + torch.cumsum(first.to(torch.int32), dim=1, dtype=torch.int32)
        pos_q = state.pos[:, None] + torch.arange(T, dtype=torch.int32, device=features.device)
        x = _apply(self.in_proj, features, cd).transpose(0, 1)  # [B, T, D]

        seg_ctx = torch.cat([state.kv_seg, seg_q], dim=1)  # [B, W + T]
        kernel_ctx = mask = None
        if self.dense_kernel == "kernel" and T > 1:
            kernel_ctx = (seg_q.contiguous(), seg_ctx.contiguous(), W)
        else:
            # Cache slots by segment alone; the unroll causal within a segment.
            cache_vis = seg_q[:, :, None] == state.kv_seg[:, None, :]  # [B, T, W]
            causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
            intra_vis = (seg_q[:, :, None] == seg_q[:, None, :]) & causal
            mask = torch.cat([cache_vis, intra_vis], dim=2)  # [B, T, W + T]

        new_k, new_v = [], []
        for layer in range(self.num_layers):
            kv_in = _layer_norm(getattr(self, f"ln_kv_{layer}"), x, cd)
            k_new = _apply(getattr(self, f"k_proj_{layer}"), kv_in, cd)
            k_new = rotary(k_new.reshape(B, T, H, D // H), pos_q).reshape(B, T, D)
            v_new = _apply(getattr(self, f"v_proj_{layer}"), kv_in, cd)
            k_ctx = torch.cat([state.k_cache[:, layer].to(cd), k_new], dim=1)
            v_ctx = torch.cat([state.v_cache[:, layer].to(cd), v_new], dim=1)
            x = getattr(self, f"block_{layer}")(x, k_ctx, v_ctx, mask, pos_q, kernel_ctx)
            new_k.append(k_ctx[:, -W:].float())
            new_v.append(v_ctx[:, -W:].float())

        out = _layer_norm_f32(self.ln_out, x)
        new_state = TransformerCoreState(
            k_cache=torch.stack(new_k, dim=1),
            v_cache=torch.stack(new_v, dim=1),
            kv_seg=seg_ctx[:, -W:],
            kv_pos=torch.cat([state.kv_pos, pos_q], dim=1)[:, -W:],
            pos=state.pos + T,
            seg=seg_q[:, -1],
        )
        return out.transpose(0, 1), new_state
