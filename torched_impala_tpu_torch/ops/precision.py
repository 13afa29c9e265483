"""Mixed-precision policy of the port (counterpart of
`torched_impala_tpu/ops/precision.py`, cut to the roles this slice has).

Compute may run in bfloat16 in the torso, by choice
(`transformer_dtype`) in the transformer core's matmuls, and with
`train_dtype="bfloat16"` in the whole train step: the learner lowers the
f32 master params to bf16 inside the differentiated closure
(`cast_to_compute`). Every accumulator stays float32 whatever the
compute dtype:

- the V-trace recursion (its reverse-time products compound rounding);
- the loss reductions over `[T, B]`;
- gradients, which autograd returns in the f32 master params' dtype
  because the bf16 cast happens inside the forward;
- the RMSProp second moments, which underflow in bf16's 8-bit mantissa;
- the master params the optimizer updates;
- the LSTM carry.
"""

from __future__ import annotations

from typing import Collection, Iterable, Mapping

import torch

# The compute dtypes of every role (the torso, the transformer core, the
# train step), as JAX's policy allows them: float16 is not one.
COMPUTE_DTYPES = ("float32", "bfloat16")


def validate_compute_dtype(role: str, name: str) -> str:
    """`name` if the policy allows it, else ValueError naming `role`
    (JAX's `validate_compute_dtype`)."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(
            f"dtype {name!r} is not in the mixed-precision policy for {role!r} "
            f"(allowed: {COMPUTE_DTYPES})"
        )
    return name


class _RoundStraightThrough(torch.autograd.Function):
    """Forward: x rounded to `dtype`, held in x's dtype. Backward: the
    gradient as it is, unrounded."""

    @staticmethod
    def forward(ctx, x, dtype):
        return x.to(dtype).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def cast_to_compute(
    params: Mapping[str, torch.Tensor],
    dtype: torch.dtype,
    straight_through: Collection[str] = (),
) -> dict[str, torch.Tensor]:
    """The f32 master params lowered to `dtype` inside the differentiated
    closure (JAX's `cast_to_compute` of the train step), with JAX's
    rounding of each gradient on its way back:

    - every param not in `straight_through` becomes a `dtype` tensor, and
      the cast's backward rounds its gradient to `dtype` before it reaches
      the f32 master, as the transpose of JAX's cast does;
    - a param in `straight_through` stays float32 and holds its values
      rounded to `dtype`; its gradient reaches the master unrounded.
      These are the params of a kernel whose backward returns float32
      grads for bf16 primals (the LSTM cell's custom VJP), which torch's
      autograd would otherwise round to the input's dtype.
    """
    return {
        name: _RoundStraightThrough.apply(p, dtype) if name in straight_through else p.to(dtype)
        for name, p in params.items()
    }


def compute_dtype(name: str) -> torch.dtype:
    """A compute dtype (the torso's, the transformer core's): float32 or
    bfloat16, nothing else."""
    return getattr(torch, validate_compute_dtype("compute", name))


def assert_f32_accumulators(
    tensors: Mapping[str, Iterable[torch.Tensor]], *, context: str
) -> None:
    """Raise if any tensor of an accumulator role is not float32."""
    bad = [
        f"{role}:{t.dtype}"
        for role, ts in tensors.items()
        for t in ts
        if t.is_floating_point() and t.dtype != torch.float32
    ]
    if bad:
        raise ValueError(
            f"{context}: accumulator state must be float32, got "
            + ", ".join(sorted(set(bad)))
        )
