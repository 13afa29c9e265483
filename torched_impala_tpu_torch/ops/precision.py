"""Mixed-precision policy of the port (counterpart of
`torched_impala_tpu/ops/precision.py`, cut to the roles this slice has).

Compute may run in bfloat16 only in the torso. Every accumulator stays
float32 whatever the compute dtype:

- the V-trace recursion (its reverse-time products compound rounding);
- the loss reductions over `[T, B]`;
- gradients, which autograd returns in the f32 master params' dtype
  because the bf16 cast happens inside the forward;
- the RMSProp second moments, which underflow in bf16's 8-bit mantissa;
- the master params the optimizer updates.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import torch


def compute_dtype(name: str) -> torch.dtype:
    """The torso's compute dtype: float32 or bfloat16, nothing else."""
    if name not in ("float32", "bfloat16"):
        raise ValueError(
            f"torso compute dtype must be 'float32' or 'bfloat16', got {name!r}"
        )
    return getattr(torch, name)


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
