"""V-trace off-policy correction (IMPALA, arXiv:1802.01561 §4.1), time-major.

Counterpart of `torched_impala_tpu/ops/vtrace.py`:

    delta_t = rho_t * (r_t + gamma_t * V(x_{t+1}) - V(x_t))
    vs_t - V(x_t) = delta_t + gamma_t * c_t * (vs_{t+1} - V(x_{t+1}))
    rho_t = min(rho_bar, pi/mu),  c_t = lambda * min(c_bar, pi/mu)
    A_t = min(rho_pg_bar, pi/mu) * (r_t + gamma_t * vs_{t+1} - V(x_t))

`vtrace_reference` is the plain PyTorch version (a Python loop over T,
the same operation order as the JAX `vtrace_scan`). `vtrace` dispatches
on where the tensors lie: a CPU tensor takes the plain version, a CUDA
tensor the hand-written kernel of `ops/vtrace_cuda.py`.
`clipped_surrogate` is IMPACT's clipped objective (ops/losses.py:
impact_loss).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class VTraceOutput(NamedTuple):
    """V-trace targets `vs`, policy-gradient advantages and `vs - values`,
    each `[T, B]` and free of gradient (they are targets)."""

    vs: torch.Tensor
    pg_advantages: torch.Tensor
    errors: torch.Tensor


def threshold(x: Optional[float]) -> float:
    """A clip threshold as a float: None disables clipping (inf)."""
    return math.inf if x is None else float(x)


def clipped_surrogate(
    log_ratio: torch.Tensor, advantages: torch.Tensor, clip_epsilon: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """PPO-style clipped surrogate, the IMPACT objective's core
    (arXiv:1912.00167 eq. 2; JAX `ops/vtrace.py:clipped_surrogate`):

        surrogate_t = min(r_t * A_t, clip(r_t, 1-eps, 1+eps) * A_t)
        r_t = pi_learner(a_t|x_t) / pi_target(a_t|x_t)

    `log_ratio` `[T, B]` carries the gradient through the learner's
    log-probs; the advantages `[T, B]` are targets and carry none. The
    clip is `minimum(maximum(r, lo), hi)`, as `jnp.clip` differentiates:
    at an exact bound it passes half the gradient (a tie of `maximum` or
    `minimum` splits it evenly), where `torch.clamp` would pass all of it.
    Returns (surrogate, ratio), both `[T, B]`; the loss negates the
    surrogate."""
    advantages = advantages.detach()
    ratio = torch.exp(log_ratio)
    clipped = torch.minimum(
        torch.maximum(ratio, torch.full_like(ratio, 1.0 - clip_epsilon)),
        torch.full_like(ratio, 1.0 + clip_epsilon),
    )
    return torch.minimum(ratio * advantages, clipped * advantages), ratio


@torch.no_grad()
def vtrace_reference(
    *,
    log_rhos: torch.Tensor,
    discounts: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    clip_rho_threshold: Optional[float] = 1.0,
    clip_c_threshold: Optional[float] = 1.0,
    clip_pg_rho_threshold: Optional[float] = 1.0,
    lambda_: float = 1.0,
) -> VTraceOutput:
    """V-trace in plain PyTorch: f32 `[T, B]` inputs, `[B]` bootstrap."""
    if log_rhos.dim() != 2 or bootstrap_value.shape != log_rhos.shape[1:]:
        raise ValueError(
            f"expected [T, B] inputs and a [B] bootstrap, got "
            f"{tuple(log_rhos.shape)} and {tuple(bootstrap_value.shape)}"
        )
    rhos = torch.exp(log_rhos)
    clipped_rhos = torch.clamp(rhos, max=threshold(clip_rho_threshold))
    cs = lambda_ * torch.clamp(rhos, max=threshold(clip_c_threshold))
    values_tp1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = clipped_rhos * (rewards + discounts * values_tp1 - values)
    errors = torch.empty_like(deltas)
    acc = torch.zeros_like(bootstrap_value)
    for t in reversed(range(log_rhos.shape[0])):
        acc = deltas[t] + discounts[t] * cs[t] * acc
        errors[t] = acc
    vs = values + errors
    vs_tp1 = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    clipped_pg_rhos = torch.clamp(rhos, max=threshold(clip_pg_rho_threshold))
    pg_advantages = clipped_pg_rhos * (rewards + discounts * vs_tp1 - values)
    return VTraceOutput(vs=vs, pg_advantages=pg_advantages, errors=errors)


def vtrace(
    *,
    log_rhos: torch.Tensor,
    discounts: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    clip_rho_threshold: Optional[float] = 1.0,
    clip_c_threshold: Optional[float] = 1.0,
    clip_pg_rho_threshold: Optional[float] = 1.0,
    lambda_: float = 1.0,
) -> VTraceOutput:
    """V-trace on the tensors' device: the CUDA kernel for CUDA tensors,
    `vtrace_reference` for CPU tensors, an error for anything else."""
    kwargs = dict(
        log_rhos=log_rhos,
        discounts=discounts,
        rewards=rewards,
        values=values,
        bootstrap_value=bootstrap_value,
        clip_rho_threshold=clip_rho_threshold,
        clip_c_threshold=clip_c_threshold,
        clip_pg_rho_threshold=clip_pg_rho_threshold,
        lambda_=lambda_,
    )
    if log_rhos.is_cuda:
        from torched_impala_tpu_torch.ops import vtrace_cuda

        return vtrace_cuda.vtrace_cuda(**kwargs)
    if log_rhos.device.type == "cpu":
        return vtrace_reference(**kwargs)
    raise ValueError(f"vtrace: no implementation for device {log_rhos.device}")
