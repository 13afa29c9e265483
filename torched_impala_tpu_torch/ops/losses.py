"""IMPALA actor-critic loss: policy gradient + baseline + entropy, time-major.

Counterpart of `torched_impala_tpu/ops/losses.py` on its separate-epilogue
path: loss = pg + vf_coef * baseline + entropy_coef * (negative entropy),
summed (or averaged) over the `[T, B]` unroll with a validity mask, where
`baseline_loss` carries its own 0.5 factor. V-trace runs on the inputs'
device (`ops/vtrace.py:vtrace`): the CUDA kernel on the card, the plain
version on the CPU. `fused_epilogue=True` routes to the fused path
(`ops/fused_loss.py:fused_vtrace_loss`, same contract and logs). Every
reduction is float32 (ops/precision.py).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Optional

import torch
import torch.nn.functional as F

from torched_impala_tpu_torch.ops.fused_loss import fused_vtrace_loss
from torched_impala_tpu_torch.ops.vtrace import vtrace


@dataclasses.dataclass(frozen=True)
class ImpalaLossConfig:
    """Hyper-parameters of the IMPALA loss (same defaults as the JAX
    package's `ImpalaLossConfig`)."""

    discount: float = 0.99
    vf_coef: float = 0.5
    entropy_coef: float = 0.01
    clip_rho_threshold: Optional[float] = 1.0
    clip_c_threshold: Optional[float] = 1.0
    clip_pg_rho_threshold: Optional[float] = 1.0
    lambda_: float = 1.0
    # 'sum' over [T, B] (the reference); 'mean' over the valid steps.
    reduction: str = "sum"
    # V-trace and the loss sums in one kernel (ops/fused_loss.py).
    fused_epilogue: bool = False
    # Not ported yet (ROADMAP.md queue 1, "The learner step's launches,
    # then the rest of the learner"): True raises, and so does
    # a train_dtype other than float32.
    health_diagnostics: bool = False
    train_dtype: str = "float32"


class LossOutput(NamedTuple):
    total: torch.Tensor
    logs: Mapping[str, torch.Tensor]


def _reduce(x: torch.Tensor, mask: torch.Tensor, reduction: str) -> torch.Tensor:
    total = torch.sum(x * mask)
    if reduction == "sum":
        return total
    if reduction == "mean":
        return total / torch.clamp(torch.sum(mask), min=1.0)
    raise ValueError(f"unknown reduction: {reduction!r}")


def action_log_probs(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """log pi(a|x) of the taken actions: logits `[..., A]`, actions `[...]`."""
    log_pi = F.log_softmax(logits, dim=-1)
    return torch.gather(log_pi, -1, actions.long()[..., None])[..., 0]


def entropy(logits: torch.Tensor) -> torch.Tensor:
    """Categorical entropy per step, `[...]` from logits `[..., A]`."""
    log_pi = F.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(log_pi) * log_pi, dim=-1)


def policy_gradient_loss(
    logits: torch.Tensor,
    actions: torch.Tensor,
    advantages: torch.Tensor,
    mask: torch.Tensor,
    reduction: str = "sum",
) -> torch.Tensor:
    """-sum(A_t * log pi(a_t|x_t)); the advantages carry no gradient."""
    log_probs = action_log_probs(logits, actions)
    return _reduce(-advantages.detach() * log_probs, mask, reduction)


def baseline_loss(
    errors: torch.Tensor, mask: torch.Tensor, reduction: str = "sum"
) -> torch.Tensor:
    """0.5 * sum((vs - V)^2); `errors` must carry gradient through V."""
    return 0.5 * _reduce(torch.square(errors), mask, reduction)


def entropy_loss(
    logits: torch.Tensor, mask: torch.Tensor, reduction: str = "sum"
) -> torch.Tensor:
    """Negative entropy: adding it with a positive coef is an entropy bonus."""
    return _reduce(-entropy(logits), mask, reduction)


# The log keys assemble_loss emits as sums over the batch under
# reduction="sum" (every other log is a per-step mean); the learner sums
# these over microbatches and averages the rest (JAX ops/losses.py:223).
SUM_REDUCED_LOG_KEYS = frozenset({"pg_loss", "baseline_loss", "entropy_loss", "total_loss"})


def assemble_loss(
    *,
    pg: torch.Tensor,
    bl: torch.Tensor,
    ent: torch.Tensor,
    mask: torch.Tensor,
    config: ImpalaLossConfig,
    extra_logs: Optional[Mapping[str, torch.Tensor]] = None,
) -> LossOutput:
    """Combine the three loss terms and build the standard log dict."""
    total = pg + config.vf_coef * bl + config.entropy_coef * ent
    logs = {
        "pg_loss": pg,
        "baseline_loss": bl,
        "entropy_loss": ent,
        "total_loss": total,
        "entropy": -ent / torch.clamp(torch.sum(mask), min=1.0)
        if config.reduction == "sum"
        else -ent,
    }
    if extra_logs:
        logs.update(extra_logs)
    return LossOutput(total=total, logs=logs)


def impala_loss(
    *,
    target_logits: torch.Tensor,
    behaviour_logits: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    actions: torch.Tensor,
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    config: ImpalaLossConfig = ImpalaLossConfig(),
) -> LossOutput:
    """Full IMPALA loss over a time-major unroll.

    Args:
      target_logits: `[T, B, A]` learner-policy logits (carry gradient).
      behaviour_logits: `[T, B, A]` actor-policy logits at act time.
      values: `[T, B]` learner baseline V(x_t) (carries gradient).
      bootstrap_value: `[B]` V(x_T).
      actions: `[T, B]` integer actions taken.
      rewards, discounts: `[T, B]`; discounts are `gamma * (1 - done)`.
      mask: `[T, B]` validity mask, ones by default.
    """
    if config.health_diagnostics:
        raise NotImplementedError(
            "health_diagnostics is not ported yet (ROADMAP.md queue 1, "
            "\"The learner step's launches, then the rest of the learner\")"
        )
    if config.fused_epilogue:
        return fused_vtrace_loss(
            target_logits=target_logits,
            behaviour_logits=behaviour_logits,
            values=values,
            bootstrap_value=bootstrap_value,
            actions=actions,
            rewards=rewards,
            discounts=discounts,
            mask=mask,
            config=config,
        )
    if config.train_dtype != "float32":
        raise NotImplementedError(
            f"train_dtype={config.train_dtype!r} is not ported yet "
            "(ROADMAP.md queue 1, \"The learner step's launches, then the rest "
            "of the learner\")"
        )
    if mask is None:
        mask = torch.ones_like(rewards)
    mask = mask.to(values.dtype)

    log_rhos = action_log_probs(target_logits, actions) - action_log_probs(
        behaviour_logits, actions
    )
    vt = vtrace(
        log_rhos=log_rhos.detach().contiguous(),
        discounts=discounts.contiguous(),
        rewards=rewards.contiguous(),
        values=values.detach().contiguous(),
        bootstrap_value=bootstrap_value.detach().contiguous(),
        clip_rho_threshold=config.clip_rho_threshold,
        clip_c_threshold=config.clip_c_threshold,
        clip_pg_rho_threshold=config.clip_pg_rho_threshold,
        lambda_=config.lambda_,
    )
    pg = policy_gradient_loss(
        target_logits, actions, vt.pg_advantages, mask, config.reduction
    )
    # The baseline regresses the live values towards the constant targets.
    bl = baseline_loss(vt.vs - values, mask, config.reduction)
    ent = entropy_loss(target_logits, mask, config.reduction)
    extra = {
        "mean_vtrace_target": torch.mean(vt.vs),
        "mean_advantage": torch.mean(vt.pg_advantages),
    }
    return assemble_loss(
        pg=pg, bl=bl, ent=ent, mask=mask, config=config, extra_logs=extra
    )
