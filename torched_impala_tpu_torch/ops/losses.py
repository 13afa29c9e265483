"""IMPALA actor-critic loss: policy gradient + baseline + entropy, time-major.

Counterpart of `torched_impala_tpu/ops/losses.py` on its separate-epilogue
path: loss = pg + vf_coef * baseline + entropy_coef * (negative entropy),
summed (or averaged) over the `[T, B]` unroll with a validity mask, where
`baseline_loss` carries its own 0.5 factor. V-trace runs on the inputs'
device (`ops/vtrace.py:vtrace`): the CUDA kernel on the card, the plain
version on the CPU. `fused_epilogue=True` routes to the fused path
(`ops/fused_loss.py:fused_vtrace_loss`, same contract and logs). Every
reduction is float32 (ops/precision.py). `health_diagnostics=True` adds
the training-health logs (`health_diagnostics_logs`) on either path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, NamedTuple, Optional

import torch
import torch.nn.functional as F

from torched_impala_tpu_torch.ops.fused_loss import fused_vtrace_loss
from torched_impala_tpu_torch.ops.vtrace import threshold, vtrace


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
    # Training-health diagnostics: `health_`-prefixed scalar reductions
    # over tensors of the loss (health_diagnostics_logs), all without
    # gradient; telemetry/health.py republishes them as health/* gauges.
    # False is the loss as it is without them, op for op.
    health_diagnostics: bool = False
    # The train step's compute dtype (the learner's, through
    # configs.make_learner_config). The unfused loss ignores it: its
    # inputs are the float32 heads' outputs. With fused_epilogue it would
    # select the [T, B, A] phase's dtype, where only float32 is ported
    # (ops/fused_loss.py raises for bfloat16).
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


# Fixed log-space bin edges of the pre-clip IS-weight histogram (JAX's):
# log(rho) in (-inf,-2), [-2,-1), [-1,-0.5), [-0.5,0), [0,0.5), [0.5,1),
# [1,2), [2,inf). Exactly on-policy data piles into bin 4 (log rho = 0).
HEALTH_LOGRHO_EDGES = (-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0)


def health_diagnostics_logs(
    *,
    learner_logits: torch.Tensor,
    behaviour_logits: torch.Tensor,
    log_rhos: torch.Tensor,
    values: torch.Tensor,
    vs: torch.Tensor,
    mask: torch.Tensor,
    config: ImpalaLossConfig,
) -> dict:
    """Training-health diagnostics (JAX `ops/losses.py:health_diagnostics_logs`):
    masked per-step means over tensors the loss already holds, every
    input detached, as `health_`-prefixed device scalars:

      clip_rho_frac / clip_c_frac — share of valid steps whose pre-clip
        weight exp(log_rhos) exceeds the rho / c clip threshold;
      clip_logrho_mean / clip_logrho_std — moments of log_rhos, the std
        as sqrt(max(E[x^2] - E[x]^2, 0));
      clip_logrho_bin0..7 — shares in the bins lo <= x < hi of
        HEALTH_LOGRHO_EDGES, with -inf and inf at the ends;
      entropy_mean — entropy of the learner's policy;
      kl_behaviour_learner — KL(mu || pi) = sum exp(log mu)(log mu - log pi);
      ev_value — 1 - Var(vs - V) / max(Var(vs), 1e-8), both variances
        around their masked means.

    The means divide by max(sum(mask), 1). The masked sums of the first
    pass run as one reduction over a stack of the per-step terms, then
    the two variances as another."""
    learner_logits, behaviour_logits, log_rhos, values, vs, mask = (
        x.detach() for x in (learner_logits, behaviour_logits, log_rhos, values, vs, mask)
    )
    dtype = values.dtype
    n = torch.clamp(torch.sum(mask), min=1.0)

    def masked_mean(x):  # [K, T, B] -> [K]
        return torch.sum((x * mask).flatten(1), dim=1) / n

    rhos = torch.exp(log_rhos)
    lo_edges = (-math.inf,) + HEALTH_LOGRHO_EDGES
    hi_edges = HEALTH_LOGRHO_EDGES + (math.inf,)
    # Python-scalar edges: no host-to-device copy in the step.
    in_bin = torch.stack([(log_rhos >= lo) & (log_rhos < hi) for lo, hi in zip(lo_edges, hi_edges)])
    log_pi = F.log_softmax(learner_logits, dim=-1)
    log_mu = F.log_softmax(behaviour_logits, dim=-1)
    err = vs - values
    first = masked_mean(
        torch.cat(
            [
                torch.stack(
                    [
                        (rhos > threshold(config.clip_rho_threshold)).to(dtype),
                        (rhos > threshold(config.clip_c_threshold)).to(dtype),
                        log_rhos,
                        torch.square(log_rhos),
                        -torch.sum(torch.exp(log_pi) * log_pi, dim=-1),
                        torch.sum(torch.exp(log_mu) * (log_mu - log_pi), dim=-1),
                        vs,
                        err,
                    ]
                ),
                in_bin.to(dtype),
            ]
        )
    )
    clip_rho, clip_c, logrho_mean, logrho_sq, ent, kl, vs_mean, err_mean = first[:8]
    vs_var, err_var = masked_mean(
        torch.square(torch.stack([vs - vs_mean, err - err_mean]))
    )
    logs = {
        "health_clip_rho_frac": clip_rho,
        "health_clip_c_frac": clip_c,
        "health_clip_logrho_mean": logrho_mean,
        "health_clip_logrho_std": torch.sqrt(
            torch.clamp(logrho_sq - torch.square(logrho_mean), min=0.0)
        ),
    }
    for i in range(len(lo_edges)):
        logs[f"health_clip_logrho_bin{i}"] = first[8 + i]
    logs["health_entropy_mean"] = ent
    logs["health_kl_behaviour_learner"] = kl
    logs["health_ev_value"] = 1.0 - err_var / torch.clamp(vs_var, min=1e-8)
    return logs


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


def _vtrace(log_rhos, values, bootstrap_value, rewards, discounts, config):
    """V-trace on the loss's tensors, none of them carrying gradient."""
    return vtrace(
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
    if config.fused_epilogue:
        out = fused_vtrace_loss(
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
        if not config.health_diagnostics:
            return out
        # The fused kernel keeps no log-ratios or vs: a second V-trace
        # pass on detached inputs recomputes them for the diagnostics (on
        # the card it launches the V-trace kernel), as JAX's fused path
        # does.
        log_rhos = action_log_probs(target_logits.detach(), actions) - action_log_probs(
            behaviour_logits, actions
        )
        vt = _vtrace(log_rhos, values, bootstrap_value, rewards, discounts, config)
        logs = dict(out.logs)
        logs.update(
            health_diagnostics_logs(
                learner_logits=target_logits,
                behaviour_logits=behaviour_logits,
                log_rhos=log_rhos,
                values=values,
                vs=vt.vs,
                mask=(torch.ones_like(rewards) if mask is None else mask).to(values.dtype),
                config=config,
            )
        )
        return LossOutput(total=out.total, logs=logs)
    if mask is None:
        mask = torch.ones_like(rewards)
    mask = mask.to(values.dtype)

    log_rhos = action_log_probs(target_logits, actions) - action_log_probs(
        behaviour_logits, actions
    )
    vt = _vtrace(log_rhos, values, bootstrap_value, rewards, discounts, config)
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
    if config.health_diagnostics:
        extra.update(
            health_diagnostics_logs(
                learner_logits=target_logits,
                behaviour_logits=behaviour_logits,
                log_rhos=log_rhos,
                values=values,
                vs=vt.vs,
                mask=mask,
                config=config,
            )
        )
    return assemble_loss(
        pg=pg, bl=bl, ent=ent, mask=mask, config=config, extra_logs=extra
    )
