"""PopArt: adaptive value normalization with output preservation
(counterpart of `torched_impala_tpu/ops/popart.py`).

The PopArt-IMPALA scheme (van Hasselt et al. 2016; Hessel et al. 2018,
"Multi-task Deep RL with PopArt") of the DMLab-30 preset: the value head
predicts *normalized* per-task values; running first and second moments
of the V-trace targets define a per-task affine `(mu, sigma)`; and every
statistics update rescales the value head so that its *unnormalized*
outputs are preserved ("Preserving Outputs Precisely").

Every function is pure over a `PopArtState` of float32 tensors on the
caller's device and makes no device-to-host copy:

- the per-task moments are a scatter-add over the task ids (`index_add_`
  in float32, not a one-hot product, which TF32 would round on the card);
- the head rescale is two elementwise ops on `value_head.weight` and
  `value_head.bias`. The port's head is an `nn.Linear` with weight
  `[K, F]` (flax's kernel is `[F, K]`), so a task's row is scaled.

Task ids `[B]` must lie in `[0, num_values)`: the ops index with them as
they are, and nothing here checks them (the learner's caller refuses
others on the host, as JAX's `_validate_tasks` does).

Loss semantics (the PopArt-IMPALA paper's):
- V-trace runs in UNNORMALIZED space, under the pre-update statistics,
  through `ops/vtrace.py:vtrace`: the CUDA kernel for CUDA tensors, the
  plain version for CPU tensors. JAX's `devices` and
  `vtrace_implementation` arguments have no counterpart: the tensors'
  device picks the implementation;
- the baseline regresses normalized predictions onto normalized targets,
  both under the POST-update statistics; the predictions re-expressed
  as (s_old * n + mu_old - mu_new) / s_new keep their gradient, scaled
  by s_old / s_new;
- policy-gradient advantages are divided by sigma, making the actor's
  gradient scale task-invariant.

Gradients stop where JAX's do: at V-trace's inputs (so `norm_bootstrap`
gets none), at the new statistics, and at IMPACT's target logits.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Optional

import torch

from torched_impala_tpu_torch.ops.losses import (
    ImpalaLossConfig,
    LossOutput,
    _reduce,
    _vtrace,
    action_log_probs,
    assemble_loss,
    baseline_loss,
    entropy_loss,
    health_diagnostics_logs,
    policy_gradient_loss,
)
from torched_impala_tpu_torch.ops.vtrace import clipped_surrogate


@dataclasses.dataclass(frozen=True)
class PopArtConfig:
    """Static PopArt hyper-parameters. Defaults follow Hessel et al. 2018:
    step size 3e-4, sigma clipped to [1e-4, 1e6]."""

    num_values: int = 1
    step_size: float = 3e-4
    sigma_min: float = 1e-4
    sigma_max: float = 1e6


class PopArtState(NamedTuple):
    """Running per-task moments of the value targets: mu `[num_values]`
    first moment, nu `[num_values]` second moment, float32. sigma is
    derived, not stored: sqrt(nu - mu^2), clipped."""

    mu: torch.Tensor
    nu: torch.Tensor


def init(num_values: int, device=None) -> PopArtState:
    """Identity normalization: mu = 0, nu = 1, so sigma = 1."""
    return PopArtState(
        mu=torch.zeros(num_values, dtype=torch.float32, device=device),
        nu=torch.ones(num_values, dtype=torch.float32, device=device),
    )


def sigma(state: PopArtState, config: PopArtConfig) -> torch.Tensor:
    """Per-task scale `[num_values]`, clipped away from 0 and infinity."""
    var = state.nu - torch.square(state.mu)
    return torch.clamp(
        torch.sqrt(torch.clamp(var, min=0.0)), config.sigma_min, config.sigma_max
    )


def normalize(
    state: PopArtState, config: PopArtConfig, x: torch.Tensor, tasks: torch.Tensor
) -> torch.Tensor:
    """(x - mu[task]) / sigma[task]; `tasks` broadcasts against x."""
    tasks = tasks.long()
    return (x - state.mu[tasks]) / sigma(state, config)[tasks]


def unnormalize(
    state: PopArtState, config: PopArtConfig, x: torch.Tensor, tasks: torch.Tensor
) -> torch.Tensor:
    """sigma[task] * x + mu[task]."""
    tasks = tasks.long()
    return sigma(state, config)[tasks] * x + state.mu[tasks]


def batch_moments(
    config: PopArtConfig,
    targets: torch.Tensor,
    tasks: torch.Tensor,
    mask: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-task (count, sum, sum of squares) of the `[T, B]` targets under
    the `[T, B]` mask, each `[num_values]`, `tasks` `[B]`. Additive across
    sub-batches: the moments of G microbatches sum to the full batch's,
    which gradient accumulation's batch-end statistics update rests on."""
    mask = mask.to(targets.dtype)
    per_env = torch.stack(
        [
            torch.sum(mask, dim=0),
            torch.sum(targets * mask, dim=0),
            torch.sum(torch.square(targets) * mask, dim=0),
        ]
    )  # [3, B]
    moments = torch.zeros(
        3, config.num_values, dtype=targets.dtype, device=targets.device
    ).index_add_(1, tasks.long(), per_env)
    return moments[0], moments[1], moments[2]


def apply_moments(
    state: PopArtState,
    config: PopArtConfig,
    cnt: torch.Tensor,
    tot: torch.Tensor,
    tot_sq: torch.Tensor,
) -> PopArtState:
    """One EMA step of (mu, nu) towards the moments' per-task means.
    Tasks with no valid sample keep their statistics."""
    present = cnt > 0
    denom = torch.clamp(cnt, min=1.0)
    batch_mu = tot / denom
    batch_nu = tot_sq / denom
    b = config.step_size
    mu = torch.where(present, state.mu + b * (batch_mu - state.mu), state.mu)
    nu = torch.where(present, state.nu + b * (batch_nu - state.nu), state.nu)
    return PopArtState(mu=mu, nu=nu)


def update(
    state: PopArtState,
    config: PopArtConfig,
    targets: torch.Tensor,
    tasks: torch.Tensor,
    mask: torch.Tensor,
) -> PopArtState:
    """One EMA step of (mu, nu) towards the batch's per-task target
    moments: `apply_moments(batch_moments(...))`."""
    return apply_moments(state, config, *batch_moments(config, targets, tasks, mask))


def rescale_head(
    weight: torch.Tensor,
    bias: torch.Tensor,
    old: PopArtState,
    new: PopArtState,
    config: PopArtConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Preserve outputs precisely across a statistics update.

    The head `[K, F]` weight, `[K]` bias emits normalized values
    n(x) = W f + b, read unnormalized as sigma * n + mu. W' = W sigma /
    sigma' (row by row) and b' = (sigma b + mu - mu') / sigma' keep
    sigma' n'(x) + mu' == sigma n(x) + mu for every x."""
    s_old = sigma(old, config)
    s_new = sigma(new, config)
    weight = weight * (s_old / s_new)[:, None]
    bias = (s_old * bias + old.mu - new.mu) / s_new
    return weight, bias


def rescale_params(
    params: Mapping[str, torch.Tensor],
    old: PopArtState,
    new: PopArtState,
    config: PopArtConfig,
) -> dict:
    """`rescale_head` applied to `value_head.weight` and `value_head.bias`
    of a state-dict-like mapping (the names `models/nets.py:ImpalaNet`
    gives its value head). Returns a new dict; `params` is not changed."""
    weight, bias = rescale_head(
        params["value_head.weight"], params["value_head.bias"], old, new, config)
    return {**params, "value_head.weight": weight, "value_head.bias": bias}


def _unnormalized_vtrace(
    *,
    target_logits,
    behaviour_logits,
    norm_values,
    norm_bootstrap,
    actions,
    rewards,
    discounts,
    tasks,
    state: PopArtState,
    popart_config: PopArtConfig,
    config: ImpalaLossConfig,
):
    """V-trace in unnormalized space under the PRE-update statistics, on
    detached inputs (the targets are constants). Shared by the loss and
    gradient accumulation's statistics pass."""
    tasks = tasks.long()
    s_old = sigma(state, popart_config)[tasks]  # [B]
    mu_old = state.mu[tasks]
    values_un = s_old * norm_values.detach() + mu_old
    boot_un = s_old * norm_bootstrap.detach() + mu_old
    log_rhos = action_log_probs(target_logits, actions) - action_log_probs(
        behaviour_logits, actions
    )
    return _vtrace(log_rhos, values_un, boot_un, rewards, discounts, config)


def popart_target_moments(
    *,
    target_logits: torch.Tensor,
    behaviour_logits: torch.Tensor,
    norm_values: torch.Tensor,
    norm_bootstrap: torch.Tensor,
    actions: torch.Tensor,
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    tasks: torch.Tensor,
    state: PopArtState,
    popart_config: PopArtConfig,
    config: ImpalaLossConfig = ImpalaLossConfig(),
    mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-task (count, sum, sum of squares) of one (micro)batch's V-trace
    targets: the forward-only statistics pass of gradient accumulation.
    Summing them over the G microbatches and calling `apply_moments` once
    gives the full batch's `update`; the gradient pass then runs
    `popart_impala_loss` with `fixed_new_state` set to that result."""
    if mask is None:
        mask = torch.ones_like(rewards)
    vt = _unnormalized_vtrace(
        target_logits=target_logits,
        behaviour_logits=behaviour_logits,
        norm_values=norm_values,
        norm_bootstrap=norm_bootstrap,
        actions=actions,
        rewards=rewards,
        discounts=discounts,
        tasks=tasks,
        state=state,
        popart_config=popart_config,
        config=config,
    )
    return batch_moments(popart_config, vt.vs, tasks, mask.to(vt.vs.dtype))


def _health_logs(
    *, learner_logits, target_logits, behaviour_logits, actions, norm_values,
    s_old, mu_old, vs, mask, config,
):
    """The health diagnostics of a PopArt loss: the V-trace pass's
    log-ratios and unnormalized values, recomputed detached."""
    log_rhos = action_log_probs(target_logits, actions) - action_log_probs(
        behaviour_logits, actions
    )
    return health_diagnostics_logs(
        learner_logits=learner_logits,
        behaviour_logits=behaviour_logits,
        log_rhos=log_rhos,
        values=s_old * norm_values.detach() + mu_old,
        vs=vs,
        mask=mask,
        config=config,
    )


def popart_impala_loss(
    *,
    target_logits: torch.Tensor,
    behaviour_logits: torch.Tensor,
    norm_values: torch.Tensor,
    norm_bootstrap: torch.Tensor,
    actions: torch.Tensor,
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    tasks: torch.Tensor,
    state: PopArtState,
    popart_config: PopArtConfig,
    config: ImpalaLossConfig = ImpalaLossConfig(),
    mask: Optional[torch.Tensor] = None,
    fixed_new_state: Optional[PopArtState] = None,
) -> tuple[LossOutput, PopArtState]:
    """IMPALA loss with PopArt normalization; returns (LossOutput, the
    updated statistics).

    Args:
      target_logits: `[T, B, A]` learner-policy logits (carry gradient).
      behaviour_logits: `[T, B, A]`.
      norm_values: `[T, B]` normalized V of each env's task column (carry
        gradient); norm_bootstrap: `[B]` normalized V(x_T) (gets none).
      actions, rewards, discounts, mask: `[T, B]`, as in `impala_loss`.
      tasks: `[B]` task ids in `[0, num_values)`.
      fixed_new_state: post-update statistics made by the caller
        (gradient accumulation: `popart_target_moments` over the
        microbatches, then `apply_moments` once). When given, the loss's
        own `update` is skipped and the loss is expressed under these
        statistics, so each microbatch's loss is its slice of the full
        batch's.

    After the optimizer step the caller applies `rescale_params` with the
    same (old, new) pair, so the net's unnormalized outputs stay where
    they were. `config.fused_epilogue` is not read: this loss has no fused
    path (JAX's learner refuses PopArt with it)."""
    if mask is None:
        mask = torch.ones_like(rewards)
    mask = mask.to(norm_values.dtype)
    tasks = tasks.long()
    s_old = sigma(state, popart_config)[tasks]  # [B]
    mu_old = state.mu[tasks]
    vt = _unnormalized_vtrace(
        target_logits=target_logits,
        behaviour_logits=behaviour_logits,
        norm_values=norm_values,
        norm_bootstrap=norm_bootstrap,
        actions=actions,
        rewards=rewards,
        discounts=discounts,
        tasks=tasks,
        state=state,
        popart_config=popart_config,
        config=config,
    )
    if fixed_new_state is None:
        fixed_new_state = update(state, popart_config, vt.vs, tasks, mask)
    new_state = PopArtState(*(x.detach() for x in fixed_new_state))
    s_new = sigma(new_state, popart_config)[tasks]
    mu_new = new_state.mu[tasks]
    # The live predictions under the POST-update statistics: the affine
    # correction rescale_params gives the head, so the regression target
    # and the (future) net agree.
    norm_values_new = (s_old * norm_values + mu_old - mu_new) / s_new
    norm_targets = (vt.vs - mu_new) / s_new
    pg = policy_gradient_loss(
        target_logits, actions, vt.pg_advantages / s_new, mask, config.reduction
    )
    bl = baseline_loss(norm_targets - norm_values_new, mask, config.reduction)
    ent = entropy_loss(target_logits, mask, config.reduction)
    extra = {
        "mean_vtrace_target": torch.mean(vt.vs),
        "mean_advantage": torch.mean(vt.pg_advantages),
        "popart_mu_mean": torch.mean(new_state.mu),
        "popart_sigma_mean": torch.mean(sigma(new_state, popart_config)),
    }
    if config.health_diagnostics:
        extra.update(
            _health_logs(
                learner_logits=target_logits, target_logits=target_logits,
                behaviour_logits=behaviour_logits, actions=actions,
                norm_values=norm_values, s_old=s_old, mu_old=mu_old, vs=vt.vs,
                mask=mask, config=config,
            )
        )
    out = assemble_loss(pg=pg, bl=bl, ent=ent, mask=mask, config=config, extra_logs=extra)
    return out, new_state


def popart_impact_loss(
    *,
    learner_logits: torch.Tensor,
    target_logits: torch.Tensor,
    behaviour_logits: torch.Tensor,
    norm_values: torch.Tensor,
    norm_bootstrap: torch.Tensor,
    actions: torch.Tensor,
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    tasks: torch.Tensor,
    state: PopArtState,
    popart_config: PopArtConfig,
    clip_epsilon: float = 0.2,
    config: ImpalaLossConfig = ImpalaLossConfig(),
    mask: Optional[torch.Tensor] = None,
) -> tuple[LossOutput, PopArtState]:
    """IMPACT's clipped-target surrogate under PopArt normalization (JAX
    `ops/popart.py:popart_impact_loss`):

    - V-trace runs in unnormalized space anchored on the pinned TARGET
      policy (rho, c and the pg advantage take pi_target / mu, as
      `losses.impact_loss`), on the live net's normalized values
      unnormalized under the PRE-update statistics;
    - the optimized policy term is the clipped surrogate
      (`ops/vtrace.py:clipped_surrogate`) on r = pi_theta / pi_target with
      the advantages divided by the POST-update sigma;
    - the baseline and the statistics update are `popart_impala_loss`'s,
      so the caller applies `rescale_params` with the returned (old, new)
      pair as on the on-policy path.

    `learner_logits` carry the gradient, `target_logits` are detached
    here. Returns (LossOutput, new PopArtState); the logs add the
    `impact_*` and `popart_*` gauges."""
    if mask is None:
        mask = torch.ones_like(rewards)
    mask = mask.to(norm_values.dtype)
    tasks = tasks.long()
    target_logits = target_logits.detach()
    s_old = sigma(state, popart_config)[tasks]  # [B]
    mu_old = state.mu[tasks]
    vt = _unnormalized_vtrace(
        target_logits=target_logits,
        behaviour_logits=behaviour_logits,
        norm_values=norm_values,
        norm_bootstrap=norm_bootstrap,
        actions=actions,
        rewards=rewards,
        discounts=discounts,
        tasks=tasks,
        state=state,
        popart_config=popart_config,
        config=config,
    )
    new_state = PopArtState(
        *(x.detach() for x in update(state, popart_config, vt.vs, tasks, mask))
    )
    s_new = sigma(new_state, popart_config)[tasks]
    mu_new = new_state.mu[tasks]
    norm_values_new = (s_old * norm_values + mu_old - mu_new) / s_new
    norm_targets = (vt.vs - mu_new) / s_new

    target_lp = action_log_probs(target_logits, actions)
    log_ratio = action_log_probs(learner_logits, actions) - target_lp
    surrogate, ratio = clipped_surrogate(log_ratio, vt.pg_advantages / s_new, clip_epsilon)
    pg = _reduce(-surrogate, mask, config.reduction)
    bl = baseline_loss(norm_targets - norm_values_new, mask, config.reduction)
    ent = entropy_loss(learner_logits, mask, config.reduction)
    ratio = ratio.detach()
    n_valid = torch.clamp(torch.sum(mask), min=1.0)
    clipped = torch.abs(ratio - 1.0) > clip_epsilon
    extra = {
        "mean_vtrace_target": torch.mean(vt.vs),
        "mean_advantage": torch.mean(vt.pg_advantages),
        "impact_ratio": torch.sum(ratio * mask) / n_valid,
        "impact_clip_frac": torch.sum(clipped * mask) / n_valid,
        "popart_mu_mean": torch.mean(new_state.mu),
        "popart_sigma_mean": torch.mean(sigma(new_state, popart_config)),
    }
    if config.health_diagnostics:
        # The KL and the entropy diagnose the live policy; the log-ratios
        # stay the target-anchored V-trace weights.
        extra.update(
            _health_logs(
                learner_logits=learner_logits, target_logits=target_logits,
                behaviour_logits=behaviour_logits, actions=actions,
                norm_values=norm_values, s_old=s_old, mu_old=mu_old, vs=vt.vs,
                mask=mask, config=config,
            )
        )
    out = assemble_loss(pg=pg, bl=bl, ent=ent, mask=mask, config=config, extra_logs=extra)
    return out, new_state
