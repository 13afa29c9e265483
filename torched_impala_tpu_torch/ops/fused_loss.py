"""The fused V-trace + loss epilogue (counterpart of `fused_vtrace_loss` in
`torched_impala_tpu/ops/vtrace_pallas.py`).

The separate epilogue (`ops/losses.py:impala_loss`) takes log_softmax over
the `[T, B, A]` logits three times and lets autograd build two softmax
backward chains. The fused path is one `autograd.Function` over two
kernels that each read the logits once:

- the forward reads both logit cubes and the `[T, B]` operands; per row
  it takes the logsumexp of both, log pi(a), log mu(a), the entropy and
  the log-ratio, then runs the V-trace recursion and reduces the three
  masked loss sums and the means of vs and the advantages;
- the backward recomputes p = exp(z - lse) and plp = p * log p from the
  logits and the saved row logsumexp, and writes the closed-form VJP:

    coef_pg  = -adv * mask * g_pg,   coef_ent = -mask * g_ent
    dL/dz    = p * (-coef_pg - coef_ent * H) - coef_ent * plp
               + coef_pg at the taken action
    dL/dvalues = (values - vs) * mask * g_bl

vs and adv are targets: no gradient flows through them, the bootstrap
value or the behaviour logits.

`fused_core_reference` and `fused_core_backward_reference` are the two
kernels' plain versions; `fused_core` and `fused_core_backward` dispatch
on where the tensors lie: the hand-written kernels of
`ops/fused_loss_cuda.py` for CUDA tensors, the plain versions for CPU
tensors. Only the float32 cube phase is ported (the JAX package's bf16
`train_dtype` for that phase waits for ROADMAP.md queue 1, "The learner
step's launches, then the rest of the learner").
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from torched_impala_tpu_torch.ops.vtrace import threshold, vtrace_reference


class FusedCoreOut(NamedTuple):
    """The forward's outputs: `sums` [5] f32 holds the policy-gradient,
    baseline (with its 0.5) and entropy sums, then the means of vs and of
    the advantages; vs, adv, the target logits' row logsumexp and the
    entropy are `[T, B]`, the last three kept for the backward."""

    sums: torch.Tensor
    vs: torch.Tensor
    adv: torch.Tensor
    lse: torch.Tensor
    ent: torch.Tensor


@torch.no_grad()
def fused_core_reference(
    target_logits, behaviour_logits, actions, values, bootstrap, discounts,
    rewards, mask, *, clip_rho=1.0, clip_c=1.0, clip_pg_rho=1.0, lambda_=1.0,
) -> FusedCoreOut:
    """Plain PyTorch forward: one log_softmax of each logit cube, V-trace
    (`vtrace_reference`), then sum(-adv * log pi(a) * mask),
    0.5 * sum((vs - V)^2 * mask), sum(-H * mask), mean(vs), mean(adv).
    f32 `[T, B, A]` logits, int64 `[T, B]` actions, f32 `[T, B]` operands
    and `[B]` bootstrap; clip thresholds as floats (inf disables)."""
    log_p = F.log_softmax(target_logits, dim=-1)
    plp = torch.exp(log_p) * log_p
    a = actions[..., None]
    log_pi_a = torch.gather(log_p, -1, a)[..., 0]
    log_mu_a = torch.gather(F.log_softmax(behaviour_logits, dim=-1), -1, a)[..., 0]
    ent = -torch.sum(plp, dim=-1)
    vt = vtrace_reference(
        log_rhos=log_pi_a - log_mu_a,
        discounts=discounts,
        rewards=rewards,
        values=values,
        bootstrap_value=bootstrap,
        clip_rho_threshold=clip_rho,
        clip_c_threshold=clip_c,
        clip_pg_rho_threshold=clip_pg_rho,
        lambda_=lambda_,
    )
    vs, adv = vt.vs, vt.pg_advantages
    sums = torch.stack([
        torch.sum(-adv * log_pi_a * mask),
        0.5 * torch.sum(torch.square(vs - values) * mask),
        torch.sum(-ent * mask),
        torch.mean(vs),
        torch.mean(adv),
    ])
    return FusedCoreOut(sums, vs, adv, torch.logsumexp(target_logits, dim=-1), ent)


@torch.no_grad()
def fused_core_backward_reference(
    target_logits, lse, ent, adv, vs, values, mask, actions, g_pg, g_bl, g_ent,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch backward: (dL/dz `[T, B, A]`, dL/dvalues `[T, B]`)
    from the logits, the forward's lse, entropy, adv and vs, and the
    cotangents of the three sums (0-dim tensors)."""
    log_p = target_logits - lse[..., None]
    p = torch.exp(log_p)
    plp = p * log_p
    coef_pg = -adv * mask * g_pg  # [T, B]
    coef_ent = -mask * g_ent
    c1 = -coef_pg - coef_ent * ent
    g_z = p * c1[..., None] - coef_ent[..., None] * plp
    g_z = g_z.scatter_add(-1, actions[..., None], coef_pg[..., None])
    return g_z, (values - vs) * mask * g_bl


def _on_device(name, x, cuda_fn, reference, *args, **kwargs):
    """`cuda_fn` for CUDA tensors, `reference` for CPU tensors."""
    if x.is_cuda:
        from torched_impala_tpu_torch.ops import fused_loss_cuda

        return getattr(fused_loss_cuda, cuda_fn)(*args, **kwargs)
    if x.device.type == "cpu":
        return reference(*args, **kwargs)
    raise ValueError(f"{name}: no implementation for device {x.device}")


def fused_core(*args, **kwargs) -> FusedCoreOut:
    """`fused_core_reference`'s contract on the tensors' device."""
    return _on_device("fused_core", args[0], "fused_loss_fwd", fused_core_reference,
                      *args, **kwargs)


def fused_core_backward(*args) -> tuple[torch.Tensor, torch.Tensor]:
    """`fused_core_backward_reference`'s contract on the tensors' device."""
    return _on_device("fused_core_backward", args[0], "fused_loss_bwd",
                      fused_core_backward_reference, *args)


class _FusedCore(torch.autograd.Function):
    """(pg_sum, bl_sum, ent_sum, vs_mean, adv_mean) of the loss epilogue,
    differentiable in the target logits and the values."""

    @staticmethod
    def forward(ctx, target_logits, behaviour_logits, actions, values, bootstrap,
                discounts, rewards, mask, clips):
        out = fused_core(target_logits, behaviour_logits, actions, values, bootstrap,
                         discounts, rewards, mask, **clips)
        ctx.save_for_backward(target_logits, out.lse, out.ent, out.adv, out.vs, values,
                              mask, actions)
        # The cotangents of the two means are never read: leave them None
        # rather than filled with zeros.
        ctx.set_materialize_grads(False)
        pg, bl, ent, vs_mean, adv_mean = out.sums.unbind()
        ctx.mark_non_differentiable(vs_mean, adv_mean)
        return pg, bl, ent, vs_mean, adv_mean

    @staticmethod
    def backward(ctx, g_pg, g_bl, g_ent, _g_vs_mean, _g_adv_mean):
        saved = ctx.saved_tensors
        g_pg, g_bl, g_ent = (
            torch.zeros((), device=saved[0].device) if g is None else g
            for g in (g_pg, g_bl, g_ent)
        )
        g_z, g_values = fused_core_backward(*saved, g_pg, g_bl, g_ent)
        return g_z, None, None, g_values, None, None, None, None, None


def fused_vtrace_loss(
    *,
    target_logits: torch.Tensor,
    behaviour_logits: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    actions: torch.Tensor,
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    config,
):
    """IMPALA loss with the V-trace recursion and the loss epilogue fused.

    Same contract and log dict as `ops/losses.py:impala_loss`, plus
    `mean_vtrace_target` and `mean_advantage`; `config` is an
    `ImpalaLossConfig` (its `fused_epilogue` routes `impala_loss` here)."""
    from torched_impala_tpu_torch.ops.losses import assemble_loss

    if config.train_dtype != "float32":
        raise NotImplementedError(
            f"fused_vtrace_loss: train_dtype={config.train_dtype!r} is not "
            "ported yet; only the float32 cube phase is (ROADMAP.md queue 1, "
            "\"The learner step's launches, then the rest of the learner\")"
        )
    f32 = torch.float32
    if mask is None:
        mask = torch.ones_like(rewards, dtype=f32)
    mask = mask.to(f32).contiguous()
    clips = dict(
        clip_rho=threshold(config.clip_rho_threshold),
        clip_c=threshold(config.clip_c_threshold),
        clip_pg_rho=threshold(config.clip_pg_rho_threshold),
        lambda_=float(config.lambda_),
    )
    # Each `.to` and `.contiguous` is a no-op for the learner's own
    # tensors; the behaviour policy is data (no gradient).
    pg, bl, en, vs_mean, adv_mean = _FusedCore.apply(
        target_logits.to(f32).contiguous(),
        behaviour_logits.detach().to(f32).contiguous(),
        actions.long().contiguous(),
        values.to(f32).contiguous(),
        bootstrap_value.detach().to(f32).contiguous(),
        discounts.to(f32).contiguous(),
        rewards.to(f32).contiguous(),
        mask,
        clips,
    )
    if config.reduction == "mean":
        n_valid = torch.clamp(torch.sum(mask), min=1.0)
        pg, bl, en = pg / n_valid, bl / n_valid, en / n_valid
    elif config.reduction != "sum":
        raise ValueError(f"unknown reduction: {config.reduction!r}")
    return assemble_loss(
        pg=pg,
        bl=bl,
        ent=en,
        mask=mask,
        config=config,
        extra_logs={"mean_vtrace_target": vs_mean, "mean_advantage": adv_mean},
    )
