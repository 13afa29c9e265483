"""The fused V-trace + loss epilogue (counterpart of `fused_vtrace_loss` in
`torched_impala_tpu/ops/vtrace_pallas.py`).

The separate epilogue (`ops/losses.py:impala_loss`) takes log_softmax over
the `[T, B, A]` logits three times and lets autograd build two softmax
backward chains. The fused path takes ONE log_softmax, hands the `[T, B]`
scalars (log pi(a), entropy, log-ratios) to a kernel that runs the V-trace
recursion and reduces the three masked loss sums beside it, and
backpropagates through one closed-form VJP. With p = softmax(z) and
plp = p * log p saved from the forward:

    coef_pg  = -adv * mask * g_pg,   coef_ent = -mask * g_ent
    dL/dz    = p * (-coef_pg - coef_ent * H) - coef_ent * plp
               + coef_pg scattered at the taken actions
    dL/dvalues = (values - vs) * mask * g_bl

vs and adv are targets: no gradient flows through them, the bootstrap
value or the behaviour logits.

`fused_sums_reference` is the kernel's plain version (the V-trace of
`ops/vtrace.py:vtrace_reference`, then the three sums); `fused_sums`
dispatches on where the tensors lie: the hand-written kernel of
`ops/fused_loss_cuda.py` for CUDA tensors, the plain version for CPU
tensors. Only the float32 cube phase is ported (the JAX package's bf16
`train_dtype` for that phase waits for ROADMAP.md queue 1 item 7).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from torched_impala_tpu_torch.ops.vtrace import threshold, vtrace_reference


class FusedSums(NamedTuple):
    """The kernel's outputs: the three masked loss sums (f32 scalars) and
    the V-trace targets and advantages `[T, B]`."""

    pg: torch.Tensor
    bl: torch.Tensor
    ent: torch.Tensor
    vs: torch.Tensor
    adv: torch.Tensor


@torch.no_grad()
def fused_sums_reference(
    log_pi_a, ent, values, bootstrap, log_rhos, discounts, rewards, mask,
    *, clip_rho=1.0, clip_c=1.0, clip_pg_rho=1.0, lambda_=1.0,
) -> FusedSums:
    """Plain PyTorch: V-trace, then sum(-adv * log pi(a) * mask),
    0.5 * sum((vs - V)^2 * mask) and sum(-H * mask). f32 `[T, B]` inputs,
    `[B]` bootstrap; clip thresholds as floats (inf disables)."""
    vt = vtrace_reference(
        log_rhos=log_rhos,
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
    return FusedSums(
        pg=torch.sum(-adv * log_pi_a * mask),
        bl=0.5 * torch.sum(torch.square(vs - values) * mask),
        ent=torch.sum(-ent * mask),
        vs=vs,
        adv=adv,
    )


def fused_sums(*args, **kwargs) -> FusedSums:
    """`fused_sums_reference`'s contract on the tensors' device: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    x = args[0]
    if x.is_cuda:
        from torched_impala_tpu_torch.ops import fused_loss_cuda

        return fused_loss_cuda.fused_sums_cuda(*args, **kwargs)
    if x.device.type == "cpu":
        return fused_sums_reference(*args, **kwargs)
    raise ValueError(f"fused_vtrace_loss: no implementation for device {x.device}")


class _FusedCore(torch.autograd.Function):
    """(pg_sum, bl_sum, ent_sum, vs_mean, adv_mean) of the loss epilogue,
    differentiable in the target logits and the values."""

    @staticmethod
    def forward(ctx, target_logits, actions, values, bootstrap, log_mu_a,
                discounts, rewards, mask, clips):
        log_p = F.log_softmax(target_logits, dim=-1)  # [T, B, A]
        p = torch.exp(log_p)
        plp = p * log_p
        log_pi_a = torch.gather(log_p, -1, actions[..., None])[..., 0]
        ent = -torch.sum(plp, dim=-1)
        out = fused_sums(
            log_pi_a.contiguous(), ent.contiguous(), values, bootstrap,
            (log_pi_a - log_mu_a).contiguous(), discounts, rewards, mask,
            **clips,
        )
        ctx.save_for_backward(p, plp, ent, out.adv, out.vs, values, mask, actions)
        means = (torch.mean(out.vs), torch.mean(out.adv))
        ctx.mark_non_differentiable(*means)
        return out.pg, out.bl, out.ent, *means

    @staticmethod
    def backward(ctx, g_pg, g_bl, g_ent, _g_vs_mean, _g_adv_mean):
        p, plp, ent, adv, vs, values, mask, actions = ctx.saved_tensors
        coef_pg = -adv * mask * g_pg  # [T, B]
        coef_ent = -mask * g_ent
        c1 = -coef_pg - coef_ent * ent
        g_z = p * c1[..., None] - coef_ent[..., None] * plp
        g_z = g_z.scatter_add(-1, actions[..., None], coef_pg[..., None])
        g_values = (values - vs) * mask * g_bl
        return g_z, None, g_values, None, None, None, None, None, None


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
            "item 7)"
        )
    f32 = torch.float32
    if mask is None:
        mask = torch.ones_like(rewards, dtype=f32)
    mask = mask.to(f32).contiguous()
    actions = actions.long()
    # The behaviour policy is data: its log-prob of the taken action is
    # all the recursion needs.
    log_mu = F.log_softmax(behaviour_logits.detach().to(f32), dim=-1)
    log_mu_a = torch.gather(log_mu, -1, actions[..., None])[..., 0]
    clips = dict(
        clip_rho=threshold(config.clip_rho_threshold),
        clip_c=threshold(config.clip_c_threshold),
        clip_pg_rho=threshold(config.clip_pg_rho_threshold),
        lambda_=float(config.lambda_),
    )
    pg, bl, en, vs_mean, adv_mean = _FusedCore.apply(
        target_logits.to(f32),
        actions,
        values.to(f32).contiguous(),
        bootstrap_value.detach().to(f32).contiguous(),
        log_mu_a,
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
