"""The port's fused V-trace loss held against the JAX package.

Same numpy inputs (T=5, B=4, A=6, a mask with zeros) go through the JAX
`fused_vtrace_loss` (its Pallas kernel in interpret mode, and its 'xla'
path) and the port's `fused_vtrace_loss` on the CPU, where the kernel's
plain version runs. The total, every log and the gradients with respect
to the logits and the values agree at rtol 1e-5, atol 1e-6: f32, the
same formulas, only the summation order of the reductions may differ.
The port's fused path is also held to its own separate `impala_loss` at
the same tolerance (the JAX package pins the two equal in f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torched_impala_tpu.ops import losses as jax_losses
from torched_impala_tpu.ops.vtrace_pallas import fused_vtrace_loss as jax_fused
from torched_impala_tpu_torch.ops import fused_loss
from torched_impala_tpu_torch.ops import losses as port_losses

T, B, A = 5, 4, 6
TOL = dict(rtol=1e-5, atol=1e-6)
CLIPS = {
    "default": dict(),
    "none": dict(clip_rho_threshold=None, clip_c_threshold=None, clip_pg_rho_threshold=None),
    "half_two": dict(clip_rho_threshold=0.5, clip_c_threshold=2.0, clip_pg_rho_threshold=2.0),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return dict(
        target_logits=rng.normal(size=(T, B, A)).astype(np.float32),
        behaviour_logits=rng.normal(size=(T, B, A)).astype(np.float32),
        values=rng.normal(size=(T, B)).astype(np.float32),
        bootstrap_value=rng.normal(size=(B,)).astype(np.float32),
        actions=rng.integers(0, A, size=(T, B)).astype(np.int32),
        rewards=rng.normal(size=(T, B)).astype(np.float32),
        discounts=(0.99 * (rng.uniform(size=(T, B)) > 0.2)).astype(np.float32),
        mask=(rng.uniform(size=(T, B)) > 0.25).astype(np.float32),
    )


def _jax(x, cfg, implementation):
    def f(logits, values):
        out = jax_fused(
            target_logits=logits,
            behaviour_logits=jnp.asarray(x["behaviour_logits"]),
            values=values,
            bootstrap_value=jnp.asarray(x["bootstrap_value"]),
            actions=jnp.asarray(x["actions"]),
            rewards=jnp.asarray(x["rewards"]),
            discounts=jnp.asarray(x["discounts"]),
            mask=jnp.asarray(x["mask"]),
            config=cfg,
            implementation=implementation,
        )
        return out.total, out.logs

    (total, logs), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x["target_logits"]), jnp.asarray(x["values"])
    )
    return total, logs, grads


def _port(x, cfg):
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    leaves = [t["target_logits"].requires_grad_(), t["values"].requires_grad_()]
    out = port_losses.impala_loss(**t, config=cfg)
    grads = torch.autograd.grad(out.total, leaves)
    return out.total.detach(), {k: v.detach() for k, v in out.logs.items()}, grads


@pytest.mark.parametrize("reduction", ["sum", "mean"])
@pytest.mark.parametrize("clips", sorted(CLIPS))
@pytest.mark.parametrize("implementation", ["kernel", "xla"])
def test_fused_loss_and_grads_match_jax(implementation, clips, reduction):
    x = _inputs(len(clips) + len(reduction))
    jcfg = jax_losses.ImpalaLossConfig(fused_epilogue=True, reduction=reduction, **CLIPS[clips])
    pcfg = port_losses.ImpalaLossConfig(fused_epilogue=True, reduction=reduction, **CLIPS[clips])
    j_total, j_logs, j_grads = _jax(x, jcfg, implementation)
    p_total, p_logs, p_grads = _port(x, pcfg)
    np.testing.assert_allclose(float(p_total), float(j_total), **TOL)
    assert set(j_logs) == set(p_logs)
    assert {"mean_vtrace_target", "mean_advantage"} <= set(p_logs)
    for key in j_logs:
        np.testing.assert_allclose(float(p_logs[key]), float(j_logs[key]), **TOL, err_msg=key)
    for p, j in zip(p_grads, j_grads):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("reduction", ["sum", "mean"])
@pytest.mark.parametrize("clips", sorted(CLIPS))
def test_fused_equals_separate_epilogue(clips, reduction):
    x = _inputs(7)
    outs = [
        _port(x, port_losses.ImpalaLossConfig(fused_epilogue=f, reduction=reduction, **CLIPS[clips]))
        for f in (True, False)
    ]
    (f_total, f_logs, f_grads), (s_total, s_logs, s_grads) = outs
    torch.testing.assert_close(f_total, s_total, **TOL)
    for key in s_logs:
        torch.testing.assert_close(f_logs[key], s_logs[key], **TOL)
    for a, b in zip(f_grads, s_grads):
        torch.testing.assert_close(a, b, **TOL)


def test_targets_bootstrap_and_behaviour_carry_no_gradient():
    """vs and adv are constants: the bootstrap value and the behaviour
    logits get a zero gradient, and so do the mask, rewards and
    discounts; only the target logits and the values carry one."""
    t = {k: torch.from_numpy(v) for k, v in _inputs(3).items()}
    float_leaves = ("target_logits", "behaviour_logits", "values", "bootstrap_value",
                    "rewards", "discounts", "mask")
    for k in float_leaves:
        t[k].requires_grad_()
    out = port_losses.impala_loss(**t, config=port_losses.ImpalaLossConfig(fused_epilogue=True))
    grads = torch.autograd.grad(
        out.total, [t[k] for k in float_leaves], allow_unused=True, materialize_grads=True
    )
    for k, g in zip(float_leaves, grads):
        if k in ("target_logits", "values"):
            assert float(g.abs().sum()) > 0, k
        else:
            assert float(g.abs().sum()) == 0.0, k
    for key in ("mean_vtrace_target", "mean_advantage"):
        assert not out.logs[key].requires_grad


def test_fused_sums_reference_matches_its_parts():
    """The kernel's plain version: vs and adv are V-trace's, and the three
    sums are the masked loss terms."""
    from torched_impala_tpu_torch.ops.vtrace import vtrace_reference

    rng = np.random.default_rng(5)
    a = [torch.from_numpy(rng.normal(size=(T, B)).astype(np.float32)) for _ in range(7)]
    log_pi_a, ent, values, log_rhos, discounts, rewards, _ = a
    mask = torch.from_numpy((rng.uniform(size=(T, B)) > 0.3).astype(np.float32))
    boot = torch.from_numpy(rng.normal(size=(B,)).astype(np.float32))
    out = fused_loss.fused_sums_reference(
        log_pi_a, ent, values, boot, log_rhos, discounts, rewards, mask, clip_rho=0.5
    )
    vt = vtrace_reference(log_rhos=log_rhos, discounts=discounts, rewards=rewards,
                          values=values, bootstrap_value=boot, clip_rho_threshold=0.5)
    torch.testing.assert_close(out.vs, vt.vs, rtol=0, atol=0)
    torch.testing.assert_close(out.adv, vt.pg_advantages, rtol=0, atol=0)
    torch.testing.assert_close(out.pg, (-vt.pg_advantages * log_pi_a * mask).sum())
    torch.testing.assert_close(out.bl, 0.5 * ((vt.vs - values) ** 2 * mask).sum())
    torch.testing.assert_close(out.ent, (-ent * mask).sum())


def test_bf16_cube_phase_is_not_ported():
    t = {k: torch.from_numpy(v) for k, v in _inputs(1).items()}
    cfg = port_losses.ImpalaLossConfig(fused_epilogue=True, train_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_losses.impala_loss(**t, config=cfg)
