"""The port's fused V-trace loss held against the JAX package.

Same numpy inputs (T=5, B=4, A=6, a mask with zeros) go through the JAX
`fused_vtrace_loss` (its Pallas kernel in interpret mode, and its 'xla'
path) and the port's `fused_vtrace_loss` on the CPU, where the two
kernels' plain versions run. The total, every log and the gradients with
respect to the logits and the values agree at rtol 1e-5, atol 1e-6: f32,
the same formulas, only the summation order of the reductions may
differ. Each plain version is also held to JAX alone (the forward's
sums, lse, entropy, vs and adv; the backward against jax.vjp) at A = 2,
6 and 18, and the port's fused path to its own separate `impala_loss`,
all at the same tolerance (the JAX package pins the two equal in f32).
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
from torched_impala_tpu_torch.ops.vtrace import threshold

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


def _inputs(seed, A=A):
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
    """The forward kernel's plain version: lse and the entropy are the
    target logits' own, vs and adv are V-trace's on log pi(a) - log mu(a),
    and the five sums are the masked loss terms and the two means."""
    from torched_impala_tpu_torch.ops.vtrace import vtrace_reference

    t = {k: torch.from_numpy(v) for k, v in _inputs(5).items()}
    a = t["actions"].long()
    out = fused_loss.fused_core_reference(
        t["target_logits"], t["behaviour_logits"], a, t["values"], t["bootstrap_value"],
        t["discounts"], t["rewards"], t["mask"], clip_rho=0.5, lambda_=0.9,
    )
    log_p = torch.log_softmax(t["target_logits"], -1)
    log_pi_a = log_p.gather(-1, a[..., None])[..., 0]
    log_mu_a = torch.log_softmax(t["behaviour_logits"], -1).gather(-1, a[..., None])[..., 0]
    ent = -(log_p.exp() * log_p).sum(-1)
    vt = vtrace_reference(log_rhos=log_pi_a - log_mu_a, discounts=t["discounts"],
                          rewards=t["rewards"], values=t["values"],
                          bootstrap_value=t["bootstrap_value"], clip_rho_threshold=0.5,
                          lambda_=0.9)
    torch.testing.assert_close(out.vs, vt.vs, rtol=0, atol=0)
    torch.testing.assert_close(out.adv, vt.pg_advantages, rtol=0, atol=0)
    torch.testing.assert_close(out.lse, torch.logsumexp(t["target_logits"], -1))
    torch.testing.assert_close(out.ent, ent)
    mask, values = t["mask"], t["values"]
    want = [(-vt.pg_advantages * log_pi_a * mask).sum(), 0.5 * ((vt.vs - values) ** 2 * mask).sum(),
            (-ent * mask).sum(), vt.vs.mean(), vt.pg_advantages.mean()]
    torch.testing.assert_close(out.sums, torch.stack(want))


def test_fused_core_backward_reference_is_the_vjp():
    """The backward kernel's plain version is autograd's VJP of the three
    sums in the logits and the values, with vs and adv held constant, for
    any cotangents of the three sums."""
    t = {k: torch.from_numpy(v) for k, v in _inputs(6).items()}
    a = t["actions"].long()
    z = t["target_logits"].clone().requires_grad_()
    values = t["values"].clone().requires_grad_()
    out = fused_loss.fused_core_reference(
        z.detach(), t["behaviour_logits"], a, values.detach(), t["bootstrap_value"],
        t["discounts"], t["rewards"], t["mask"],
    )
    log_p = torch.log_softmax(z, -1)
    mask = t["mask"]
    pg = (-out.adv * log_p.gather(-1, a[..., None])[..., 0] * mask).sum()
    bl = 0.5 * ((out.vs - values) ** 2 * mask).sum()
    en = (-(-(log_p.exp() * log_p).sum(-1)) * mask).sum()
    g = [torch.tensor(v, dtype=torch.float32) for v in (0.7, -1.3, 2.1)]
    want = torch.autograd.grad(g[0] * pg + g[1] * bl + g[2] * en, [z, values])
    got = fused_loss.fused_core_backward_reference(
        z.detach(), out.lse, out.ent, out.adv, out.vs, values.detach(), mask, a, *g
    )
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, **TOL)


def _jax_core(x, clips, lambda_, implementation, cot):
    """JAX's fused_vtrace_loss at reduction 'sum': its (pg, bl, ent) sums
    and means, and the VJP of the three sums in (logits, values) at the
    cotangents `cot`."""
    cfg = jax_losses.ImpalaLossConfig(fused_epilogue=True, lambda_=lambda_, **CLIPS[clips])

    def f(logits, values):
        logs = jax_fused(
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
        ).logs
        return (logs["pg_loss"], logs["baseline_loss"], logs["entropy_loss"]), (
            logs["mean_vtrace_target"], logs["mean_advantage"])

    sums, vjp, means = jax.vjp(f, jnp.asarray(x["target_logits"]), jnp.asarray(x["values"]),
                               has_aux=True)
    return [*sums, *means], vjp(tuple(jnp.float32(c) for c in cot))


LAMBDAS = {"default": 1.0, "none": 0.9, "half_two": 0.9}


@pytest.mark.parametrize("clips", sorted(CLIPS))
@pytest.mark.parametrize("A", [2, 6, 18])
@pytest.mark.parametrize("implementation", ["kernel", "xla"])
def test_fused_core_references_match_jax(implementation, A, clips):
    """Both kernels' plain versions against JAX's fused_vtrace_loss (its
    Pallas kernel in interpret mode, and its 'xla' path): the five sums
    against its logs, lse and the entropy against the logits' own, vs and
    adv against JAX's V-trace, and the backward against jax.vjp, on a
    mask with zeros."""
    from torched_impala_tpu.ops.vtrace import vtrace_scan

    x = _inputs(A + len(clips), A=A)
    lambda_ = LAMBDAS[clips]
    cot = (0.7, -1.3, 2.1)
    j_sums, (j_gz, j_gv) = _jax_core(x, clips, lambda_, implementation, cot)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    a = t["actions"].long()
    kw = {k: threshold(CLIPS[clips].get(f"{k}_threshold", 1.0))
          for k in ("clip_rho", "clip_c", "clip_pg_rho")}
    out = fused_loss.fused_core_reference(
        t["target_logits"], t["behaviour_logits"], a, t["values"], t["bootstrap_value"],
        t["discounts"], t["rewards"], t["mask"], **kw, lambda_=lambda_,
    )
    np.testing.assert_allclose(out.sums.numpy(), np.array(j_sums), **TOL)
    z = jnp.asarray(x["target_logits"])
    log_p = jax.nn.log_softmax(z, axis=-1)
    np.testing.assert_allclose(out.lse.numpy(), np.asarray(jax.nn.logsumexp(z, axis=-1)), **TOL)
    np.testing.assert_allclose(out.ent.numpy(), np.asarray(-jnp.sum(jnp.exp(log_p) * log_p, -1)),
                               **TOL)
    take = lambda lp: jnp.take_along_axis(lp, jnp.asarray(x["actions"])[..., None], -1)[..., 0]
    vt = vtrace_scan(
        log_rhos=take(log_p) - take(jax.nn.log_softmax(jnp.asarray(x["behaviour_logits"]), -1)),
        discounts=jnp.asarray(x["discounts"]), rewards=jnp.asarray(x["rewards"]),
        values=jnp.asarray(x["values"]), bootstrap_value=jnp.asarray(x["bootstrap_value"]),
        clip_rho_threshold=CLIPS[clips].get("clip_rho_threshold", 1.0),
        clip_c_threshold=CLIPS[clips].get("clip_c_threshold", 1.0),
        clip_pg_rho_threshold=CLIPS[clips].get("clip_pg_rho_threshold", 1.0),
        lambda_=lambda_,
    )
    np.testing.assert_allclose(out.vs.numpy(), np.asarray(vt.vs), **TOL)
    np.testing.assert_allclose(out.adv.numpy(), np.asarray(vt.pg_advantages), **TOL)
    g_z, g_values = fused_loss.fused_core_backward_reference(
        t["target_logits"], out.lse, out.ent, out.adv, out.vs, t["values"], t["mask"], a,
        *(torch.tensor(c, dtype=torch.float32) for c in cot),
    )
    np.testing.assert_allclose(g_z.numpy(), np.asarray(j_gz), **TOL)
    np.testing.assert_allclose(g_values.numpy(), np.asarray(j_gv), **TOL)


def test_bf16_cube_phase_is_not_ported():
    t = {k: torch.from_numpy(v) for k, v in _inputs(1).items()}
    cfg = port_losses.ImpalaLossConfig(fused_epilogue=True, train_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_losses.impala_loss(**t, config=cfg)

