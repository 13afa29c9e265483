"""IMPALA loss of the PyTorch port held against the JAX package.

Same numpy inputs (T=5, B=4, A=6) go through the JAX `impala_loss` and
the port's on the CPU (the port's V-trace takes its plain version there).
The total, every log, and the gradients with respect to the logits and
the values must agree at rtol 1e-5, atol 1e-6: f32, the same formulas,
only the summation order of the reductions may differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torched_impala_tpu.ops import losses as jax_losses
from torched_impala_tpu_torch.ops import losses as port_losses

T, B, A = 5, 4, 6
TOL = dict(rtol=1e-5, atol=1e-6)


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
        mask=(rng.uniform(size=(T, B)) > 0.1).astype(np.float32),
    )


def _jax_loss(x, reduction):
    cfg = jax_losses.ImpalaLossConfig(
        reduction=reduction, vtrace_implementation="scan"
    )

    def f(logits, values):
        out = jax_losses.impala_loss(
            target_logits=logits,
            behaviour_logits=jnp.asarray(x["behaviour_logits"]),
            values=values,
            bootstrap_value=jnp.asarray(x["bootstrap_value"]),
            actions=jnp.asarray(x["actions"]),
            rewards=jnp.asarray(x["rewards"]),
            discounts=jnp.asarray(x["discounts"]),
            mask=jnp.asarray(x["mask"]),
            config=cfg,
        )
        return out.total, out.logs

    (total, logs), (g_logits, g_values) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True
    )(jnp.asarray(x["target_logits"]), jnp.asarray(x["values"]))
    return total, logs, g_logits, g_values


def _port_loss(x, reduction):
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    logits = t["target_logits"].requires_grad_()
    values = t["values"].requires_grad_()
    out = port_losses.impala_loss(
        target_logits=logits,
        behaviour_logits=t["behaviour_logits"],
        values=values,
        bootstrap_value=t["bootstrap_value"],
        actions=t["actions"],
        rewards=t["rewards"],
        discounts=t["discounts"],
        mask=t["mask"],
        config=port_losses.ImpalaLossConfig(reduction=reduction),
    )
    g_logits, g_values = torch.autograd.grad(out.total, (logits, values))
    return out.total, out.logs, g_logits, g_values


@pytest.mark.parametrize("reduction", ["sum", "mean"])
@pytest.mark.parametrize("seed", [0, 1])
def test_impala_loss_and_grads_match_jax(seed, reduction):
    x = _inputs(seed)
    j_total, j_logs, j_gl, j_gv = _jax_loss(x, reduction)
    p_total, p_logs, p_gl, p_gv = _port_loss(x, reduction)
    np.testing.assert_allclose(p_total.item(), float(j_total), **TOL)
    assert set(p_logs) == set(j_logs)
    for k in j_logs:
        np.testing.assert_allclose(
            p_logs[k].item(), float(j_logs[k]), err_msg=k, **TOL
        )
    np.testing.assert_allclose(p_gl.numpy(), np.asarray(j_gl), **TOL)
    np.testing.assert_allclose(p_gv.numpy(), np.asarray(j_gv), **TOL)


def test_loss_parts_match_jax():
    x = _inputs(2)
    logits = x["target_logits"]
    np.testing.assert_allclose(
        port_losses.entropy(torch.from_numpy(logits)).numpy(),
        np.asarray(jax_losses.entropy(jnp.asarray(logits))),
        **TOL,
    )
    np.testing.assert_allclose(
        port_losses.action_log_probs(
            torch.from_numpy(logits), torch.from_numpy(x["actions"])
        ).numpy(),
        np.asarray(
            jax_losses.action_log_probs(
                jnp.asarray(logits), jnp.asarray(x["actions"])
            )
        ),
        **TOL,
    )


@pytest.mark.parametrize("flag", ["fused_epilogue", "health_diagnostics"])
def test_unported_options_raise(flag):
    x = {k: torch.from_numpy(v) for k, v in _inputs(3).items()}
    cfg = port_losses.ImpalaLossConfig(**{flag: True})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_losses.impala_loss(**x, config=cfg)
