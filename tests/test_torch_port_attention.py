"""The port's windowed attention held against the JAX package.

Same numpy inputs go through the port's `windowed_attention` on the CPU
(its plain forward and backward, the kernels' formulas) and through the
JAX package's `windowed_attention` (Pallas, interpret mode) and its einsum
reference (tests/test_attention_pallas.py's `reference_attention`), at
the JAX op tests' shapes: B=3, T=9, H=2, dh=16, W=7; T=1 with W=0; the
learner's T=20 with W=128; and the op shape at dh=8 and dh=24, widths
the CUDA kernels run zero-padded to 16 and 32. Forward within rtol = atol = 1e-5; dq, dk
and dv of sum(sin(out)) within rtol 1e-4, atol 1e-5 (f32; the sums run
in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torched_impala_tpu.models.transformer import NEG_INF as JAX_NEG_INF
from torched_impala_tpu.ops import attention_pallas
from torched_impala_tpu_torch.ops import attention

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
SHAPES = {  # B, T, H, dh, W
    "op": (3, 9, 2, 16, 7),
    "t1_w0": (3, 1, 2, 16, 0),
    "learner_t20_w128": (2, 20, 2, 16, 128),
    "op_dh8": (3, 9, 2, 8, 7),
    "op_dh24": (3, 9, 2, 24, 7),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _case(B, T, H, dh, W, seed=0):
    """The JAX tests' `random_case`: nondecreasing query segments, a
    cache of matching, stale and empty (-1) slots."""
    rng = np.random.default_rng(seed)
    S = W + T
    q = rng.normal(size=(B, T, H, dh)).astype(np.float32)
    k = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    v = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    seg_q = (
        np.cumsum(rng.uniform(size=(B, T)) < 0.3, axis=1) + rng.integers(0, 3, size=(B, 1))
    ).astype(np.int32)
    cache = rng.integers(-1, 4, size=(B, W)).astype(np.int32)
    return q, k, v, seg_q, np.concatenate([cache, seg_q], axis=1), W


def _jax_einsum_reference(q, k, v, seg_q, seg_ctx, W):
    B, T, H, dh = q.shape
    vis = attention_pallas._visibility(seg_q, seg_ctx, T, k.shape[1], W)
    logits = jnp.einsum("bthd,bshd->bhts", q, k) / jnp.sqrt(float(dh))
    logits = jnp.where(vis[:, None, :, :], logits, JAX_NEG_INF)
    return jnp.einsum("bhts,bshd->bthd", jax.nn.softmax(logits, axis=-1), v)


def _jax_value_and_grads(fn, case):
    q, k, v, seg_q, seg_ctx, W = case
    seg_q, seg_ctx = jnp.asarray(seg_q), jnp.asarray(seg_ctx)

    def loss(q, k, v):
        out = fn(q, k, v, seg_q, seg_ctx, W)
        return jnp.sum(jnp.sin(out)), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_value_and_grads(case):
    q, k, v, seg_q, seg_ctx, W = case
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = attention.windowed_attention(
        *leaves, torch.from_numpy(seg_q), torch.from_numpy(seg_ctx), W
    )
    grads = torch.autograd.grad(torch.sin(out).sum(), leaves)
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_matches_jax_pallas_interpret(shape):
    case = _case(*SHAPES[shape])
    j_out, j_grads = _jax_value_and_grads(
        lambda *a: attention_pallas.windowed_attention(*a, True), case
    )
    p_out, p_grads = _port_value_and_grads(case)
    np.testing.assert_allclose(p_out, j_out, **FWD_TOL)
    for name, p, j in zip(("dq", "dk", "dv"), p_grads, j_grads):
        np.testing.assert_allclose(p, j, **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_matches_jax_einsum_reference(shape):
    case = _case(*SHAPES[shape], seed=1)
    j_out, j_grads = _jax_value_and_grads(_jax_einsum_reference, case)
    p_out, p_grads = _port_value_and_grads(case)
    np.testing.assert_allclose(p_out, j_out, **FWD_TOL)
    for name, p, j in zip(("dq", "dk", "dv"), p_grads, j_grads):
        np.testing.assert_allclose(p, j, **GRAD_TOL, err_msg=name)


def test_visibility_matches_jax():
    _, _, _, seg_q, seg_ctx, W = _case(*SHAPES["op"], seed=2)
    T, S = seg_q.shape[1], seg_ctx.shape[1]
    want = np.asarray(attention_pallas._visibility(jnp.asarray(seg_q), jnp.asarray(seg_ctx), T, S, W))
    got = attention._visibility(torch.from_numpy(seg_q), torch.from_numpy(seg_ctx), T, S, W)
    np.testing.assert_array_equal(got.numpy(), want)


def test_reference_lse_and_blind_rows():
    """The plain forward's lse is the row logsumexp of the visible scaled
    logits; a row that sees nothing gives zeros and lse = -1e30, finite
    (the kernel's contract; the einsum branch would give the mean of v)."""
    q, k, v, seg_q, seg_ctx, W = _case(*SHAPES["op"], seed=3)
    seg_ctx = seg_ctx.copy()
    seg_ctx[0, :] = 99  # row b = 0 sees nothing
    args = [torch.from_numpy(a) for a in (q, k, v, seg_q, seg_ctx)]
    out, lse = attention.windowed_attention_reference(*args, W)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert float(out[0].abs().max()) == 0.0
    assert float(lse[0].max()) == float(np.float32(attention.NEG_INF))
    T, S, dh = q.shape[1], k.shape[1], q.shape[-1]
    vis = attention._visibility(args[3], args[4], T, S, W)[:, None]
    logits = torch.einsum("bthd,bshd->bhts", args[0], args[1]) / dh**0.5
    want = torch.logsumexp(torch.where(vis, logits, -torch.inf), dim=-1)[1:]
    torch.testing.assert_close(lse[1:], want, **FWD_TOL)


def test_bf16_inputs_preserve_dtype_in_output_and_grads():
    q, k, v, seg_q, seg_ctx, W = _case(*SHAPES["op"], seed=4)
    leaves = [torch.from_numpy(a).bfloat16().requires_grad_() for a in (q, k, v)]
    out = attention.windowed_attention(
        *leaves, torch.from_numpy(seg_q), torch.from_numpy(seg_ctx), W
    )
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out.float().sum(), leaves)
    assert all(g.dtype == torch.bfloat16 for g in grads)
    # Within bf16 rounding of the f32 computation on the same values.
    f32 = [x.detach().float().requires_grad_() for x in leaves]
    ref = attention.windowed_attention(*f32, torch.from_numpy(seg_q), torch.from_numpy(seg_ctx), W)
    torch.testing.assert_close(out.float(), ref, rtol=2**-6, atol=2**-6)
