"""The port's fused LSTM cell held against the JAX package's.

The same numpy inputs go through the JAX `lstm_cell_fused` (its Pallas
kernel in interpret mode on the CPU, as tests/test_pallas_lstm.py runs
it) and the port's `lstm_cell_fused` on the CPU (its plain version).

- forward (new_c, new_h): atol 1e-6 on unit-scale inputs, the bound the
  JAX package pins between its kernel and flax's cell (f32 sums in
  another order);
- gradients of a scalar of both outputs through the port's
  `autograd.Function` against the JAX custom VJP: rtol 1e-5, atol 1e-5
  (the same closed form; the matmuls round in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torched_impala_tpu.ops.lstm_pallas import lstm_cell_fused as jax_cell
from torched_impala_tpu_torch.models.convert import params_from_jax
from torched_impala_tpu_torch.models.lstm import LSTMCell
from torched_impala_tpu_torch.ops import lstm as port_lstm

# (B, F, H); the last two are edge shapes the CUDA kernel is held to its
# plain version at on the card (one unit; F far below a ragged H).
SHAPES = [(2, 16, 16), (3, 5, 7), (4, 32, 16), (1, 1, 1), (2, 3, 300)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(B, F, H, seed):
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=(B, F)).astype(np.float32),
        rng.normal(size=(B, H)).astype(np.float32),
        rng.normal(size=(B, H)).astype(np.float32),
        (rng.normal(size=(F, 4 * H)) / np.sqrt(F)).astype(np.float32),
        (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32),
        (rng.normal(size=(4 * H,)) * 0.1).astype(np.float32),
    ]


@pytest.mark.parametrize("B,F,H", SHAPES)
def test_cell_forward_matches_jax(B, F, H):
    args = _inputs(B, F, H, seed=B * 100 + H)
    jc, jh = jax_cell(*map(jnp.asarray, args))
    with torch.no_grad():
        pc, ph = port_lstm.lstm_cell_fused(*map(torch.from_numpy, args))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), atol=1e-6, rtol=0)
    assert pc.dtype == ph.dtype == torch.float32


@pytest.mark.parametrize("B,F,H", SHAPES)
def test_cell_grads_match_jax_vjp(B, F, H):
    args = _inputs(B, F, H, seed=7 + B)
    rng = np.random.default_rng(1)
    wc = rng.normal(size=(B, H)).astype(np.float32)
    wh_out = rng.normal(size=(B, H)).astype(np.float32)

    def jloss(*a):
        c, h = jax_cell(*a)
        return jnp.sum(c * wc) + jnp.sum(h * wh_out)

    jgrads = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    tensors = [torch.from_numpy(a).requires_grad_() for a in args]
    c, h = port_lstm.lstm_cell_fused(*tensors)
    loss = (c * torch.from_numpy(wc)).sum() + (h * torch.from_numpy(wh_out)).sum()
    pgrads = torch.autograd.grad(loss, tensors)
    for name, p, j in zip(("x", "h", "c", "wi", "wh", "b"), pgrads, jgrads):
        np.testing.assert_allclose(
            p.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5, err_msg=name
        )


def test_backward_is_the_closed_form_not_autodiff():
    """The autograd.Function's grads equal autodiff through the plain
    forward (the closed form is exact algebra, not an approximation)."""
    args = [torch.from_numpy(a).requires_grad_() for a in _inputs(3, 6, 5, seed=3)]
    c, h = port_lstm.lstm_cell_fused(*args)
    g_fused = torch.autograd.grad((c * 0.3 + h).sum(), args)
    c, h, _ = port_lstm.lstm_reference(*args)
    g_auto = torch.autograd.grad((c * 0.3 + h).sum(), args)
    for a, b in zip(g_fused, g_auto):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_reference_returns_activated_gates():
    args = list(map(torch.from_numpy, _inputs(2, 4, 3, seed=5)))
    new_c, new_h, acts = port_lstm.lstm_reference(*args)
    i, f, g, o = acts.split(3, dim=-1)
    torch.testing.assert_close(new_c, f * args[2] + i * g)
    torch.testing.assert_close(new_h, o * torch.tanh(new_c))
    assert bool(((i > 0) & (i < 1)).all()) and bool((g.abs() < 1).all())


def test_lstm_cell_module_takes_flax_params():
    """The flax cell's eight DenseParams land in wi/wh/b in (i, f, g, o)
    order, and the module then computes the JAX cell's step."""
    from torched_impala_tpu.models.lstm import PallasLSTMCell

    F, H, B = 6, 5, 3
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, F)).astype(np.float32)
    c0, h0 = (rng.normal(size=(B, H)).astype(np.float32) for _ in range(2))
    jcell = PallasLSTMCell(H)
    carry = (jnp.asarray(c0), jnp.asarray(h0))
    params = jcell.init(jax.random.key(1), carry, jnp.asarray(x))
    # Non-zero biases, so their order is visible.
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v + 0.5 * (jax.tree_util.keystr(path).count("bias") > 0)
        * np.arange(v.shape[-1], dtype=np.float32),
        params,
    )
    (jc, jh), jout = jcell.apply(params, carry, jnp.asarray(x))
    tree = {"lstm": jax.tree.map(np.asarray, params["params"])}
    sd = params_from_jax(tree)
    lp = tree["lstm"]
    np.testing.assert_array_equal(sd["lstm.wi"][:, H : 2 * H].numpy(), lp["if"]["kernel"])
    np.testing.assert_array_equal(sd["lstm.wh"][:, 3 * H :].numpy(), lp["ho"]["kernel"])
    np.testing.assert_array_equal(sd["lstm.b"][2 * H : 3 * H].numpy(), lp["hg"]["bias"])
    cell = LSTMCell(F, H)
    cell.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    with torch.no_grad():
        (pc, ph), pout = cell(
            (torch.from_numpy(c0), torch.from_numpy(h0)), torch.from_numpy(x)
        )
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), atol=1e-6, rtol=0)
    torch.testing.assert_close(pout, ph)


def test_lstm_cell_init_follows_flax():
    """lecun-normal input kernels, one orthogonal [H, H] matrix per gate,
    zero bias; reproducible from the generator's seed."""
    F, H = 40, 8
    cell = LSTMCell(F, H, torch.Generator().manual_seed(0))
    again = LSTMCell(F, H, torch.Generator().manual_seed(0))
    torch.testing.assert_close(cell.wh, again.wh, rtol=0, atol=0)
    assert float(cell.b.detach().abs().max()) == 0.0
    for g in range(4):
        q = cell.wh[:, g * H : (g + 1) * H].detach()
        torch.testing.assert_close(q.T @ q, torch.eye(H), rtol=0, atol=1e-5)
    std = float(cell.wi.detach().std())
    assert abs(std - F**-0.5) < 0.15 * F**-0.5
    assert float(cell.wi.detach().abs().max()) <= 2.0 * F**-0.5 / 0.87962566103423978
