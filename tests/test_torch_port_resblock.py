"""The port's residual block and IMPALA deep torso held against the JAX
package's.

The same numpy inputs go through the JAX `fused_residual_block` (its
Pallas kernel in interpret mode on the CPU, as tests/test_pallas_conv.py
runs it) and the port's `fused_residual_block` on the CPU (its plain
version); flax's `ResidualBlock` and `AtariDeepTorso` against the port's,
with the flax params carried across by `params_from_jax`.

Tolerances:
- fused block f32 forward: atol 2e-6, rtol 1e-6, the JAX tests' bound
  between the nine-shift kernel and XLA's conv (sums in another order);
- fused block bf16 forward: at most one bf16 rounding of the output
  apart (atol = rtol = 2^-7) and 99% of the elements bit-equal: both
  round y1 and the output to bf16 from f32 sums taken in another order;
- fused block grads vs the JAX custom VJP (`_block_bwd`): rtol 1e-5,
  atol 1e-5 (the same closed form in f32);
- ResidualBlock / AtariDeepTorso f32: rtol 1e-5, atol 1e-5; bf16: atol
  3e-2 on features of order 1 (both round at each conv to bf16, with
  f32 sums in another order) and most features equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torched_impala_tpu.models.torsos import AtariDeepTorso as JaxDeep
from torched_impala_tpu.models.torsos import ResidualBlock as JaxBlock
from torched_impala_tpu.ops.conv_pallas import fused_residual_block as jax_block
from torched_impala_tpu_torch.models.convert import params_from_jax
from torched_impala_tpu_torch.models.torsos import (
    AtariDeepTorso,
    ResidualBlock,
    max_pool_same,
)
from torched_impala_tpu_torch.ops import conv_block

BF16_ULP = 2.0**-7
SECTIONS = (4, 8, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _block_inputs(seed=0, N=2, H=9, W=9, C=8):
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=(N, H, W, C)).astype(np.float32),
        (rng.normal(size=(3, 3, C, C)) * 0.15).astype(np.float32),
        (rng.normal(size=(C,)) * 0.1).astype(np.float32),
        (rng.normal(size=(3, 3, C, C)) * 0.15).astype(np.float32),
        (rng.normal(size=(C,)) * 0.1).astype(np.float32),
    ]


@pytest.mark.parametrize("shape", [(2, 9, 9, 8), (3, 6, 11, 4)], ids=str)
def test_fused_block_f32_matches_jax(shape):
    N, H, W, C = shape
    args = _block_inputs(1, N, H, W, C)
    want = np.asarray(jax_block(*map(jnp.asarray, args)))
    with torch.no_grad():
        got = conv_block.fused_residual_block(*map(torch.from_numpy, args))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_block_bf16_matches_jax(seed):
    x, *params = _block_inputs(seed)
    want = np.asarray(
        jax_block(jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, params)).astype(
            jnp.float32
        )
    )
    with torch.no_grad():
        got = conv_block.fused_residual_block(
            torch.from_numpy(x).bfloat16(), *map(torch.from_numpy, params)
        )
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=BF16_ULP, rtol=BF16_ULP)
    assert np.mean(got == want) >= 0.99


def test_fused_block_grads_match_jax_vjp():
    args = _block_inputs(2)
    dout = np.random.default_rng(9).normal(size=args[0].shape).astype(np.float32)
    _, vjp = jax.vjp(jax_block, *map(jnp.asarray, args))
    jgrads = vjp(jnp.asarray(dout))
    tensors = [torch.from_numpy(a).requires_grad_() for a in args]
    out = conv_block.fused_residual_block(*tensors)
    pgrads = torch.autograd.grad(out, tensors, torch.from_numpy(dout))
    for name, p, j in zip(("x", "k1", "b1", "k2", "b2"), pgrads, jgrads):
        np.testing.assert_allclose(
            p.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5, err_msg=name
        )


def test_fused_block_grads_equal_autodiff_of_plain_version():
    """The closed-form backward is the gradient of the plain forward."""
    args = [torch.from_numpy(a).requires_grad_() for a in _block_inputs(3, 2, 5, 7, 4)]
    g_fused = torch.autograd.grad(conv_block.fused_residual_block(*args).square().sum(), args)
    g_auto = torch.autograd.grad(conv_block.block_reference(*args).square().sum(), args)
    for a, b in zip(g_fused, g_auto):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_zero_ring_is_conv1_output_padding():
    """conv2 pads conv1's OUTPUT with zeros: evaluating conv1 one pixel
    outside the image (a conv of the padded input) gives other numbers."""
    x, k1, b1, k2, b2 = map(torch.from_numpy, _block_inputs(4, 1, 6, 6, 4))
    got = conv_block.block_reference(x, k1, b1, k2, b2)
    oihw = (3, 2, 0, 1)
    xr = F.pad(torch.relu(x).permute(0, 3, 1, 2), (2, 2, 2, 2))
    y1_wide = torch.relu(F.conv2d(xr, k1.permute(oihw)) + b1[:, None, None])
    wrong = x + (F.conv2d(y1_wide, k2.permute(oihw)) + b2[:, None, None]).permute(0, 2, 3, 1)
    assert float((got - wrong).abs().max()) > 1e-2


def _flax_block_params(channels, seed, fused):
    x = jnp.zeros((1, 5, 5, channels), jnp.float32)
    return JaxBlock(channels, fused=fused).init(jax.random.key(seed), x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unfused_residual_block_matches_flax(dtype):
    C = 8
    params = _flax_block_params(C, 0, fused=False)
    x = np.random.default_rng(0).normal(size=(2, 7, 7, C)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want = JaxBlock(C, dtype=jdt).apply(params, jnp.asarray(x, jdt))
    block = ResidualBlock(C, dtype=dtype)
    block.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = block(torch.from_numpy(x).to(block.dtype).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-2)


def _pixels(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _torso_pair(dtype, fused, hw=(16, 16)):
    jdt = jnp.dtype(dtype)
    jtorso = JaxDeep(channel_sections=SECTIONS, hidden_size=32, dtype=jdt, fused_blocks=fused)
    params = jtorso.init(jax.random.key(3), jnp.zeros((1, *hw, 4), jnp.uint8))
    torso = AtariDeepTorso(4, hw, SECTIONS, 2, 32, dtype=dtype, fused_blocks=fused)
    torso.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jtorso, params, torso


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deep_torso_matches_flax(dtype, fused):
    jtorso, params, torso = _torso_pair(dtype, fused)
    obs = _pixels(0, (3, 16, 16, 4))
    want = np.asarray(jtorso.apply(params, jnp.asarray(obs)), np.float32)
    with torch.no_grad():
        got = torso(torch.from_numpy(obs))
    assert got.dtype == torso.dtype and got.shape == (3, 32)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-2)
        assert np.mean(got == want) >= 0.9


def test_deep_torso_fused_equals_unfused_in_f32():
    """Same params, both block paths: the same torso to f32 rounding."""
    _, params, unfused = _torso_pair("float32", False, hw=(12, 20))
    fused = AtariDeepTorso(4, (12, 20), SECTIONS, 2, 32, fused_blocks=True)
    fused.load_state_dict(unfused.state_dict())
    obs = torch.from_numpy(_pixels(1, (2, 12, 20, 4)))
    with torch.no_grad():
        torch.testing.assert_close(fused(obs), unfused(obs), rtol=1e-5, atol=1e-5)


def test_deep_torso_names_and_flatten_width():
    torso = AtariDeepTorso()
    names = {k.rsplit(".", 1)[0] for k in torso.state_dict()}
    assert names == {
        "Conv_0", "Conv_1", "Conv_2", "Dense_0",
        *(f"ResidualBlock_{i}.Conv_{j}" for i in range(6) for j in range(2)),
    }
    assert torso.Dense_0.in_features == 11 * 11 * 32 == 3872
    assert torso.feature_size == 256


@pytest.mark.parametrize("size", [84, 42, 21, 16, 11, 7])
def test_max_pool_same_matches_flax(size):
    import flax.linen as nn

    x = np.random.default_rng(size).normal(size=(2, size, size + 1, 3)).astype(np.float32)
    want = nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME")
    got = max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size", [84, 42])
def test_symmetric_pool_padding_is_the_hazard(size):
    """torch's padding=1 gives the same output size at even sizes with
    windows shifted by one: it misses flax's pool, which max_pool_same
    matches."""
    import flax.linen as nn

    x = np.random.default_rng(0).normal(size=(1, size, size, 2)).astype(np.float32)
    want = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME"))
    wrong = F.max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, padding=1)
    wrong = wrong.permute(0, 2, 3, 1).numpy()
    assert wrong.shape == want.shape
    assert not np.array_equal(wrong, want)
