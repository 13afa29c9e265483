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

The bf16 CUDA kernel's launch plan (`conv_block_cuda.bf16_launch_plan`)
is pure Python, so its coverage, shared memory and grid are checked here
at the Breakout preset's block shapes, for the learner and one actor.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torched_impala_tpu.models.torsos import AtariDeepTorso as JaxDeep
from torched_impala_tpu.models.torsos import ResidualBlock as JaxBlock
from torched_impala_tpu.ops.conv_pallas import fused_residual_block as jax_block
from torched_impala_tpu_torch import configs
from torched_impala_tpu_torch.models.convert import params_from_jax
from torched_impala_tpu_torch.models.torsos import (
    AtariDeepTorso,
    ResidualBlock,
    max_pool_same,
)
from torched_impala_tpu_torch.ops import conv_block, conv_block_cuda

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


def _breakout_block_shapes():
    """(H, W, C) of each section's residual blocks in the BREAKOUT preset's
    deep torso: each section's max-pool halves H and W (SAME, rounding up)."""
    cfg = configs.BREAKOUT
    assert cfg.model == "deep_resnet"
    sections = inspect.signature(AtariDeepTorso).parameters["channel_sections"].default
    h, w = cfg.obs_shape[:2]
    shapes = []
    for c in sections:
        h, w = -(-h // 2), -(-w // 2)
        shapes.append((h, w, c))
    return shapes


BREAKOUT_BLOCKS = _breakout_block_shapes()
# The learner's torso runs over (T + 1) x B images; one actor's over its 8 envs.
LEARNER_N = (configs.BREAKOUT.unroll_length + 1) * configs.BREAKOUT.batch_size
ACTOR_N = 8


def test_breakout_block_shapes_are_the_kernels_shapes():
    assert BREAKOUT_BLOCKS == [(42, 42, 16), (21, 21, 32), (11, 11, 32)]
    assert LEARNER_N == 672


@pytest.mark.parametrize("N", [LEARNER_N, ACTOR_N])
@pytest.mark.parametrize("hwc", BREAKOUT_BLOCKS, ids=str)
def test_bf16_plan_covers_every_output_row_once(hwc, N):
    H, W, C = hwc
    plan = conv_block_cuda.bf16_launch_plan(N, H, W, C)
    rows = [
        r
        for band in range(plan.bands)
        for r in range(band * plan.rows, min((band + 1) * plan.rows, H))
    ]
    assert rows == list(range(H))
    assert (plan.bands - 1) * plan.rows < H  # no band is empty
    # Persistent blocks walk the N x bands items: each item once.
    assert plan.blocks == min(N * plan.bands, plan.resident * conv_block_cuda.SMS)


@pytest.mark.parametrize("N", [LEARNER_N, ACTOR_N])
@pytest.mark.parametrize("hwc", BREAKOUT_BLOCKS, ids=str)
def test_bf16_plan_shared_memory_fits(hwc, N):
    H, W, C = hwc
    plan = conv_block_cuda.bf16_launch_plan(N, H, W, C)
    assert plan.channels == C  # 16 and 32 need no padding
    assert plan.smem_bytes == conv_block_cuda.bf16_smem_bytes(plan.rows, W, C)
    # Two blocks an SM at the preset's shapes, each with the card's
    # reservation, under the launch ceiling.
    assert plan.resident == 2
    assert 2 * (plan.smem_bytes + conv_block_cuda.BLOCK_RESERVED) <= conv_block_cuda.SM_SMEM
    assert plan.smem_bytes <= conv_block_cuda.SMEM_CEILING


@pytest.mark.parametrize("N", [LEARNER_N, ACTOR_N])
@pytest.mark.parametrize("hwc", BREAKOUT_BLOCKS, ids=str)
def test_bf16_plan_fills_the_card_where_h_allows(hwc, N):
    H, W, C = hwc
    plan = conv_block_cuda.bf16_launch_plan(N, H, W, C)
    assert plan.blocks >= min(conv_block_cuda.SMS, N * H)


def test_bf16_plan_learner_and_actor_bands():
    """The learner's 672 images fill the card with tall bands (few halo
    rows computed twice); one actor's 8 images need thin ones."""
    plans = {
        (N, hwc): conv_block_cuda.bf16_launch_plan(N, *hwc)
        for N in (LEARNER_N, ACTOR_N)
        for hwc in BREAKOUT_BLOCKS
    }
    assert [plans[LEARNER_N, hwc].rows for hwc in BREAKOUT_BLOCKS] == [21, 21, 11]
    assert [plans[ACTOR_N, hwc].rows for hwc in BREAKOUT_BLOCKS] == [2, 1, 1]
    assert plans[ACTOR_N, (11, 11, 32)].blocks == 88  # H = 11 allows no more
    assert plans[LEARNER_N, (42, 42, 16)].blocks == 264  # two an SM


@pytest.mark.parametrize(
    "shape,channels",
    [
        ((3, 13, 7, 24), 32), ((2, 13, 21, 1), 16), ((1, 1, 1, 1), 16),
        ((2, 9, 9, 64), 64), ((2, 9, 9, 72), 80), ((1, 5, 42, 80), 80),
    ],
    ids=str,
)
def test_bf16_plan_pads_channels_to_a_multiple_of_16(shape, channels):
    N, H, W, C = shape
    plan = conv_block_cuda.bf16_launch_plan(N, H, W, C)
    assert plan.channels == channels
    assert plan.smem_bytes <= conv_block_cuda.SMEM_CEILING
    assert plan.rows * plan.bands >= H


# Shapes at and past the limits of residency: bands that only just fit
# two blocks an SM and one column too wide for two (C = 16: W = 413 / 414,
# C = 32: W = 151 / 152), C = 64 (its two kernels alone take 144 KB),
# channels whose two kernels do not fit together (C = 65 .. 80: one conv's
# kernel at a time), and the widest W at C = 80.
PLAN_LIMIT_SHAPES = [
    (672, 42, 42, 16), (8, 21, 21, 32), (1, 2, 413, 16), (1, 2, 414, 16),
    (2, 30, 151, 32), (2, 30, 152, 32), (2, 9, 9, 64), (2, 9, 9, 72),
    (672, 11, 11, 80), (3, 7, 42, 65), (1, 3, 89, 80),
]


@pytest.mark.parametrize("shape", PLAN_LIMIT_SHAPES, ids=str)
def test_bf16_plan_resident_blocks_fit_an_sm(shape):
    """`resident` blocks, each with the card's 1 KB reservation, fit in
    one SM's shared memory, so the persistent grid of `resident` x SMS
    blocks runs in one wave; one block an SM only where two do not fit
    or the two kernels do not fit together."""
    N, H, W, C = shape
    cb = conv_block_cuda
    plan = cb.bf16_launch_plan(N, H, W, C)
    assert plan.resident * (plan.smem_bytes + cb.BLOCK_RESERVED) <= cb.SM_SMEM
    assert plan.smem_bytes <= cb.SMEM_CEILING
    assert plan.blocks == min(N * plan.bands, plan.resident * cb.SMS)
    if plan.resident == 1 and plan.channels <= cb.BOTH_KERNELS_CHANNELS:
        one_row = cb.bf16_smem_bytes(1, W, plan.channels)
        assert 2 * (one_row + cb.BLOCK_RESERVED) > cb.SM_SMEM


@pytest.mark.parametrize(
    "shape,resident",
    [
        ((1, 2, 413, 16), 2), ((1, 2, 414, 16), 1), ((2, 30, 151, 32), 2),
        ((2, 30, 152, 32), 1), ((2, 9, 9, 64), 1), ((2, 9, 9, 72), 1),
    ],
    ids=str,
)
def test_bf16_plan_two_blocks_only_where_both_fit(shape, resident):
    assert conv_block_cuda.bf16_launch_plan(*shape).resident == resident


def test_bf16_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="C <= 80"):
        conv_block_cuda.bf16_launch_plan(2, 9, 9, 81)
    with pytest.raises(ValueError, match="too wide"):
        conv_block_cuda.bf16_launch_plan(1, 4, 2000, 64)
    with pytest.raises(ValueError, match="too wide"):
        conv_block_cuda.bf16_launch_plan(1, 3, 90, 80)
