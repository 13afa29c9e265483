"""Models of the PyTorch port held against the JAX package.

flax-initialised params are carried across with `params_from_jax`
(strict `load_state_dict`, so every name and shape must line up), then
the same numpy observations go through both nets on the CPU.

- f32: logits and values agree at rtol 1e-4, atol 1e-5 (the convs sum in
  another order: the JAX first conv runs as space-to-depth).
- bf16 torso: logits agree at atol 5e-2 and the greedy actions on the
  probe are identical (both round the torso to bf16, at other places).

The uint8 Atari probes pin the two layout hazards: a flatten in (c, h, w)
order instead of flax's (h, w, c), or a missing 1/255 fold on the first
conv's kernel, would miss the JAX numbers by far more than the tolerance
(`test_hazards_are_visible` shows it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torched_impala_tpu.models import Agent as JaxAgent
from torched_impala_tpu.models import AtariShallowTorso as JaxAtari
from torched_impala_tpu.models import ImpalaNet as JaxNet
from torched_impala_tpu.models import MLPTorso as JaxMLP
from torched_impala_tpu_torch.models.agent import Agent
from torched_impala_tpu_torch.models.convert import params_from_jax
from torched_impala_tpu_torch.models.nets import ImpalaNet
from torched_impala_tpu_torch.models.torsos import AtariShallowTorso, MLPTorso

T, B, A = 3, 2, 6
F32 = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pixels(seed, shape=(T, B, 84, 84, 4)):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _pair(kind, dtype="float32", seed=0):
    """(jax agent, flax params as numpy, port net loaded with them)."""
    jdt = jnp.dtype(dtype)
    if kind == "mlp":
        jtorso, torso = JaxMLP(hidden_sizes=(16, 16), dtype=jdt), MLPTorso(
            5, (16, 16), dtype=dtype
        )
        example = np.zeros((5,), np.float32)
    else:
        jtorso, torso = JaxAtari(dtype=jdt), AtariShallowTorso(4, dtype=dtype)
        example = np.zeros((84, 84, 4), np.uint8)
    jagent = JaxAgent(JaxNet(num_actions=A, torso=jtorso))
    params = jax.tree.map(
        np.asarray, jagent.init_params(jax.random.key(seed), jnp.asarray(example))
    )
    net = ImpalaNet(A, torso)
    net.load_state_dict(params_from_jax(params))
    return jagent, params, net


def _forward_both(jagent, params, net, obs):
    first = np.zeros(obs.shape[:2], np.bool_)
    jout, _ = jagent.unroll(params, jnp.asarray(obs), jnp.asarray(first), ())
    with torch.no_grad():
        pout, _ = Agent(net).unroll(
            torch.from_numpy(obs), torch.from_numpy(first), ()
        )
    return jout, pout


@pytest.mark.parametrize("kind", ["mlp", "atari"])
def test_f32_forward_matches_jax(kind):
    jagent, params, net = _pair(kind)
    if kind == "mlp":
        obs = np.random.default_rng(1).normal(size=(T, B, 5)).astype(np.float32)
    else:
        obs = _pixels(1)
    jout, pout = _forward_both(jagent, params, net, obs)
    np.testing.assert_allclose(
        pout.policy_logits.numpy(), np.asarray(jout.policy_logits), **F32
    )
    np.testing.assert_allclose(pout.values.numpy(), np.asarray(jout.values), **F32)
    assert pout.policy_logits.dtype == torch.float32


def test_step_mode_matches_unroll_mode():
    _, _, net = _pair("atari")
    obs = torch.from_numpy(_pixels(2))
    with torch.no_grad():
        unrolled, _ = net(obs, torch.zeros(T, B, dtype=torch.bool), (), unroll=True)
        stepped, _ = net(obs[1], torch.zeros(B, dtype=torch.bool), ())
    torch.testing.assert_close(stepped.policy_logits, unrolled.policy_logits[1])


def test_bf16_torso_matches_jax_bf16():
    jagent, params, net = _pair("atari", dtype="bfloat16")
    obs = _pixels(3, shape=(T, 4, 84, 84, 4))
    jout, pout = _forward_both(jagent, params, net, obs)
    j_logits = np.asarray(jout.policy_logits, np.float32)
    p_logits = pout.policy_logits.numpy()
    assert p_logits.dtype == np.float32  # heads run in f32
    np.testing.assert_allclose(p_logits, j_logits, atol=5e-2, rtol=0)
    np.testing.assert_array_equal(p_logits.argmax(-1), j_logits.argmax(-1))
    # The bf16 torso output really is bf16 before the heads.
    with torch.no_grad():
        feats = net.torso(torch.from_numpy(obs[0]))
    assert feats.dtype == torch.bfloat16


def test_uint8_fold_equals_scaled_float_input():
    _, _, net = _pair("atari")
    obs = _pixels(4)[0]
    with torch.no_grad():
        a = net.torso(torch.from_numpy(obs))
        b = net.torso(torch.from_numpy(obs.astype(np.float32) / 255.0))
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_hazards_are_visible():
    """A (c, h, w) flatten or an unfolded 1/255 would break parity."""
    jagent, params, net = _pair("atari")
    obs = _pixels(5)
    jout, _ = _forward_both(jagent, params, net, obs)
    want = np.asarray(jout.policy_logits)
    wrong = dict(params_from_jax(params))
    w = wrong["torso.Dense_0.weight"]  # rows in (h, w, c) order
    wrong["torso.Dense_0.weight"] = (
        w.reshape(512, 7, 7, 64).permute(0, 3, 1, 2).reshape(512, 3136)
    )
    net.load_state_dict(wrong)
    _, pout = _forward_both(jagent, params, net, obs)
    assert np.abs(pout.policy_logits.numpy() - want).max() > 100 * F32["atol"]
    net.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        unfolded, _ = net(
            torch.from_numpy(obs.astype(np.float32)),
            torch.zeros(T, B, dtype=torch.bool),
            (),
            unroll=True,
        )
    assert np.abs(unfolded.policy_logits.numpy() - want).max() > 100 * F32["atol"]


def test_params_from_jax_layouts():
    _, params, net = _pair("atari")
    sd = params_from_jax(params)
    p = params["params"]["torso"]
    np.testing.assert_array_equal(
        sd["torso.Conv_0.weight"].numpy(), p["Conv_0"]["kernel"].transpose(3, 2, 0, 1)
    )
    np.testing.assert_array_equal(
        sd["torso.Dense_0.weight"].numpy(), p["Dense_0"]["kernel"].T
    )
    assert set(sd) == set(net.state_dict())


def test_agent_step_samples_valid_actions():
    _, _, net = _pair("mlp")
    g = torch.Generator().manual_seed(0)
    out = Agent(net).step(
        torch.zeros(7, 5), torch.ones(7, dtype=torch.bool), (), g
    )
    assert out.action.shape == (7,)
    assert int(out.action.min()) >= 0 and int(out.action.max()) < A
    assert out.policy_logits.shape == (7, A)


@pytest.mark.parametrize("kind", ["mlp", "atari"])
def test_remat_torso_is_the_plain_torso_bit_for_bit(kind):
    """`remat_torso` on the MLP and Nature-CNN torsos (each layer its own
    checkpoint): the same param names, and the same outputs and grads of
    an unroll bit for bit on the CPU, each layer's forward run again in
    the backward; a step under no grad is the plain step."""
    rng = np.random.default_rng(7)
    if kind == "mlp":
        obs = torch.from_numpy(rng.normal(size=(3, 2, 4)).astype(np.float32))
    else:
        obs = torch.from_numpy(rng.integers(0, 256, size=(3, 2, 84, 84, 4), dtype=np.uint8))
    first = torch.zeros(3, 2, dtype=torch.bool)
    nets = []
    for remat in (False, True):
        g = torch.Generator().manual_seed(0)
        torso = MLPTorso(4, (16, 16), generator=g) if kind == "mlp" else AtariShallowTorso(4, generator=g)
        nets.append(ImpalaNet(6, torso, generator=g, remat_torso=remat))
    plain, remat = nets
    assert list(plain.state_dict()) == list(remat.state_dict())
    results = []
    for net in nets:
        out, _ = net(obs, first, (), unroll=True)
        scalar = out.policy_logits.square().sum() + out.values.sum()
        results.append((out, torch.autograd.grad(scalar, list(net.parameters()))))
    (out_p, grads_p), (out_r, grads_r) = results
    assert torch.equal(out_p.policy_logits, out_r.policy_logits)
    assert all(torch.equal(a, b) for a, b in zip(grads_p, grads_r))
    with torch.no_grad():
        step_p, _ = plain(obs[0], first[0], ())
        step_r, _ = remat(obs[0], first[0], ())
    assert torch.equal(step_p.policy_logits, step_r.policy_logits)
