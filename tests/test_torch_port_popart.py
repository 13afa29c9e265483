"""PopArt's ops and the K-wide value head of the PyTorch port held
against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through JAX's
`ops/popart.py` (V-trace by its scan: the Pallas kernel's plain
reference) and the port's (V-trace by its plain version on the CPU), at
DMLab-30's shapes (T = 100, B = 32, 30 tasks, 15 actions) and at a small
one (T = 5, B = 4, 3 tasks). The statistics are moved far from identity,
so sigma spans four decades across the tasks, and rewards come at
task-dependent scales from 0.01 to 100. Tolerances, relative:

- the elementwise ops (sigma, normalize, unnormalize, the head rescale):
  1e-6;
- the moments and the statistics after an update (f32 sums of up to
  T x B terms in another order): 1e-5;
- the losses' logs and gradients at T = 100: 1e-4 (the V-trace
  recursion's rounding accumulates over the unroll).

The K-wide head: `ImpalaNet(num_values=K)` against JAX's through
`params_from_jax` for the MLP, Nature-CNN and deep ResNet + LSTM torsos
at narrow widths (the f32 tolerance of test_torch_port_models.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torched_impala_tpu.models import Agent as JaxAgent
from torched_impala_tpu.models import AtariDeepTorso as JaxDeep
from torched_impala_tpu.models import AtariShallowTorso as JaxAtari
from torched_impala_tpu.models import ImpalaNet as JaxNet
from torched_impala_tpu.models import MLPTorso as JaxMLP
from torched_impala_tpu.ops import losses as jax_losses
from torched_impala_tpu.ops import popart as jax_popart
from torched_impala_tpu_torch import configs
from torched_impala_tpu_torch.models.agent import Agent
from torched_impala_tpu_torch.models.convert import params_from_jax, state_from_jax
from torched_impala_tpu_torch.models.nets import ImpalaNet
from torched_impala_tpu_torch.models.torsos import AtariDeepTorso, AtariShallowTorso, MLPTorso
from torched_impala_tpu_torch.ops import losses as port_losses
from torched_impala_tpu_torch.ops import popart
from torched_impala_tpu_torch.optim import RMSProp
from torched_impala_tpu_torch.runtime.learner import Learner, LearnerConfig

# (T, B, tasks, actions): DMLab-30's learner batch, and a small one.
SHAPES = {"dmlab30": (100, 32, 30, 15), "small": (5, 4, 3, 6)}
OPS = dict(rtol=1e-6, atol=0.0)
SUMS = dict(rtol=1e-5, atol=0.0)
LOSS = 1e-4
F32_NET = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _state(K, seed, clip_ends=False):
    """(mu, nu) far from identity: sigma from 1e-2 to 1e2 across the tasks,
    mu up to two sigmas off 0. `clip_ends`: task 0's nu below mu^2 (sigma
    clipped to sigma_min), the last task's huge (clipped to sigma_max)."""
    rng = np.random.default_rng(seed)
    scale = np.logspace(-2, 2, K)
    mu = scale * rng.uniform(-2, 2, size=K)
    nu = mu**2 + scale**2
    if clip_ends:
        nu[0] = mu[0] ** 2 * 0.5
        mu[-1], nu[-1] = 3.0, 1e14
    return mu.astype(np.float32), nu.astype(np.float32)


def _tasks(B, K, rng):
    """Task ids `[B]` that cover every task where B >= K."""
    tasks = rng.integers(0, K, size=B)
    tasks[: min(B, K)] = rng.permutation(K)[: min(B, K)]
    return rng.permutation(tasks).astype(np.int32)


def _inputs(shape, seed):
    T, B, K, A = SHAPES[shape]
    rng = np.random.default_rng(seed)
    tasks = _tasks(B, K, rng)
    scale = np.logspace(-2, 2, K)[tasks]
    logits = rng.normal(size=(T, B, A)).astype(np.float32)
    mu, nu = _state(K, seed + 100)
    return dict(
        target_logits=logits,
        learner_logits=(logits + 0.3 * rng.normal(size=(T, B, A))).astype(np.float32),
        behaviour_logits=rng.normal(size=(T, B, A)).astype(np.float32),
        norm_values=rng.normal(size=(T + 1, B)).astype(np.float32),
        actions=rng.integers(0, A, size=(T, B)).astype(np.int32),
        rewards=(scale * (rng.normal(size=(T, B)) + 0.5)).astype(np.float32),
        discounts=(0.99 * (rng.uniform(size=(T, B)) > 0.05)).astype(np.float32),
        mask=(rng.uniform(size=(T, B)) > 0.1).astype(np.float32),
        tasks=tasks,
        mu=mu,
        nu=nu,
    )


def _jax_state(x):
    return jax_popart.PopArtState(mu=jnp.asarray(x["mu"]), nu=jnp.asarray(x["nu"]))


def _port_state(x):
    return popart.PopArtState(mu=torch.from_numpy(x["mu"]), nu=torch.from_numpy(x["nu"]))


def _configs(shape, **loss):
    K = SHAPES[shape][2]
    return (
        jax_popart.PopArtConfig(num_values=K),
        popart.PopArtConfig(num_values=K),
        jax_losses.ImpalaLossConfig(vtrace_implementation="scan", **loss),
        port_losses.ImpalaLossConfig(**loss),
    )


def _close(port, want, tol, what=""):
    np.testing.assert_allclose(
        port.detach().numpy(), np.asarray(want), err_msg=what, **tol
    )


def _rel_l2(port, want):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(port.detach().numpy() - want) / np.linalg.norm(want))


def _assert_logs(port_logs, jax_logs):
    assert set(port_logs) == set(jax_logs)
    for k, v in jax_logs.items():
        np.testing.assert_allclose(
            float(port_logs[k].detach()), float(v), rtol=LOSS, atol=LOSS * 1e-3, err_msg=k
        )


# --- The ops, function by function. ---


def test_config_and_init_match_jax():
    assert [f.name for f in dataclasses.fields(popart.PopArtConfig)] == [
        f.name for f in dataclasses.fields(jax_popart.PopArtConfig)
    ]
    assert dataclasses.asdict(popart.PopArtConfig()) == dataclasses.asdict(
        jax_popart.PopArtConfig()
    )
    state, want = popart.init(30), jax_popart.init(30)
    assert popart.PopArtState._fields == ("mu", "nu")
    for a, b in zip(state, want):
        assert a.dtype == torch.float32 and a.shape == (30,)
        _close(a, b, OPS)
    meta = popart.init(3, device="meta")
    assert meta.mu.device.type == "meta"


@pytest.mark.parametrize("shape", SHAPES)
def test_sigma_normalize_unnormalize_match_jax(shape):
    T, B, K, _ = SHAPES[shape]
    mu, nu = _state(K, 1, clip_ends=True)
    jcfg, pcfg, _, _ = _configs(shape)
    jstate = jax_popart.PopArtState(mu=jnp.asarray(mu), nu=jnp.asarray(nu))
    pstate = popart.PopArtState(mu=torch.from_numpy(mu), nu=torch.from_numpy(nu))
    s = popart.sigma(pstate, pcfg)
    _close(s, jax_popart.sigma(jstate, jcfg), OPS, "sigma")
    # Both clip ends are reached.
    assert float(s[0]) == np.float32(pcfg.sigma_min) and float(s[-1]) == np.float32(pcfg.sigma_max)
    rng = np.random.default_rng(2)
    tasks = _tasks(B, K, rng)
    x = (rng.normal(size=(T, B)) * 10).astype(np.float32)
    pt, jt = torch.from_numpy(tasks), jnp.asarray(tasks)
    n = popart.normalize(pstate, pcfg, torch.from_numpy(x), pt)
    _close(n, jax_popart.normalize(jstate, jcfg, jnp.asarray(x), jt), OPS, "normalize")
    u = popart.unnormalize(pstate, pcfg, torch.from_numpy(x), pt)
    _close(u, jax_popart.unnormalize(jstate, jcfg, jnp.asarray(x), jt), OPS, "unnormalize")


@pytest.mark.parametrize("absent", [False, True], ids=["all_tasks", "absent_tasks"])
@pytest.mark.parametrize("shape", SHAPES)
def test_batch_moments_apply_and_update_match_jax(shape, absent):
    T, B, K, _ = SHAPES[shape]
    x = _inputs(shape, 3)
    tasks = x["tasks"]
    if absent:  # only the first half of the tasks appear
        tasks = tasks % max(1, K // 2)
    mask = x["mask"].copy()
    if absent:
        mask[:, 0] = 0.0  # a column with no valid step
    targets = x["rewards"] * 7.0
    jcfg, pcfg, _, _ = _configs(shape)
    pcfg = dataclasses.replace(pcfg, step_size=0.1)
    jcfg = dataclasses.replace(jcfg, step_size=0.1)
    pt = torch.from_numpy(tasks)
    got = popart.batch_moments(pcfg, torch.from_numpy(targets), pt, torch.from_numpy(mask))
    want = jax_popart.batch_moments(jcfg, jnp.asarray(targets), jnp.asarray(tasks), jnp.asarray(mask))
    for name, a, b in zip(("count", "sum", "sum_sq"), got, want):
        assert a.dtype == torch.float32 and a.shape == (K,)
        _close(a, b, dict(rtol=1e-5, atol=1e-5 * float(np.abs(b).max())), name)
    pstate, jstate = _port_state(x), _jax_state(x)
    applied = popart.apply_moments(pstate, pcfg, *got)
    for a, b in zip(applied, jax_popart.apply_moments(jstate, jcfg, *want)):
        _close(a, b, SUMS, "apply_moments")
    updated = popart.update(pstate, pcfg, torch.from_numpy(targets), pt, torch.from_numpy(mask))
    jupdated = jax_popart.update(jstate, jcfg, jnp.asarray(targets), jnp.asarray(tasks), jnp.asarray(mask))
    for a, b in zip(updated, jupdated):
        _close(a, b, SUMS, "update")
    present = np.zeros(K, bool)
    present[np.unique(tasks[mask.sum(0) > 0])] = True
    assert present.any() and (absent == (not present.all()))
    # Tasks with no valid sample keep their statistics bit for bit.
    for a, old in zip(updated, pstate):
        assert torch.equal(a[~torch.from_numpy(present)], old[~torch.from_numpy(present)])
        assert not torch.equal(a[torch.from_numpy(present)], old[torch.from_numpy(present)])


@pytest.mark.parametrize("shape", SHAPES)
def test_rescale_head_matches_jax_with_torch_layout(shape):
    _, _, K, _ = SHAPES[shape]
    rng = np.random.default_rng(4)
    F = 16
    kernel = rng.normal(size=(F, K)).astype(np.float32)  # flax [F, K]
    bias = rng.normal(size=(K,)).astype(np.float32)
    jcfg, pcfg, _, _ = _configs(shape)
    old_mu, old_nu = _state(K, 5, clip_ends=True)
    new_mu, new_nu = _state(K, 6)
    old = (old_mu, old_nu)
    new = (new_mu, new_nu)
    jw, jb = jax_popart.rescale_head(
        jnp.asarray(kernel), jnp.asarray(bias),
        jax_popart.PopArtState(*map(jnp.asarray, old)),
        jax_popart.PopArtState(*map(jnp.asarray, new)), jcfg,
    )
    pw, pb = popart.rescale_head(
        torch.from_numpy(kernel.T.copy()), torch.from_numpy(bias),
        popart.PopArtState(*map(torch.from_numpy, old)),
        popart.PopArtState(*map(torch.from_numpy, new)), pcfg,
    )
    assert pw.shape == (K, F)
    _close(pw, np.asarray(jw).T, OPS, "weight rows")
    _close(pb, jb, OPS, "bias")


def _head_net_pair(kind, K, seed=0):
    """(jax agent, flax params as numpy, port net with them) with a K-wide
    value head, at narrow widths."""
    A = 4
    if kind == "mlp":
        jtorso, torso = JaxMLP(hidden_sizes=(16, 16)), MLPTorso(5, (16, 16))
        example, kw = np.zeros((5,), np.float32), {}
    elif kind == "nature":
        jtorso, torso = JaxAtari(), AtariShallowTorso(4)
        example, kw = np.zeros((84, 84, 4), np.uint8), {}
    else:
        jtorso = JaxDeep(channel_sections=(4, 8, 8), hidden_size=32)
        torso = AtariDeepTorso(3, (12, 16), (4, 8, 8), 2, 32)
        example, kw = np.zeros((12, 16, 3), np.uint8), dict(use_lstm=True, lstm_size=16)
    jnet = JaxNet(num_actions=A, torso=jtorso, num_values=K, **kw)
    jagent = JaxAgent(jnet)
    params = jax.tree.map(
        np.asarray, jagent.init_params(jax.random.key(seed), jnp.asarray(example))
    )
    net = ImpalaNet(A, torso, core="lstm" if kw else "none", lstm_size=16, num_values=K)
    net.load_state_dict(params_from_jax(params))
    return jagent, params, net, example


def _head_inputs(example, T=3, B=2, seed=1):
    rng = np.random.default_rng(seed)
    if example.dtype == np.uint8:
        obs = rng.integers(0, 256, size=(T, B, *example.shape), dtype=np.uint8)
    else:
        obs = rng.normal(size=(T, B, *example.shape)).astype(np.float32)
    first = np.zeros((T, B), np.bool_)
    first[1, 0] = True
    return obs, first


@pytest.mark.parametrize("kind", ["mlp", "nature", "deep_lstm"])
def test_k_wide_value_head_matches_jax(kind):
    K = 5
    jagent, params, net, example = _head_net_pair(kind, K)
    assert net.num_values == K == jagent.net.num_values
    assert net.value_head.weight.shape == (K, net.value_head.in_features)
    assert params["params"]["value_head"]["kernel"].shape == (net.value_head.in_features, K)
    obs, first = _head_inputs(example)
    state = jagent.initial_state(obs.shape[1])
    jout, _ = jagent.unroll(params, jnp.asarray(obs), jnp.asarray(first), state)
    with torch.no_grad():
        pout, _ = Agent(net).unroll(
            torch.from_numpy(obs), torch.from_numpy(first), net.initial_state(obs.shape[1])
        )
    assert pout.values.shape == (*obs.shape[:2], K)
    _close(pout.values, jout.values, F32_NET, "values")
    _close(pout.policy_logits, jout.policy_logits, F32_NET, "logits")


def test_state_from_jax_carries_a_k_wide_head_and_its_rmsprop_nu():
    K = 7
    _, params, net, _ = _head_net_pair("mlp", K)
    opt_state = optax.rmsprop(1e-3, decay=0.99, eps=1e-7).init(params)
    # Give nu values of its own, so a transposition shows.
    opt_state = jax.tree.map(
        lambda x: np.asarray(x) + np.arange(x.size, dtype=np.float32).reshape(x.shape), opt_state
    )
    state = state_from_jax(
        {"params": params, "opt_state": opt_state, "num_frames": np.int64(0), "num_steps": np.int64(0)}
    )
    nu = opt_state[0].nu["params"]["value_head"]["kernel"]
    assert state["opt_state"]["nu"]["value_head.weight"].shape == (K, 16)
    np.testing.assert_array_equal(state["opt_state"]["nu"]["value_head.weight"].numpy(), nu.T)
    np.testing.assert_array_equal(
        state["params"]["value_head.weight"].numpy(), params["params"]["value_head"]["kernel"].T
    )
    net.load_state_dict(state["params"])


@pytest.mark.parametrize("kind", ["mlp", "deep_lstm"])
def test_rescale_params_matches_jax_and_preserves_the_nets_outputs(kind):
    K = 5
    jagent, params, net, example = _head_net_pair(kind, K)
    jcfg, pcfg = jax_popart.PopArtConfig(num_values=K), popart.PopArtConfig(num_values=K)
    old = _state(K, 7, clip_ends=True)
    new = _state(K, 8)
    jnew = jax_popart.rescale_params(
        params, jax_popart.PopArtState(*map(jnp.asarray, old)),
        jax_popart.PopArtState(*map(jnp.asarray, new)), jcfg,
    )
    pold = popart.PopArtState(*map(torch.from_numpy, old))
    pnew = popart.PopArtState(*map(torch.from_numpy, new))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    rescaled = popart.rescale_params(net.state_dict(), pold, pnew, pcfg)
    want = params_from_jax(jax.tree.map(np.asarray, jnew))
    assert set(rescaled) == set(want)
    for k, v in want.items():
        if k.startswith("value_head."):
            _close(rescaled[k], v, OPS, k)
        else:
            assert torch.equal(rescaled[k], v), k
    for k, v in net.state_dict().items():  # the input mapping is unchanged
        assert torch.equal(v, before[k])
    # Output preservation on the port's net: sigma' n' + mu' == sigma n + mu.
    obs, first = _head_inputs(example, T=4, B=3, seed=9)

    def values():
        with torch.no_grad():
            out, _ = Agent(net).unroll(
                torch.from_numpy(obs), torch.from_numpy(first), net.initial_state(3)
            )
        return out.values

    unnorm_old = popart.sigma(pold, pcfg) * values() + pold.mu
    net.load_state_dict(rescaled)
    unnorm_new = popart.sigma(pnew, pcfg) * values() + pnew.mu
    scale = float(unnorm_old.abs().max())
    assert float((unnorm_new - unnorm_old).abs().max()) <= 1e-5 * scale


# --- The losses. ---


def _jax_vtrace_kwargs(x):
    return dict(
        behaviour_logits=jnp.asarray(x["behaviour_logits"]),
        actions=jnp.asarray(x["actions"]),
        rewards=jnp.asarray(x["rewards"]),
        discounts=jnp.asarray(x["discounts"]),
        tasks=jnp.asarray(x["tasks"]),
        state=_jax_state(x),
    )


def _port_vtrace_kwargs(x):
    return dict(
        behaviour_logits=torch.from_numpy(x["behaviour_logits"]),
        actions=torch.from_numpy(x["actions"]),
        rewards=torch.from_numpy(x["rewards"]),
        discounts=torch.from_numpy(x["discounts"]),
        tasks=torch.from_numpy(x["tasks"]),
        state=_port_state(x),
    )


@pytest.mark.parametrize("shape", SHAPES)
def test_unnormalized_vtrace_and_target_moments_match_jax(shape):
    x = _inputs(shape, 11)
    jcfg, pcfg, jloss, ploss = _configs(shape)
    nv = x["norm_values"]
    jvt = jax_popart._unnormalized_vtrace(
        target_logits=jnp.asarray(x["target_logits"]), norm_values=jnp.asarray(nv[:-1]),
        norm_bootstrap=jnp.asarray(nv[-1]), popart_config=jcfg, config=jloss, devices=None,
        **_jax_vtrace_kwargs(x),
    )
    pvt = popart._unnormalized_vtrace(
        target_logits=torch.from_numpy(x["target_logits"]), norm_values=torch.from_numpy(nv[:-1]),
        norm_bootstrap=torch.from_numpy(nv[-1]), popart_config=pcfg, config=ploss,
        **_port_vtrace_kwargs(x),
    )
    for name in ("vs", "pg_advantages", "errors"):
        a, b = getattr(pvt, name), np.asarray(getattr(jvt, name))
        np.testing.assert_allclose(a.numpy(), b, rtol=LOSS, atol=LOSS * 1e-2 * np.abs(b).max(),
                                   err_msg=name)
    jm = jax_popart.popart_target_moments(
        target_logits=jnp.asarray(x["target_logits"]), norm_values=jnp.asarray(nv[:-1]),
        norm_bootstrap=jnp.asarray(nv[-1]), popart_config=jcfg, config=jloss,
        mask=jnp.asarray(x["mask"]), **_jax_vtrace_kwargs(x),
    )
    pm = popart.popart_target_moments(
        target_logits=torch.from_numpy(x["target_logits"]), norm_values=torch.from_numpy(nv[:-1]),
        norm_bootstrap=torch.from_numpy(nv[-1]), popart_config=pcfg, config=ploss,
        mask=torch.from_numpy(x["mask"]), **_port_vtrace_kwargs(x),
    )
    for a, b in zip(pm, jm):
        _close(a, b, SUMS, "moments")


def _jax_loss(x, kind, jcfg, jloss, fixed=None):
    """(total, logs, new state, grad of the logits, grad of the [T+1, B]
    normalized values) of JAX's loss `kind`."""
    kw = _jax_vtrace_kwargs(x)
    if fixed is not None:
        kw["fixed_new_state"] = fixed

    def f(logits, nv):
        if kind == "impala":
            out, new = jax_popart.popart_impala_loss(
                target_logits=logits, norm_values=nv[:-1], norm_bootstrap=nv[-1],
                popart_config=jcfg, config=jloss, mask=jnp.asarray(x["mask"]), **kw,
            )
        else:
            out, new = jax_popart.popart_impact_loss(
                learner_logits=logits, target_logits=jnp.asarray(x["target_logits"]),
                norm_values=nv[:-1], norm_bootstrap=nv[-1], popart_config=jcfg,
                config=jloss, mask=jnp.asarray(x["mask"]), clip_epsilon=0.2, **kw,
            )
        return out.total, (out.logs, new)

    logits = x["target_logits"] if kind == "impala" else x["learner_logits"]
    (total, (logs, new)), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(logits), jnp.asarray(x["norm_values"])
    )
    return total, logs, new, grads


def _port_loss(x, kind, pcfg, ploss, fixed=None):
    kw = _port_vtrace_kwargs(x)
    if fixed is not None:
        kw["fixed_new_state"] = fixed
    logits = torch.from_numpy(x["target_logits" if kind == "impala" else "learner_logits"].copy())
    logits.requires_grad_()
    nv = torch.from_numpy(x["norm_values"].copy()).requires_grad_()
    if kind == "impala":
        out, new = popart.popart_impala_loss(
            target_logits=logits, norm_values=nv[:-1], norm_bootstrap=nv[-1],
            popart_config=pcfg, config=ploss, mask=torch.from_numpy(x["mask"]), **kw,
        )
    else:
        out, new = popart.popart_impact_loss(
            learner_logits=logits, target_logits=torch.from_numpy(x["target_logits"]),
            norm_values=nv[:-1], norm_bootstrap=nv[-1], popart_config=pcfg,
            config=ploss, mask=torch.from_numpy(x["mask"]), clip_epsilon=0.2, **kw,
        )
    grads = torch.autograd.grad(out.total, (logits, nv))
    return out, new, grads


@pytest.mark.parametrize("health", [False, True], ids=["health_off", "health_on"])
@pytest.mark.parametrize("reduction", ["sum", "mean"])
@pytest.mark.parametrize("kind", ["impala", "impact"])
@pytest.mark.parametrize("shape", SHAPES)
def test_popart_losses_and_grads_match_jax(shape, kind, reduction, health):
    x = _inputs(shape, 21)
    jcfg, pcfg, jloss, ploss = _configs(shape, reduction=reduction, health_diagnostics=health)
    total, logs, jnew, (jg_logits, jg_nv) = _jax_loss(x, kind, jcfg, jloss)
    out, pnew, (pg_logits, pg_nv) = _port_loss(x, kind, pcfg, ploss)
    assert any(k.startswith("health_") for k in out.logs) == health
    np.testing.assert_allclose(float(out.total.detach()), float(total), rtol=LOSS)
    _assert_logs(out.logs, logs)
    for a, b in zip(pnew, jnew):
        assert not a.requires_grad
        _close(a, b, SUMS, "new statistics")
    assert _rel_l2(pg_logits, jg_logits) <= LOSS
    assert _rel_l2(pg_nv, jg_nv) <= LOSS
    # norm_bootstrap (the last row) gets no gradient, in either package.
    assert not np.asarray(jg_nv)[-1].any()
    assert not pg_nv[-1].any()
    if kind == "impact":
        assert 0.0 < float(out.logs["impact_clip_frac"]) < 1.0


@pytest.mark.parametrize("shape", SHAPES)
def test_fixed_new_state_matches_jax(shape):
    x = _inputs(shape, 31)
    jcfg, pcfg, jloss, ploss = _configs(shape)
    fixed = _state(SHAPES[shape][2], 32)
    jfixed = jax_popart.PopArtState(*map(jnp.asarray, fixed))
    pfixed = popart.PopArtState(*(torch.from_numpy(a).requires_grad_() for a in fixed))
    total, logs, jnew, (jg_logits, jg_nv) = _jax_loss(x, "impala", jcfg, jloss, fixed=jfixed)
    out, pnew, (pg_logits, pg_nv) = _port_loss(x, "impala", pcfg, ploss, fixed=pfixed)
    np.testing.assert_allclose(float(out.total.detach()), float(total), rtol=LOSS)
    _assert_logs(out.logs, logs)
    for a, b in zip(pnew, fixed):  # the supplied statistics, detached
        assert not a.requires_grad and torch.equal(a, torch.from_numpy(b))
    assert _rel_l2(pg_logits, jg_logits) <= LOSS
    assert _rel_l2(pg_nv, jg_nv) <= LOSS


def test_baseline_gradient_is_scaled_by_the_statistics_move():
    """d(baseline term)/d(norm_values) = -(norm_target - norm_value_new) *
    s_old / s_new, the chain rule through the re-expression under the new
    statistics."""
    x = _inputs("small", 41)
    _, pcfg, _, ploss = _configs("small", vf_coef=1.0, entropy_coef=0.0)
    _, new, (_, g_nv) = _port_loss(x, "impala", pcfg, ploss)
    state = _port_state(x)
    tasks = torch.from_numpy(x["tasks"]).long()
    s_old, s_new = popart.sigma(state, pcfg)[tasks], popart.sigma(new, pcfg)[tasks]
    nv = torch.from_numpy(x["norm_values"][:-1])
    vt = popart._unnormalized_vtrace(
        target_logits=torch.from_numpy(x["target_logits"]), norm_values=nv,
        norm_bootstrap=torch.from_numpy(x["norm_values"][-1]), popart_config=pcfg,
        config=ploss, **_port_vtrace_kwargs(x),
    )
    mu_old, mu_new = state.mu[tasks], new.mu[tasks]
    err = (vt.vs - mu_new) / s_new - (s_old * nv + mu_old - mu_new) / s_new
    want = -err * s_old / s_new * torch.from_numpy(x["mask"])
    torch.testing.assert_close(g_nv[:-1], want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_grad_accum_batch_end_scheme(shape):
    """`popart_target_moments` summed over G = 2 column halves, then
    `apply_moments` once, equals `update` on the full batch (and JAX's);
    the halves' `popart_impala_loss` under that `fixed_new_state` sum to
    the full batch's loss, and their gradients to its gradients."""
    x = _inputs(shape, 51)
    T, B, K, _ = SHAPES[shape]
    jcfg, pcfg, jloss, ploss = _configs(shape)
    pcfg = dataclasses.replace(pcfg, step_size=0.05)
    jcfg = dataclasses.replace(jcfg, step_size=0.05)
    col = {k: 1 for k in ("target_logits", "learner_logits", "behaviour_logits", "norm_values",
                          "actions", "rewards", "discounts", "mask")}
    col["tasks"] = 0

    def half(i):
        sl = slice(i * B // 2, (i + 1) * B // 2)
        return {k: (v[:, sl] if col.get(k) == 1 else v[sl] if k in col else v) for k, v in x.items()}

    def moments(y):
        return popart.popart_target_moments(
            target_logits=torch.from_numpy(y["target_logits"]),
            norm_values=torch.from_numpy(y["norm_values"][:-1]),
            norm_bootstrap=torch.from_numpy(y["norm_values"][-1]), popart_config=pcfg,
            config=ploss, mask=torch.from_numpy(y["mask"]), **_port_vtrace_kwargs(y),
        )

    summed = [a + b for a, b in zip(moments(half(0)), moments(half(1)))]
    batch_end = popart.apply_moments(_port_state(x), pcfg, *summed)
    full_update = popart.update(
        _port_state(x), pcfg,
        popart._unnormalized_vtrace(
            target_logits=torch.from_numpy(x["target_logits"]),
            norm_values=torch.from_numpy(x["norm_values"][:-1]),
            norm_bootstrap=torch.from_numpy(x["norm_values"][-1]), popart_config=pcfg,
            config=ploss, **_port_vtrace_kwargs(x),
        ).vs,
        torch.from_numpy(x["tasks"]), torch.from_numpy(x["mask"]),
    )
    _, _, jnew, _ = _jax_loss(x, "impala", jcfg, jloss)
    for a, b, c in zip(batch_end, full_update, jnew):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0.0)
        _close(a, c, SUMS, "batch-end statistics against JAX's update")
    full, _, (g_logits, g_nv) = _port_loss(x, "impala", pcfg, ploss, fixed=batch_end)
    halves = [_port_loss(half(i), "impala", pcfg, ploss, fixed=batch_end) for i in range(2)]
    for key in port_losses.SUM_REDUCED_LOG_KEYS:
        np.testing.assert_allclose(
            float((halves[0][0].logs[key] + halves[1][0].logs[key]).detach()),
            float(full.logs[key].detach()),
            rtol=1e-5, atol=1e-6 * abs(float(full.total.detach())), err_msg=key,
        )
    torch.testing.assert_close(torch.cat([h[2][0] for h in halves], dim=1), g_logits,
                               rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(torch.cat([h[2][1] for h in halves], dim=1), g_nv,
                               rtol=1e-5, atol=1e-7)


# --- The learner's refusal and the config's head. ---


def test_learner_refuses_a_value_head_wider_than_one():
    net = ImpalaNet(2, MLPTorso(4, (8,)), num_values=3)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1: DMLab-30"):
        Learner(agent=Agent(net), optimizer=RMSProp(lambda count: 1e-3),
                config=LearnerConfig(batch_size=2, unroll_length=2), device="cpu")
    # One value: the learner builds, as before.
    Learner(agent=Agent(ImpalaNet(2, MLPTorso(4, (8,)))), optimizer=RMSProp(lambda count: 1e-3),
            config=LearnerConfig(batch_size=2, unroll_length=2), device="cpu")


def test_make_agent_head_is_num_tasks_wide_and_num_tasks_above_one_still_raises():
    for cfg in (configs.CARTPOLE, configs.BREAKOUT):
        net = configs.make_agent(cfg).net
        assert net.num_values == cfg.num_tasks == 1
        assert net.value_head.weight.shape == (1, net.value_head.in_features)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1: DMLab-30"):
        dataclasses.replace(configs.BREAKOUT, num_tasks=30)


def measured_maxima() -> dict:
    """The largest port-against-JAX distances that the tests above gate,
    over both shapes: element by element relative for the ops, the moments
    and the statistics after an update; relative for the losses' logs and
    relative L2 for their gradients (both losses, both reductions, health
    off and on), and relative for the losses' new statistics."""

    def rel(port, want):
        a = np.asarray(port.detach().numpy() if torch.is_tensor(port) else port, np.float64)
        b = np.asarray(want, np.float64)
        d, m = np.abs(a - b), np.maximum(np.abs(a), np.abs(b))
        return float(np.where(d > 0, d / np.where(m > 0, m, 1.0), 0.0).max())

    out = dict.fromkeys(("ops", "moments", "statistics", "logs", "grads", "loss_statistics"), 0.0)

    def note(key, *values):
        out[key] = max(out[key], *values)

    for shape, (T, B, K, _) in SHAPES.items():
        jcfg, pcfg, _, _ = _configs(shape)
        mu, nu = _state(K, 1, clip_ends=True)
        jstate, pstate = jax_popart.PopArtState(jnp.asarray(mu), jnp.asarray(nu)), popart.PopArtState(
            torch.from_numpy(mu), torch.from_numpy(nu))
        rng = np.random.default_rng(2)
        tasks = _tasks(B, K, rng)
        y = (rng.normal(size=(T, B)) * 10).astype(np.float32)
        note("ops", rel(popart.sigma(pstate, pcfg), jax_popart.sigma(jstate, jcfg)))
        for fn in ("normalize", "unnormalize"):
            note("ops", rel(getattr(popart, fn)(pstate, pcfg, torch.from_numpy(y), torch.from_numpy(tasks)),
                            getattr(jax_popart, fn)(jstate, jcfg, jnp.asarray(y), jnp.asarray(tasks))))
        old, new = _state(K, 5, clip_ends=True), _state(K, 6)
        kernel, bias = rng.normal(size=(16, K)).astype(np.float32), rng.normal(size=K).astype(np.float32)
        jw, jb = jax_popart.rescale_head(jnp.asarray(kernel), jnp.asarray(bias),
                                         jax_popart.PopArtState(*map(jnp.asarray, old)),
                                         jax_popart.PopArtState(*map(jnp.asarray, new)), jcfg)
        pw, pb = popart.rescale_head(torch.from_numpy(kernel.T.copy()), torch.from_numpy(bias),
                                     popart.PopArtState(*map(torch.from_numpy, old)),
                                     popart.PopArtState(*map(torch.from_numpy, new)), pcfg)
        note("ops", rel(pw, np.asarray(jw).T), rel(pb, jb))
        x = _inputs(shape, 3)
        args = (x["rewards"] * 7.0, x["tasks"], x["mask"])
        pargs, jargs = [torch.from_numpy(a) for a in args], [jnp.asarray(a) for a in args]
        note("moments", *(rel(a, b) for a, b in zip(popart.batch_moments(pcfg, *pargs),
                                                    jax_popart.batch_moments(jcfg, *jargs))))
        pstep, jstep = (dataclasses.replace(c, step_size=0.1) for c in (pcfg, jcfg))
        note("statistics", *(rel(a, b) for a, b in zip(popart.update(_port_state(x), pstep, *pargs),
                                                       jax_popart.update(_jax_state(x), jstep, *jargs))))
        for kind in ("impala", "impact"):
            for reduction in ("sum", "mean"):
                for health in (False, True):
                    x = _inputs(shape, 21)
                    jcfg, pcfg, jloss, ploss = _configs(shape, reduction=reduction,
                                                        health_diagnostics=health)
                    _, logs, jnew, jgrads = _jax_loss(x, kind, jcfg, jloss)
                    loss, pnew, pgrads = _port_loss(x, kind, pcfg, ploss)
                    note("logs", *(rel(float(loss.logs[k].detach()), float(v)) for k, v in logs.items()))
                    note("grads", *(_rel_l2(a, b) for a, b in zip(pgrads, jgrads)))
                    note("loss_statistics", *(rel(a, b) for a, b in zip(pnew, jnew)))
    return out


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_port_popart.py
    print(measured_maxima())
