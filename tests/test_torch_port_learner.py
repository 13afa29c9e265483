"""The PyTorch port's Learner held against the JAX Learner step by step.

Extends the pattern of tests/test_torch_update_parity.py (which holds an
independent torch update against the JAX learner) to the port's own
`Learner`: identical flax-initialised params, identical numpy batches,
3 SGD steps each through the real JAX `Learner` (f32, V-trace 'scan')
and the port's `Learner` on the CPU. After every step the params must
agree at rtol 1e-4, atol 1e-6, and so must the loss logs and
`grad_norm_unclipped` (rtol 1e-4, atol 1e-5: the total is a sum of terms
of order 1 that can cancel to near 0, where only an absolute bound is
meaningful): one forward, backward, global-norm clip and optax-semantics
RMSProp step per step, in f32.

Also: `set_state` refuses a bad state before it replaces anything (the
same refusals as JAX's `validate_restored_shapes`), and a JAX learner's
state carried across by `state_from_jax` takes the same next step in the
port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torched_impala_tpu import configs as jax_configs
from torched_impala_tpu.models import Agent as JaxAgent
from torched_impala_tpu.models import AtariShallowTorso as JaxAtari
from torched_impala_tpu.models import ImpalaNet as JaxNet
from torched_impala_tpu.models import MLPTorso as JaxMLP
from torched_impala_tpu.ops import ImpalaLossConfig as JaxLossConfig
from torched_impala_tpu.runtime import Learner as JaxLearner
from torched_impala_tpu.runtime import LearnerConfig as JaxLearnerConfig
from torched_impala_tpu.runtime import Trajectory as JaxTrajectory
from torched_impala_tpu.runtime import stack_trajectories as jax_stack
from torched_impala_tpu.utils.checkpoint import (
    validate_restored_shapes as jax_validate_restored_shapes,
)
from torched_impala_tpu_torch import configs
from torched_impala_tpu_torch.models.agent import Agent
from torched_impala_tpu_torch.models.convert import params_from_jax, state_from_jax
from torched_impala_tpu_torch.models.nets import ImpalaNet
from torched_impala_tpu_torch.models.torsos import AtariShallowTorso, MLPTorso
from torched_impala_tpu_torch.optim import RMSProp
from torched_impala_tpu_torch.runtime.learner import Learner, LearnerConfig
from torched_impala_tpu_torch.runtime.learner import stack_trajectories
from torched_impala_tpu_torch.runtime.types import Trajectory

STEPS = 3
A = 6
LR, DECAY, EPS = 6e-4, 0.99, 1e-7
LOG_KEYS = (
    "total_loss",
    "pg_loss",
    "baseline_loss",
    "entropy_loss",
    "grad_norm_unclipped",
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


LSTM = 8


def _arrays(kind, T, B, round_idx):
    out = []
    for b in range(B):
        rng = np.random.default_rng(100 * round_idx + b)
        if kind in ("mlp", "lstm"):
            obs = rng.normal(size=(T + 1, 4)).astype(np.float32)
        else:
            obs = rng.integers(0, 256, size=(T + 1, 84, 84, 4), dtype=np.uint8)
        first = rng.uniform(size=(T + 1,)) < 0.2
        out.append(
            dict(
                obs=obs,
                first=first,
                actions=rng.integers(0, A, size=(T,)).astype(np.int32),
                behaviour_logits=rng.normal(size=(T, A)).astype(np.float32),
                rewards=rng.normal(size=(T,)).astype(np.float32),
                cont=(rng.uniform(size=(T,)) > 0.1).astype(np.float32),
                agent_state=tuple(
                    rng.normal(size=(1, LSTM)).astype(np.float32) * 0.5 for _ in range(2)
                ) if kind == "lstm" else (),
            )
        )
    return out


def _build(kind, T, B, max_grad_norm=40.0):
    core = {}
    if kind in ("mlp", "lstm"):
        jtorso, torso = JaxMLP(hidden_sizes=(16, 16)), MLPTorso(4, (16, 16))
        example = np.zeros((4,), np.float32)
        if kind == "lstm":
            core = dict(use_lstm=True, lstm_size=LSTM)
    else:
        jtorso, torso = JaxAtari(dtype=jnp.float32), AtariShallowTorso(4)
        example = np.zeros((84, 84, 4), np.uint8)
    jlearner = JaxLearner(
        agent=JaxAgent(JaxNet(num_actions=A, torso=jtorso, **core)),
        optimizer=optax.rmsprop(LR, decay=DECAY, eps=EPS),
        config=JaxLearnerConfig(
            batch_size=B,
            unroll_length=T,
            loss=JaxLossConfig(vtrace_implementation="scan"),
            max_grad_norm=max_grad_norm,
            queue_capacity=STEPS * B,
        ),
        example_obs=example,
        rng=jax.random.key(0),
    )
    net = ImpalaNet(A, torso, core="lstm" if core else "none", lstm_size=LSTM)
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jlearner.params)))
    learner = Learner(
        agent=Agent(net),
        optimizer=RMSProp(LR, decay=DECAY, eps=EPS),
        config=LearnerConfig(batch_size=B, unroll_length=T, max_grad_norm=max_grad_norm),
        device=torch.device("cpu"),
    )
    return jlearner, learner


@pytest.mark.parametrize(
    "kind,T,B", [("mlp", 6, 3), ("atari", 3, 2)], ids=["mlp", "pong_width"]
)
def test_learner_param_trajectory_matches_jax(kind, T, B):
    _assert_steps_match(*_build(kind, T, B), kind, T, B)


@pytest.mark.parametrize("max_grad_norm", [None, 0.05], ids=["unclipped", "clipped"])
def test_learner_clip_off_and_on_matches_jax(max_grad_norm):
    """`max_grad_norm=None` takes the unclipped step the JAX learner takes
    (no scale, no multiply); a clip well under the gradient's norm scales
    every step as JAX's does. Same tolerances as the trajectory test."""
    jlearner, learner = _build("mlp", 6, 3, max_grad_norm=max_grad_norm)
    grad_norms = _assert_steps_match(jlearner, learner, "mlp", 6, 3)
    # Each step's norm is past 0.05, so the clipped case really clips.
    assert min(grad_norms) > 0.05, grad_norms


def _assert_steps_match(jlearner, learner, kind, T, B):
    """STEPS SGD steps through both learners on the same batches; the logs
    and the params agree after every step. Returns the port's unclipped
    grad norms."""
    grad_norms = []
    # The port's queue holds 2B unrolls: start its batcher first.
    learner.start()
    for r in range(STEPS):
        for a in _arrays(kind, T, B, r):
            jlearner.enqueue(JaxTrajectory(**a))
            learner.enqueue(Trajectory(**a))
    jlearner.start()
    try:
        for step in range(STEPS):
            jlogs = jlearner.step_once(timeout=300)
            plogs = learner.step_once(timeout=60)
            grad_norms.append(float(plogs["grad_norm_unclipped"]))
            for key in LOG_KEYS:
                np.testing.assert_allclose(
                    float(plogs[key]),
                    float(jlogs[key]),
                    rtol=1e-4,
                    atol=1e-5,
                    err_msg=f"step {step} log {key}",
                )
            want = params_from_jax(jax.tree.map(np.asarray, jlearner.params))
            for name, p in learner.params.items():
                np.testing.assert_allclose(
                    p.detach().numpy(),
                    want[name].numpy(),
                    rtol=1e-4,
                    atol=1e-6,
                    err_msg=f"step {step} param {name}",
                )
    finally:
        jlearner.stop()
        learner.stop()
        learner.join()
    assert learner.num_steps == STEPS
    assert learner.num_frames == STEPS * T * B
    return grad_norms


def test_get_state_set_state_round_trip():
    _, learner = _build("mlp", 6, 3)
    learner.start()
    try:
        for a in _arrays("mlp", 6, 3, 0):
            learner.enqueue(Trajectory(**a))
        learner.step_once(timeout=60)
    finally:
        learner.stop()
        learner.join()
    state = learner.get_state()
    assert state["num_steps"] == 1 and state["opt_state"]["count"] == 1
    net = ImpalaNet(A, MLPTorso(4, (16, 16)))
    fresh = Learner(
        agent=Agent(net),
        optimizer=RMSProp(LR, decay=DECAY, eps=EPS),
        config=LearnerConfig(batch_size=3, unroll_length=6),
        device=torch.device("cpu"),
    )
    fresh.set_state(state)
    for name, p in fresh.params.items():
        torch.testing.assert_close(p.detach(), state["params"][name])
    version, published = fresh.param_store.get(timeout=1)
    assert version == learner.num_frames == fresh.num_frames
    torch.testing.assert_close(published["value_head.bias"], state["params"]["value_head.bias"])
    bad = dict(state, opt_state=dict(
        state["opt_state"],
        nu={k: v.to(torch.bfloat16) for k, v in state["opt_state"]["nu"].items()},
    ))
    with pytest.raises(ValueError, match="float32"):
        fresh.set_state(bad)


def _bad_params(case, port, jax_params):
    """The same fault in the port's flat params and in the JAX flax tree:
    a broadcastable wrong shape ([1, N] for [M, N]), a missing key or an
    extra key."""
    port, jax_params = dict(port), jax.tree.map(np.asarray, jax_params)
    jdense = jax_params["params"]["torso"]["Dense_0"]
    if case == "broadcastable_shape":
        port["torso.Dense_0.weight"] = port["torso.Dense_0.weight"][:1].clone()
        jdense["kernel"] = jdense["kernel"][:, :1]
        return port, jax_params, "torso.Dense_0.weight: restored (1, 4) vs live (16, 4)"
    if case == "missing_key":
        del port["torso.Dense_0.bias"], jdense["bias"]
        return port, jax_params, "torso.Dense_0.bias: missing from the restored tree"
    port["torso.Extra.weight"] = torch.zeros(3)
    jdense["extra"] = np.zeros(3, np.float32)
    return port, jax_params, "torso.Extra.weight: not present in the live tree"


@pytest.mark.parametrize("case", ["broadcastable_shape", "missing_key", "extra_key"])
def test_set_state_refuses_bad_params_and_keeps_live_state(case):
    """Each bad state raises a ValueError that names the entry, before any
    live param or `nu` is written (`Tensor.copy_` would broadcast the
    [1, N] tensor over [M, N]); JAX's `validate_restored_shapes` refuses
    the same fault in the matching JAX tree."""
    jlearner, learner = _build("mlp", 6, 3)
    _assert_steps_match(jlearner, learner, "mlp", 6, 3)
    state = learner.get_state()
    params, jparams, message = _bad_params(case, state["params"], jlearner.params)
    bad = dict(state, params=params, opt_state=dict(
        state["opt_state"], nu={k: torch.zeros_like(v) for k, v in state["opt_state"]["nu"].items()}
    ))
    live = {k: v.detach().clone() for k, v in learner.params.items()}
    live_nu = {k: v.clone() for k, v in learner._optimizer.nu.items()}
    with pytest.raises(ValueError, match="does not match the live params") as info:
        learner.set_state(bad)
    assert message in str(info.value)
    for name, p in learner.params.items():
        assert torch.equal(p.detach(), live[name]), name
    for name, v in learner._optimizer.nu.items():
        assert torch.equal(v, live_nu[name]), name
    assert learner.num_steps == STEPS and learner._optimizer.count == STEPS
    with pytest.raises(ValueError, match="does not match the live params"):
        jax_validate_restored_shapes(jparams, jlearner.params, what="params")


def test_set_state_refuses_bad_nu_before_copying_params():
    """A `nu` of the wrong shape is refused before the params are copied:
    no half-restored learner."""
    _, learner = _build("mlp", 6, 3)
    state = learner.get_state()
    fresh = {k: torch.full_like(v, 7.0) for k, v in state["params"].items()}
    nu = dict(state["opt_state"]["nu"])
    nu["value_head.weight"] = torch.zeros(1, 1)
    live = {k: v.detach().clone() for k, v in learner.params.items()}
    with pytest.raises(ValueError, match="value_head.weight: restored \\(1, 1\\)"):
        learner.set_state(dict(state, params=fresh, opt_state=dict(state["opt_state"], nu=nu)))
    for name, p in learner.params.items():
        assert torch.equal(p.detach(), live[name]), name


@pytest.mark.parametrize("kind", ["mlp", "lstm"])
def test_state_from_jax_then_one_step_matches_jax(kind):
    """A JAX learner takes 2 steps; the port learner takes its state
    through `state_from_jax` (params, RMSProp nu with the LSTM gates
    concatenated, count and counters); both then take a third step on the
    same batch and agree at the trajectory test's tolerance."""
    T, B = 6, 3
    jlearner, learner = _build(kind, T, B)
    jlearner.start()
    learner.start()
    try:
        for r in range(2):
            for a in _arrays(kind, T, B, r):
                jlearner.enqueue(JaxTrajectory(**a))
            jlearner.step_once(timeout=300)
        state = state_from_jax(jax.tree.map(np.asarray, jlearner.get_state()))
        assert state["num_steps"] == 2 and state["opt_state"]["count"] == 2
        assert state["num_frames"] == 2 * T * B
        learner.set_state(state)
        version, _ = learner.param_store.get(timeout=1)
        assert version == 2 * T * B
        for a in _arrays(kind, T, B, 2):
            jlearner.enqueue(JaxTrajectory(**a))
            learner.enqueue(Trajectory(**a))
        jlogs = jlearner.step_once(timeout=300)
        plogs = learner.step_once(timeout=60)
    finally:
        jlearner.stop()
        learner.stop()
        learner.join()
    for key in LOG_KEYS:
        np.testing.assert_allclose(
            float(plogs[key]), float(jlogs[key]), rtol=1e-4, atol=1e-5, err_msg=key
        )
    want = params_from_jax(jax.tree.map(np.asarray, jlearner.params))
    for name, p in learner.params.items():
        np.testing.assert_allclose(
            p.detach().numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6, err_msg=name
        )
    assert learner.num_steps == 3 and learner._optimizer.count == 3


def test_stack_trajectories_matches_jax():
    arrays = _arrays("mlp", 4, 3, 0)
    ours = stack_trajectories([Trajectory(**a) for a in arrays])
    theirs = jax_stack([JaxTrajectory(**a) for a in arrays])
    for field in ("obs", "first", "actions", "behaviour_logits", "rewards", "cont"):
        np.testing.assert_array_equal(getattr(ours, field), getattr(theirs, field))


def test_rmsprop_and_schedule_match_optax():
    """The hand-written RMSProp under the preset's linear anneal tracks
    optax.rmsprop(make_lr_schedule(cfg)) over steps that cross the end
    of the schedule (eps inside the sqrt, nu from 0, lr by count)."""
    import dataclasses

    cfg = dataclasses.replace(configs.PONG, total_env_frames=4 * 640)
    jcfg = dataclasses.replace(jax_configs.PONG, total_env_frames=4 * 640)
    assert cfg.total_learner_steps == jcfg.total_learner_steps == 4
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    jopt = jax_configs.make_optimizer(jcfg)
    jp = jnp.asarray(p0)
    jstate = jopt.init(jp)
    opt = configs.make_optimizer(cfg)
    params = {"w": torch.from_numpy(p0.copy())}
    opt.init(params)
    for _ in range(6):
        g = rng.normal(size=p0.shape).astype(np.float32) * 0.01
        updates, jstate = jopt.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step(params, {"w": torch.from_numpy(g)})
        np.testing.assert_allclose(
            params["w"].numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7
        )
