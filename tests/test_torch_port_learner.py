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
from torched_impala_tpu_torch.ops.losses import ImpalaLossConfig
from torched_impala_tpu_torch.optim import RMSProp
from torched_impala_tpu_torch.runtime.learner import Learner, LearnerConfig
from torched_impala_tpu_torch.runtime.learner import split_batch, stack_trajectories
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


def _build(kind, T, B, max_grad_norm=40.0, reduction="sum", **fields):
    """The JAX learner and the port's from the same flax params; `fields`
    (grad_accum, publish_interval, ...) go to both LearnerConfigs."""
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
            loss=JaxLossConfig(vtrace_implementation="scan", reduction=reduction),
            max_grad_norm=max_grad_norm,
            queue_capacity=STEPS * B,
            **fields,
        ),
        example_obs=example,
        rng=jax.random.key(0),
    )
    net = ImpalaNet(A, torso, core="lstm" if core else "none", lstm_size=LSTM)
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jlearner.params)))
    learner = Learner(
        agent=Agent(net),
        optimizer=RMSProp(LR, decay=DECAY, eps=EPS),
        config=LearnerConfig(
            batch_size=B,
            unroll_length=T,
            loss=ImpalaLossConfig(reduction=reduction),
            max_grad_norm=max_grad_norm,
            **fields,
        ),
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


SCHEDULES = {
    "anneal": {},
    "warmup_anneal_scaled": dict(lr_warmup_steps=2, lr_scale_ref_batch=16),
    "warmup_constant": dict(lr_warmup_steps=3, lr_anneal=False),
    "scaled_constant": dict(lr_scale_ref_batch=64, lr_anneal=False),
}


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_rmsprop_and_schedule_match_optax(schedule):
    """The hand-written RMSProp under `make_lr_schedule(cfg)` tracks
    optax.rmsprop(make_lr_schedule(cfg)) over steps that cross the end
    of the schedule (eps inside the sqrt, nu from 0, lr by count): the
    preset's linear anneal, a warmup into the anneal with the base lr
    scaled by B / lr_scale_ref_batch, a warmup into a constant, and a
    scaled constant. `scaled_base_lr` and the schedule's values at counts
    0-7 equal JAX's."""
    import dataclasses

    fields = dict(total_env_frames=4 * 640, **SCHEDULES[schedule])
    cfg = dataclasses.replace(configs.PONG, **fields)
    jcfg = dataclasses.replace(jax_configs.PONG, **fields)
    assert cfg.total_learner_steps == jcfg.total_learner_steps == 4
    assert configs.scaled_base_lr(cfg) == jax_configs.scaled_base_lr(jcfg)
    ours, theirs = configs.make_lr_schedule(cfg), jax_configs.make_lr_schedule(jcfg)
    assert callable(ours) == callable(theirs)
    for count in range(8):
        np.testing.assert_allclose(
            ours(count) if callable(ours) else ours,
            float(theirs(count)) if callable(theirs) else theirs,
            rtol=1e-6,
            err_msg=f"lr at count {count}",
        )
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


def _port_only(kind, T, B, optimizer=None, **fields):
    """The port's learner alone, params from torch seed 0 (the same net for
    every call with the same `kind`)."""
    g = torch.Generator().manual_seed(0)
    core = dict(core="lstm", lstm_size=LSTM) if kind == "lstm" else {}
    net = ImpalaNet(A, MLPTorso(4, (16, 16), generator=g), generator=g, **core)
    return Learner(
        agent=Agent(net),
        optimizer=optimizer or RMSProp(LR, decay=DECAY, eps=EPS),
        config=LearnerConfig(batch_size=B, unroll_length=T, **fields),
        device=torch.device("cpu"),
        example_obs=np.zeros((4,), np.float32),
    )


def _device_batch(learner, kind, T, B, round_idx):
    return learner._to_device(
        stack_trajectories([Trajectory(**a) for a in _arrays(kind, T, B, round_idx)])
    )


@pytest.mark.parametrize("reduction", ["sum", "mean"])
@pytest.mark.parametrize("kind", ["mlp", "lstm"])
def test_grad_accum_matches_jax(kind, reduction):
    """G = 2 microbatches in the port against the JAX learner's microbatch
    scan at G = 2, MLP and LSTM (start states split by rows), both
    reductions: the trajectory test's tolerances over STEPS steps (JAX
    tests/test_learner.py TestGradAccum holds G against G = 1 there)."""
    T, B = 5, 4
    jlearner, learner = _build(kind, T, B, reduction=reduction, grad_accum=2)
    _assert_steps_match(jlearner, learner, kind, T, B)


@pytest.mark.parametrize("reduction", ["sum", "mean"])
@pytest.mark.parametrize("kind", ["mlp", "lstm"])
@pytest.mark.parametrize("G", [2, 4])
def test_grad_accum_takes_the_full_batch_step(G, kind, reduction):
    """The port at G = 2 and 4 (the accumulator added into in place from
    the third microbatch) against the port at G = 1 on the same batches
    and params: the full batch's update. The grads are f32 sums taken in
    another order (G microbatch sums added), so params agree at rtol 1e-5,
    atol 1e-7 and the logs at rtol 1e-5, atol 1e-6."""
    T, B = 5, 4
    whole, accum = _port_only(kind, T, B), _port_only(kind, T, B, grad_accum=G)
    for r in range(STEPS):
        batch = _device_batch(whole, kind, T, B, r)
        want, got = whole.train_step(batch), accum.train_step(batch)
        for key in (*LOG_KEYS, "entropy", "weight_norm"):
            np.testing.assert_allclose(
                float(got[key]), float(want[key]), rtol=1e-5, atol=1e-6,
                err_msg=f"step {r} log {key}",
            )
        for name, p in accum.params.items():
            np.testing.assert_allclose(
                p.detach().numpy(), whole.params[name].detach().numpy(),
                rtol=1e-5, atol=1e-7, err_msg=f"step {r} param {name}",
            )


def test_split_batch_takes_jax_column_order():
    """Microbatch g holds columns g*Bm ... (g+1)*Bm - 1 of each [T, B, ...]
    array (JAX's reshape to [T, G, Bm, ...] then swapaxes) and those rows
    of the start state, each contiguous."""
    T, B, G = 3, 6, 3
    x = torch.arange((T + 1) * B * 2).reshape(T + 1, B, 2)
    state = (torch.arange(B * 4).reshape(B, 4), torch.arange(B * 4).reshape(B, 4) + 100)
    arrays = (x, x[..., 0], x[:-1], x[:-1], x[:-1, :, 0], x[:-1, :, 0], state)
    micro = split_batch(arrays, G)
    want = np.swapaxes(x.numpy().reshape(T + 1, G, B // G, 2), 0, 1)
    assert len(micro) == G
    for g, m in enumerate(micro):
        np.testing.assert_array_equal(m[0].numpy(), want[g])
        np.testing.assert_array_equal(m[6][1].numpy(), state[1][g * 2 : (g + 1) * 2].numpy())
        assert all(t.is_contiguous() for t in (*m[:6], *m[6]))


@pytest.mark.parametrize(
    "G,B,message",
    [(0, 4, "grad_accum must be >= 1, got 0"), (2, 3, "batch_size 3 not divisible by grad_accum 2")],
    ids=["zero", "indivisible"],
)
def test_grad_accum_refusals_match_jax(G, B, message):
    """The port refuses what the JAX learner refuses, with its message:
    no quiet G = 1."""
    import re

    with pytest.raises(ValueError, match=re.escape(message)):
        _port_only("mlp", 4, B, grad_accum=G)
    with pytest.raises(ValueError, match=re.escape(message)):
        JaxLearner(
            agent=JaxAgent(JaxNet(num_actions=A, torso=JaxMLP(hidden_sizes=(16, 16)))),
            optimizer=optax.rmsprop(LR, decay=DECAY, eps=EPS),
            config=JaxLearnerConfig(batch_size=B, unroll_length=4, grad_accum=G),
            example_obs=np.zeros((4,), np.float32),
            rng=jax.random.key(0),
        )


def test_queue_sizes_follow_the_config():
    """queue_capacity None is 2 * batch_size (JAX's rule with one step a
    dispatch); device_queue_depth sizes the device queue and the ring's
    slots (depth + 2)."""
    learner = _port_only("mlp", 4, 3)
    assert (learner._traj_q.maxsize, learner._batch_q.maxsize) == (6, 2)
    learner = _port_only("mlp", 4, 3, queue_capacity=7, device_queue_depth=3, traj_ring=True)
    assert (learner._traj_q.maxsize, learner._batch_q.maxsize) == (7, 3)
    assert learner.traj_ring.num_slots == 5
    learner.stop()


def test_publish_interval_publishes_on_crossings_and_set_state_at_once():
    """With publish_interval=3 the param store's version moves only when
    the step count crosses a multiple of 3, and then to that step's frame
    count; `set_state` republishes at once."""
    T, B, steps = 4, 2, 5
    frames = T * B
    learner = _port_only("mlp", T, B, publish_interval=3, queue_capacity=steps * B)
    versions, live_at_3 = [], None
    learner.start()
    try:
        for r in range(steps):
            for a in _arrays("mlp", T, B, r):
                learner.enqueue(Trajectory(**a))
        for step in range(1, steps + 1):
            learner.step_once(timeout=60)
            versions.append(learner.param_store.get(timeout=1)[0])
            if step == 3:
                live_at_3 = {k: v.detach().clone() for k, v in learner.params.items()}
    finally:
        learner.stop()
        learner.join()
    assert versions == [0, 0, 3 * frames, 3 * frames, 3 * frames]
    _, published = learner.param_store.get(timeout=1)
    for name, p in published.items():
        assert torch.equal(p, live_at_3[name]), name
    learner.set_state(learner.get_state())
    version, published = learner.param_store.get(timeout=1)
    assert version == steps * frames
    for name, p in published.items():
        assert torch.equal(p, learner.params[name].detach()), name


def test_resume_mid_warmup_takes_the_uninterrupted_lr():
    """A run restored through get_state/set_state inside the warmup takes
    its next step at the lr of the uninterrupted run (the schedule is
    indexed by the restored count, on the ramp), which is JAX's schedule
    at that count, and lands on the same params bit for bit."""
    import dataclasses

    T, B = 4, 2
    fields = dict(batch_size=B, unroll_length=T, lr_warmup_steps=4, lr_scale_ref_batch=4)
    cfg = dataclasses.replace(configs.CARTPOLE, **fields)
    jcfg = dataclasses.replace(jax_configs.CARTPOLE, **fields)
    straight = _port_only("mlp", T, B, optimizer=configs.make_optimizer(cfg))
    first = _port_only("mlp", T, B, optimizer=configs.make_optimizer(cfg))
    for r in range(2):
        straight.train_step(_device_batch(straight, "mlp", T, B, r))
        first.train_step(_device_batch(first, "mlp", T, B, r))
    resumed = _port_only("mlp", T, B, optimizer=configs.make_optimizer(cfg))
    resumed.set_state(first.get_state())
    batch = _device_batch(straight, "mlp", T, B, 2)
    straight.train_step(batch)
    resumed.train_step(batch)
    lr = resumed._optimizer.last_lr
    assert lr == straight._optimizer.last_lr
    assert 0 < lr < configs.scaled_base_lr(cfg)
    np.testing.assert_allclose(lr, float(jax_configs.make_lr_schedule(jcfg)(2)), rtol=1e-6)
    for name, p in resumed.params.items():
        assert torch.equal(p, straight.params[name]), name
