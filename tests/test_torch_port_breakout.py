"""The Breakout slice of the PyTorch port held against the JAX package.

Narrow Breakout shapes (16x16x4 uint8 obs, deep torso (4, 8, 8) with 2
blocks a section, Dense(32), LSTM(16), 4 actions), flax-initialised
params carried across by `params_from_jax`:

- `ImpalaNet` with the LSTM core (JAX `lstm_impl="fused"`) over an unroll
  with `first` resets mid-unroll from a non-zero start state: logits,
  values and the final carry at rtol 1e-5, atol 1e-5 in f32 (convs and
  matmuls sum in another order); bf16 torso at atol 3e-2;
- step mode equals unroll mode step by step;
- the learner over 3 SGD steps against the JAX `Learner` with non-zero
  start states in the batch: params rtol 1e-4, atol 1e-6 and logs rtol
  1e-4, atol 1e-5, as tests/test_torch_port_learner.py holds Pong;
- the actor's start state reaches the learner: a learner unroll from the
  stacked state reproduces the actor's own step-by-step logits;
- `loop.train` and the CLI with the BREAKOUT preset on the CPU.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torched_impala_tpu.models import Agent as JaxAgent
from torched_impala_tpu.models import AtariDeepTorso as JaxDeep
from torched_impala_tpu.models import ImpalaNet as JaxNet
from torched_impala_tpu.ops import ImpalaLossConfig as JaxLossConfig
from torched_impala_tpu.runtime import Learner as JaxLearner
from torched_impala_tpu.runtime import LearnerConfig as JaxLearnerConfig
from torched_impala_tpu.runtime import Trajectory as JaxTrajectory
from torched_impala_tpu_torch import configs, run
from torched_impala_tpu_torch.models.agent import Agent
from torched_impala_tpu_torch.models.convert import params_from_jax
from torched_impala_tpu_torch.models.nets import ImpalaNet
from torched_impala_tpu_torch.models.torsos import AtariDeepTorso
from torched_impala_tpu_torch.ops import conv_block_cuda, lstm_cuda
from torched_impala_tpu_torch.optim import RMSProp
from torched_impala_tpu_torch.runtime import loop
from torched_impala_tpu_torch.runtime.learner import Learner, LearnerConfig
from torched_impala_tpu_torch.runtime.learner import stack_trajectories
from torched_impala_tpu_torch.runtime.types import Trajectory

HW, SECTIONS, HIDDEN, LSTM, A = (16, 16), (4, 8, 8), 32, 16, 4
F32 = dict(rtol=1e-5, atol=1e-5)
LR, DECAY, EPS = 6e-4, 0.99, 1e-7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_net(dtype="float32", fused=False):
    torso = JaxDeep(
        channel_sections=SECTIONS,
        hidden_size=HIDDEN,
        dtype=jnp.dtype(dtype),
        fused_blocks=fused,
    )
    return JaxNet(num_actions=A, torso=torso, use_lstm=True, lstm_size=LSTM)


def _port_net(dtype="float32", fused=False):
    torso = AtariDeepTorso(
        4, HW, SECTIONS, 2, HIDDEN, dtype=dtype, fused_blocks=fused
    )
    return ImpalaNet(A, torso, core="lstm", lstm_size=LSTM)


@pytest.fixture(scope="module")
def flax_params():
    agent = JaxAgent(_jax_net())
    params = agent.init_params(jax.random.key(0), jnp.zeros((*HW, 4), jnp.uint8))
    return jax.tree.map(np.asarray, params)


def _unroll_inputs(seed, T=5, B=3):
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 256, size=(T, B, *HW, 4), dtype=np.uint8)
    first = np.zeros((T, B), np.bool_)
    first[2, 0] = first[3, 1] = first[0, 2] = True
    state = tuple(rng.normal(size=(B, LSTM)).astype(np.float32) for _ in range(2))
    return obs, first, state


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_net_matches_jax_with_resets(flax_params, dtype, fused):
    obs, first, state = _unroll_inputs(1)
    jout, jstate = JaxAgent(_jax_net(dtype, fused)).unroll(
        flax_params, jnp.asarray(obs), jnp.asarray(first), tuple(map(jnp.asarray, state))
    )
    net = _port_net(dtype, fused)
    net.load_state_dict(params_from_jax(flax_params))
    with torch.no_grad():
        pout, pstate = Agent(net).unroll(
            torch.from_numpy(obs), torch.from_numpy(first), tuple(map(torch.from_numpy, state))
        )
    tol = F32 if dtype == "float32" else dict(rtol=0, atol=3e-2)
    np.testing.assert_allclose(pout.policy_logits.numpy(), np.asarray(jout.policy_logits), **tol)
    np.testing.assert_allclose(pout.values.numpy(), np.asarray(jout.values), **tol)
    for p, j in zip(pstate, jstate):
        assert p.dtype == torch.float32
        np.testing.assert_allclose(p.numpy(), np.asarray(j), **tol)


def test_reset_zeroes_the_carry_before_the_cell(flax_params):
    """Where first is set the start state is dropped: any state gives the
    zero state's outputs at that row."""
    obs, first, state = _unroll_inputs(2)
    first[0] = True
    net = _port_net()
    net.load_state_dict(params_from_jax(flax_params))
    zeros = net.initial_state(3)
    with torch.no_grad():
        a, _ = net(torch.from_numpy(obs), torch.from_numpy(first), tuple(map(torch.from_numpy, state)), unroll=True)
        b, _ = net(torch.from_numpy(obs), torch.from_numpy(first), zeros, unroll=True)
    torch.testing.assert_close(a.policy_logits, b.policy_logits, rtol=0, atol=0)


def test_step_mode_equals_unroll_mode(flax_params):
    obs, first, state = _unroll_inputs(3)
    net = _port_net()
    net.load_state_dict(params_from_jax(flax_params))
    obs_t, first_t = torch.from_numpy(obs), torch.from_numpy(first)
    with torch.no_grad():
        unrolled, end = net(obs_t, first_t, tuple(map(torch.from_numpy, state)), unroll=True)
        s = tuple(map(torch.from_numpy, state))
        for t in range(obs.shape[0]):
            out, s = net(obs_t[t], first_t[t], s)
            torch.testing.assert_close(out.policy_logits, unrolled.policy_logits[t])
            torch.testing.assert_close(out.values, unrolled.values[t])
    for a, b in zip(s, end):
        torch.testing.assert_close(a, b)


def test_initial_state_is_two_f32_zero_carries():
    net = _port_net()
    c, h = net.initial_state(5)
    assert c.shape == h.shape == (5, LSTM)
    assert c.dtype == h.dtype == torch.float32
    assert float(c.abs().sum() + h.abs().sum()) == 0.0


def _learner_arrays(T, B, round_idx):
    out = []
    for b in range(B):
        rng = np.random.default_rng(1000 + 100 * round_idx + b)
        out.append(
            dict(
                obs=rng.integers(0, 256, size=(T + 1, *HW, 4), dtype=np.uint8),
                first=rng.uniform(size=(T + 1,)) < 0.25,
                actions=rng.integers(0, A, size=(T,)).astype(np.int32),
                behaviour_logits=rng.normal(size=(T, A)).astype(np.float32),
                rewards=rng.normal(size=(T,)).astype(np.float32),
                cont=(rng.uniform(size=(T,)) > 0.1).astype(np.float32),
                agent_state=tuple(
                    rng.normal(size=(1, LSTM)).astype(np.float32) * 0.5
                    for _ in range(2)
                ),
            )
        )
    return out


def test_learner_matches_jax_learner_with_start_states():
    T, B, steps = 3, 2, 3
    jlearner = JaxLearner(
        agent=JaxAgent(_jax_net()),
        optimizer=optax.rmsprop(LR, decay=DECAY, eps=EPS),
        config=JaxLearnerConfig(
            batch_size=B,
            unroll_length=T,
            loss=JaxLossConfig(vtrace_implementation="scan"),
            max_grad_norm=40.0,
            queue_capacity=steps * B,
        ),
        example_obs=np.zeros((*HW, 4), np.uint8),
        rng=jax.random.key(0),
    )
    net = _port_net()
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jlearner.params)))
    learner = Learner(
        agent=Agent(net),
        optimizer=RMSProp(LR, decay=DECAY, eps=EPS),
        config=LearnerConfig(batch_size=B, unroll_length=T),
        device=torch.device("cpu"),
    )
    learner.start()
    for r in range(steps):
        for a in _learner_arrays(T, B, r):
            jlearner.enqueue(JaxTrajectory(**a))
            learner.enqueue(Trajectory(**a))
    jlearner.start()
    try:
        for step in range(steps):
            jlogs = jlearner.step_once(timeout=300)
            plogs = learner.step_once(timeout=60)
            for key in ("total_loss", "pg_loss", "baseline_loss", "entropy_loss", "grad_norm_unclipped"):
                np.testing.assert_allclose(
                    float(plogs[key]), float(jlogs[key]), rtol=1e-4, atol=1e-5,
                    err_msg=f"step {step} log {key}",
                )
            want = params_from_jax(jax.tree.map(np.asarray, jlearner.params))
            for name, p in learner.params.items():
                np.testing.assert_allclose(
                    p.detach().numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                    err_msg=f"step {step} param {name}",
                )
    finally:
        jlearner.stop()
        learner.stop()
        learner.join()
    assert learner.num_steps == steps


def test_stack_trajectories_concatenates_start_states():
    arrays = _learner_arrays(2, 3, 0)
    batch = stack_trajectories([Trajectory(**a) for a in arrays])
    c, h = batch.agent_state
    assert c.shape == h.shape == (3, LSTM)
    np.testing.assert_array_equal(h[1:2], arrays[1]["agent_state"][1])
    ff = stack_trajectories([Trajectory(**dict(a, agent_state=())) for a in arrays])
    assert ff.agent_state == ()


def test_actor_start_state_reaches_the_learner_unroll():
    """Each env's trajectory carries ITS carry at obs[0]: a learner unroll
    from the stacked start states reproduces the logits the actor acted
    with, step by step, in the second unroll (where the carry is not
    zero). Unrolling from zeros instead (what a learner that drops the
    state does) does not."""
    from torched_impala_tpu_torch.envs.fake import ScriptedEnv
    from torched_impala_tpu_torch.models.torsos import MLPTorso
    from torched_impala_tpu_torch.runtime.param_store import ParamStore
    from torched_impala_tpu_torch.runtime.vector_actor import VectorActor

    g = torch.Generator().manual_seed(0)
    net = ImpalaNet(2, MLPTorso(4, (8,), generator=g), core="lstm", lstm_size=6, generator=g)
    store = ParamStore()
    store.publish(0, dict(net.named_parameters()))
    got = []
    actor = VectorActor(
        actor_id=0,
        envs=[ScriptedEnv(episode_len=n) for n in (3, 4, 7)],
        agent=Agent(net),
        param_store=store,
        enqueue=got.append,
        unroll_length=5,
        device=torch.device("cpu"),
    )
    actor.unroll_and_push()
    actor.unroll_and_push()
    second = got[3:]
    for i, traj in enumerate(second):
        c, h = traj.agent_state
        assert c.shape == h.shape == (1, 6)
        assert float(np.abs(h).sum()) > 0
    batch = stack_trajectories(second)
    obs, first = torch.from_numpy(batch.obs), torch.from_numpy(batch.first)
    with torch.no_grad():
        out, _ = Agent(net).unroll(obs, first, tuple(map(torch.from_numpy, batch.agent_state)))
        from_zero, _ = Agent(net).unroll(obs, first, net.initial_state(3))
    np.testing.assert_allclose(
        out.policy_logits[:-1].numpy(), batch.behaviour_logits, rtol=1e-6, atol=1e-6
    )
    assert np.abs(from_zero.policy_logits[:-1].numpy() - batch.behaviour_logits).max() > 1e-4


def _small_breakout(**kw):
    return dataclasses.replace(
        configs.BREAKOUT,
        actor_mode="thread",
        num_actors=2,
        envs_per_actor=2,
        unroll_length=4,
        batch_size=4,
        **kw,
    )


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_train_breakout_slice_on_cpu(fused):
    cfg = _small_breakout(fused_conv=fused)
    agent = configs.make_agent(cfg, seed=0)
    assert agent.net.core == "lstm" and agent.net.torso.dtype == torch.bfloat16
    before = {k: v.detach().clone() for k, v in agent.net.state_dict().items()}
    launches = (lstm_cuda.LAUNCHES, conv_block_cuda.LAUNCHES)
    result = loop.train(
        agent=agent,
        env_factory=configs.make_env_factory(cfg, fake=True),
        num_actors=cfg.num_actors,
        envs_per_actor=cfg.envs_per_actor,
        learner_config=configs.make_learner_config(cfg),
        optimizer=configs.make_optimizer(cfg),
        total_steps=2,
        device="cpu",
        log_every=1,
    )
    assert result.learner.num_steps == 2
    assert math.isfinite(result.final_logs["total_loss"])
    moved = [not torch.equal(before[k], v.detach()) for k, v in agent.net.state_dict().items()]
    assert all(moved)
    # The CPU run takes the plain versions: no kernel launched.
    assert (lstm_cuda.LAUNCHES, conv_block_cuda.LAUNCHES) == launches


@pytest.mark.parametrize("extra", ["", " --fused-conv"], ids=["unfused", "fused"])
def test_breakout_cli_returns_zero(capsys, extra):
    """The Breakout CPU command of README.md, with and without --fused-conv."""
    from pathlib import Path

    readme = " ".join(
        (Path(__file__).resolve().parents[1] / "README.md").read_text().replace("\\\n", " ").split()
    )
    assert f"python -m torched_impala_tpu_torch.run {run.BREAKOUT_CPU_EXAMPLE}" in readme
    rc = run.main((run.BREAKOUT_CPU_EXAMPLE + extra).split())
    assert rc == 0
    assert "done: steps=3" in capsys.readouterr().out


def test_breakout_preset_keeps_the_jax_values():
    from torched_impala_tpu import configs as jax_configs

    ours, theirs = configs.BREAKOUT, jax_configs.BREAKOUT
    for field in dataclasses.fields(ours):
        assert getattr(ours, field.name) == getattr(theirs, field.name), field.name


def test_fused_conv_needs_the_deep_torso():
    with pytest.raises(ValueError, match="deep_resnet"):
        configs.make_agent(dataclasses.replace(configs.PONG, fused_conv=True))
