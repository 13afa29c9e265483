"""The PROCGEN slice of the PyTorch port held against the JAX package.

- the `procgen` preset's fields equal JAX's PROCGEN, and `num_tasks` and
  `dp_devices` JAX's on every ported preset;
- the env factory's shaped fakes (64x64x3, and 72x96x3 as DMLab's) give
  JAX `_EnvFactory(cfg, fake=True)`'s pixels, rewards and episode ends
  exactly, with JAX's task ids, and survive a pickle round trip;
  `StragglerEnv`'s delays are JAX's draws for the same seed;
- the deep ResNet without a core at narrow width (16x16x3 uint8 obs,
  sections (4, 8, 8), Dense(32), 15 actions), flax-initialised params
  carried across by `params_from_jax`: logits and values at rtol 1e-5,
  atol 1e-5 in f32, atol 3e-2 with a bf16 torso, unfused and fused (the
  tolerances of tests/test_torch_port_breakout.py); at full width the
  JAX PROCGEN agent's params load into the port's (64 -> 32 -> 16 -> 8,
  flatten 8 * 8 * 32 = 2048) and give its f32 logits;
- the learner over 3 SGD steps against the JAX `Learner`: losses rtol
  1e-4, atol 1e-5 and params rtol 1e-4, atol 1e-6, as
  `test_learner_matches_jax_learner_with_start_states`;
- `loop.train` with the preset on two async worker processes, plain and
  with stragglers, and the CLI with `--dp`.
"""

import dataclasses
import pickle
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torched_impala_tpu import configs as jax_configs
from torched_impala_tpu.envs import fake as jax_fake
from torched_impala_tpu.models import Agent as JaxAgent
from torched_impala_tpu.models import AtariDeepTorso as JaxDeep
from torched_impala_tpu.models import ImpalaNet as JaxNet
from torched_impala_tpu.ops import ImpalaLossConfig as JaxLossConfig
from torched_impala_tpu.runtime import Learner as JaxLearner
from torched_impala_tpu.runtime import LearnerConfig as JaxLearnerConfig
from torched_impala_tpu.runtime import Trajectory as JaxTrajectory
from torched_impala_tpu_torch import configs, run
from torched_impala_tpu_torch.envs import fake
from torched_impala_tpu_torch.models.agent import Agent
from torched_impala_tpu_torch.models.convert import params_from_jax
from torched_impala_tpu_torch.models.nets import ImpalaNet
from torched_impala_tpu_torch.models.torsos import AtariDeepTorso
from torched_impala_tpu_torch.optim import RMSProp
from torched_impala_tpu_torch.runtime import loop
from torched_impala_tpu_torch.runtime.learner import Learner, LearnerConfig
from torched_impala_tpu_torch.runtime.types import Trajectory

HW, SECTIONS, HIDDEN, A = (16, 16), (4, 8, 8), 32, 15
F32 = dict(rtol=1e-5, atol=1e-5)
LR, DECAY, EPS = 6e-4, 0.99, 1e-7
DMLAB_SHAPE = (72, 96, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_procgen_preset_keeps_the_jax_values():
    ours, theirs = configs.PROCGEN, jax_configs.PROCGEN
    for field in dataclasses.fields(ours):
        assert getattr(ours, field.name) == getattr(theirs, field.name), field.name
    assert configs.PRESETS["procgen"] is ours
    assert (ours.obs_shape, ours.num_actions, ours.batch_size, ours.num_actors) == (
        (64, 64, 3), 15, 64, 512)
    assert (ours.pool_mode, ours.pool_ready_fraction, ours.dp_devices) == ("async", 0.5, -1)


@pytest.mark.parametrize("name", sorted(configs.PRESETS))
def test_every_preset_has_the_jax_task_and_device_counts(name):
    ours, theirs = configs.PRESETS[name], getattr(jax_configs, name.upper())
    assert (ours.num_tasks, ours.dp_devices) == (theirs.num_tasks, theirs.dp_devices)


def test_multi_task_configs_raise_naming_the_item():
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1: DMLab-30"):
        dataclasses.replace(configs.PROCGEN, num_tasks=30)


def _factories(shape):
    ours = dataclasses.replace(configs.PROCGEN, obs_shape=shape)
    theirs = dataclasses.replace(jax_configs.PROCGEN, obs_shape=shape)
    return configs.make_env_factory(ours, fake=True), jax_configs.make_env_factory(theirs, fake=True)


def _rollout(env, steps, seed):
    """obs, rewards and dones of `steps` steps with actions drawn from
    `seed`; a finished episode is reset, as the actors do."""
    rng = np.random.default_rng(seed)
    obs, _ = env.reset()
    frames, rewards, dones = [obs], [], []
    for _ in range(steps):
        obs, reward, terminated, truncated, _ = env.step(int(rng.integers(A)))
        done = terminated or truncated
        if done:
            obs, _ = env.reset()
        frames.append(obs)
        rewards.append(reward)
        dones.append(done)
    return np.stack(frames), rewards, dones


@pytest.mark.parametrize("shape", [(64, 64, 3), DMLAB_SHAPE], ids=str)
def test_shaped_fakes_match_jax_exactly(shape):
    ours, theirs = _factories(shape)
    ours = pickle.loads(pickle.dumps(ours))
    for seed, env_index in ((0, 0), (3, 1), (1005, 7), (42, None)):
        mine, ref = ours(seed, env_index), theirs(seed, env_index)
        assert mine.task_id == ref.task_id == ours._task_of(seed, env_index)
        assert mine.action_space_n == ref.action_space_n == A
        got, want = _rollout(mine, 50, seed), _rollout(ref, 50, seed)
        assert got[0].dtype == np.uint8 and got[0].shape == (51, *shape)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] and got[2] == want[2]


def test_shaped_fakes_end_episodes_as_jax_does():
    """A short episode length shows the episode ends: both streams reset
    at the same steps and keep equal pixels after."""
    mine = fake.FakeAtariEnv(episode_len=7, num_actions=A, seed=9, obs_shape=DMLAB_SHAPE)
    ref = jax_fake.FakeAtariEnv(episode_len=7, num_actions=A, seed=9)
    ref._obs = lambda: ref._rng.integers(0, 256, size=DMLAB_SHAPE, dtype=np.uint8)
    got, want = _rollout(mine, 30, 1), _rollout(ref, 30, 1)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] and sum(got[2]) == 4


def test_task_of_is_jax_rule():
    """`env_index % num_tasks`, the seed when no index is given: read
    against JAX's factory on a 30-task stand-in config (the port refuses
    such a preset itself)."""
    stand_in = types.SimpleNamespace(num_tasks=30)
    ours = configs._EnvFactory(stand_in)
    theirs = jax_configs._EnvFactory(stand_in, True)
    for seed, env_index in ((0, 0), (5, 31), (1000, 59), (2017, None), (7, 1_000_003)):
        assert ours._task_of(seed, env_index) == theirs._task_of(seed, env_index)


def test_straggler_delays_match_jax(monkeypatch):
    """The same delays, drawn from `seed + 17`, over the same pixels."""
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)
    delays = dict(base_delay_s=1e-4, straggler_delay_s=0.05, straggler_prob=0.3)
    ours, theirs = _factories((64, 64, 3))
    mine = fake.StragglerFactory(ours, **delays)
    mine = pickle.loads(pickle.dumps(mine))(11, 2)
    ref = jax_fake.StragglerFactory(theirs, **delays)(11, 2)
    assert isinstance(mine, fake.StragglerEnv) and mine.task_id == ref.task_id == 0
    got = _rollout(mine, 60, 4)
    mine_slept, slept[:] = list(slept), []
    want = _rollout(ref, 60, 4)
    assert mine_slept == slept and len(slept) == 60
    assert 0 < sum(d > 1e-3 for d in slept) < 60
    np.testing.assert_array_equal(got[0], want[0])


def _jax_net(dtype="float32", fused=False):
    torso = JaxDeep(
        channel_sections=SECTIONS, hidden_size=HIDDEN, dtype=jnp.dtype(dtype), fused_blocks=fused
    )
    return JaxNet(num_actions=A, torso=torso, use_lstm=False)


def _port_net(dtype="float32", fused=False):
    torso = AtariDeepTorso(3, HW, SECTIONS, 2, HIDDEN, dtype=dtype, fused_blocks=fused)
    return ImpalaNet(A, torso, core="none")


@pytest.fixture(scope="module")
def flax_params():
    params = JaxAgent(_jax_net()).init_params(jax.random.key(0), jnp.zeros((*HW, 3), jnp.uint8))
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deep_net_without_core_matches_jax(flax_params, dtype, fused):
    rng = np.random.default_rng(1)
    obs = rng.integers(0, 256, size=(5, 3, *HW, 3), dtype=np.uint8)
    first = np.zeros((5, 3), np.bool_)
    first[2, 0] = first[0, 2] = True
    jout, jstate = JaxAgent(_jax_net(dtype, fused)).unroll(
        flax_params, jnp.asarray(obs), jnp.asarray(first), ()
    )
    net = _port_net(dtype, fused)
    net.load_state_dict(params_from_jax(flax_params))
    with torch.no_grad():
        pout, pstate = Agent(net).unroll(torch.from_numpy(obs), torch.from_numpy(first), ())
    assert pstate == () and jstate == ()
    assert pout.policy_logits.shape == (5, 3, A)
    tol = F32 if dtype == "float32" else dict(rtol=0, atol=3e-2)
    np.testing.assert_allclose(pout.policy_logits.numpy(), np.asarray(jout.policy_logits), **tol)
    np.testing.assert_allclose(pout.values.numpy(), np.asarray(jout.values), **tol)


def test_full_width_procgen_agent_takes_the_jax_params():
    """JAX's PROCGEN agent (f32 torso here) into `configs.make_agent`'s:
    the same names and shapes, Dense_0 over 8 * 8 * 32 = 2048 features,
    and the same logits and values on 64x64x3 pixels."""
    cfg = dataclasses.replace(configs.PROCGEN, compute_dtype="float32")
    jcfg = dataclasses.replace(jax_configs.PROCGEN, compute_dtype="float32")
    jagent = jax_configs.make_agent(jcfg)
    params = jagent.init_params(jax.random.key(1), jax_configs.example_obs(jcfg))
    agent = configs.make_agent(cfg)
    assert agent.net.core == "none"
    assert agent.net.torso.Dense_0.in_features == 2048
    agent.net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    rng = np.random.default_rng(2)
    obs = rng.integers(0, 256, size=(2, 2, 64, 64, 3), dtype=np.uint8)
    first = np.ones((2, 2), np.bool_)
    jout, _ = jagent.unroll(params, jnp.asarray(obs), jnp.asarray(first), ())
    with torch.no_grad():
        pout, _ = agent.unroll(torch.from_numpy(obs), torch.from_numpy(first), ())
    np.testing.assert_allclose(pout.policy_logits.numpy(), np.asarray(jout.policy_logits), **F32)
    np.testing.assert_allclose(pout.values.numpy(), np.asarray(jout.values), **F32)


def _learner_arrays(T, B, round_idx):
    out = []
    for b in range(B):
        rng = np.random.default_rng(2000 + 100 * round_idx + b)
        out.append(
            dict(
                obs=rng.integers(0, 256, size=(T + 1, *HW, 3), dtype=np.uint8),
                first=rng.uniform(size=(T + 1,)) < 0.25,
                actions=rng.integers(0, A, size=(T,)).astype(np.int32),
                behaviour_logits=rng.normal(size=(T, A)).astype(np.float32),
                rewards=rng.normal(size=(T,)).astype(np.float32),
                cont=(rng.uniform(size=(T,)) > 0.1).astype(np.float32),
                agent_state=(),
            )
        )
    return out


def test_learner_matches_jax_learner():
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
        example_obs=np.zeros((*HW, 3), np.uint8),
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


@pytest.mark.parametrize("stragglers", [False, True], ids=["plain", "stragglers"])
def test_train_procgen_on_async_process_workers(stragglers):
    """The preset's async pool on two worker processes (two pools of one):
    every frame counted once, nothing restarted, the params moved."""
    cfg = dataclasses.replace(configs.PROCGEN, num_actors=2, unroll_length=4, batch_size=4)
    assert (cfg.actor_mode, cfg.pool_mode) == ("process", "async")
    factory = configs.make_env_factory(cfg, fake=True)
    if stragglers:
        factory = fake.StragglerFactory(
            factory, base_delay_s=1e-3, straggler_delay_s=0.02, straggler_prob=0.1
        )
    agent = configs.make_agent(cfg, seed=0)
    assert agent.net.core == "none" and agent.net.torso.dtype == torch.bfloat16
    before = {k: v.detach().clone() for k, v in agent.net.state_dict().items()}
    steps = 3
    result = loop.train(
        agent=agent,
        env_factory=factory,
        num_actors=cfg.num_actors,
        envs_per_actor=cfg.envs_per_actor,
        actor_mode=cfg.actor_mode,
        pool_mode=cfg.pool_mode,
        pool_ready_fraction=cfg.pool_ready_fraction,
        learner_config=configs.make_learner_config(cfg),
        optimizer=configs.make_optimizer(cfg),
        total_steps=steps,
        device="cpu",
        log_every=1,
    )
    assert result.learner.num_steps == steps
    assert result.num_frames == steps * cfg.unroll_length * cfg.batch_size
    assert result.actor_restarts == 0 and result.final_logs["pool_restarts"] == 0
    assert len(result.pool_pids) == 2
    assert np.isfinite(result.final_logs["total_loss"])
    assert all(not torch.equal(before[k], v.detach()) for k, v in agent.net.state_dict().items())


@pytest.mark.parametrize(
    "extra,steps",
    [("", 3), (" --traj-ring", 3), (" --superbatch-k 2 --total-steps 4", 4),
     (" --actor-mode thread --dp -1", 3), (" --actor-mode thread --dp 0 --fused-conv", 3),
     (" --actor-mode thread --fused-epilogue", 3)],
    ids=["preset", "ring", "superbatch", "dp_all", "fused_conv", "fused_epilogue"],
)
def test_procgen_cli_returns_zero(capsys, extra, steps):
    """The PROCGEN CPU command of README.md with the port's flags: the
    preset's async pool, with the ring and with superbatches; the dp and
    fused flags on thread actors (fewer worker processes in the suite);
    `--dp -1` is one device on the CPU."""
    from pathlib import Path

    readme = " ".join(
        (Path(__file__).resolve().parents[1] / "README.md").read_text().replace("\\\n", " ").split()
    )
    assert f"python -m torched_impala_tpu_torch.run {run.PROCGEN_CPU_EXAMPLE}" in readme
    assert run.main((run.PROCGEN_CPU_EXAMPLE + extra).split()) == 0
    out = capsys.readouterr().out
    assert f"done: steps={steps} frames={steps * 16} " in out
    assert " first_step_s=" in out and " frames_per_s_after_first_step=" in out


@pytest.mark.parametrize("dp", ["2", "4"])
def test_procgen_cli_refuses_more_than_one_device(dp):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1: DP and multi-process training"):
        run.main((run.PROCGEN_CPU_EXAMPLE + f" --dp {dp}").split())


def test_dp_devices_resolve_to_one_device():
    cpu = torch.device("cpu")
    assert configs.resolve_dp_devices(0, cpu) == configs.resolve_dp_devices(-1, cpu) == 1
    assert configs.resolve_dp_devices(1, cpu) == 1
    with pytest.raises(ValueError, match="dp_devices"):
        configs.resolve_dp_devices(-2, cpu)
