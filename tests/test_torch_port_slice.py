"""The Pong slice of the PyTorch port end to end on the CPU.

- `loop.train` with the PONG preset (84x84x4 uint8, Nature-CNN, bf16
  torso), fake envs, 2 thread actors x 2 envs, T=4, B=4, 3 learner steps:
  finite loss, params moved, and the plain V-trace taken (no kernel);
- the CLI returns 0 (the process-mode example runs in
  tests/test_torch_port_env_pool.py);
- the paths not ported yet raise, naming their ROADMAP items;
- an AST scan: nothing under torched_impala_tpu_torch/, nor chip_smoke.py,
  imports JAX, flax, optax, chex or the JAX package;
- without CUDA, `resolve_device()` raises instead of returning the CPU.
"""

import ast
import dataclasses
import math
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from torched_impala_tpu_torch import configs, resolve_device, run
from torched_impala_tpu_torch.ops import vtrace as port_vtrace
from torched_impala_tpu_torch.ops import vtrace_cuda
from torched_impala_tpu_torch.runtime import loop

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "chex", "torched_impala_tpu"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _small_pong():
    return dataclasses.replace(
        configs.PONG,
        actor_mode="thread",
        num_actors=2,
        envs_per_actor=2,
        unroll_length=4,
        batch_size=4,
    )


def test_train_pong_slice_on_cpu(monkeypatch):
    cfg = _small_pong()
    calls = []
    real = port_vtrace.vtrace_reference

    def spy(**kwargs):
        calls.append(kwargs["log_rhos"].shape)
        return real(**kwargs)

    monkeypatch.setattr(port_vtrace, "vtrace_reference", spy)
    agent = configs.make_agent(cfg, seed=0)
    before = {k: v.detach().clone() for k, v in agent.net.state_dict().items()}
    launches = vtrace_cuda.LAUNCHES
    result = loop.train(
        agent=agent,
        env_factory=configs.make_env_factory(cfg, fake=True),
        num_actors=cfg.num_actors,
        envs_per_actor=cfg.envs_per_actor,
        learner_config=configs.make_learner_config(cfg),
        optimizer=configs.make_optimizer(cfg),
        total_steps=3,
        device="cpu",
        log_every=1,
    )
    learner = result.learner
    assert learner.num_steps == 3
    assert result.num_frames == 3 * 4 * 4
    assert math.isfinite(result.final_logs["total_loss"])
    assert learner.last_batch_device == torch.device("cpu")
    assert agent.net.torso.dtype == torch.bfloat16
    moved = [
        not torch.equal(before[k], v.detach())
        for k, v in agent.net.state_dict().items()
    ]
    assert all(moved)
    assert calls == [(4, 4)] * 3  # one plain V-trace per learner step
    assert vtrace_cuda.LAUNCHES == launches


def test_cli_returns_zero(capsys):
    """The CPU command of README.md, run exactly as documented."""
    readme = " ".join((ROOT / "README.md").read_text().replace("\\\n", " ").split())
    assert f"python -m torched_impala_tpu_torch.run {run.CPU_EXAMPLE}" in readme
    rc = run.main(run.CPU_EXAMPLE.split())
    assert rc == 0
    assert "done: steps=3" in capsys.readouterr().out


def test_unported_paths_raise():
    """Each path not ported yet raises, naming its ROADMAP item by title."""
    from torched_impala_tpu_torch.runtime.traj_ring import TrajectoryRing

    cfg = _small_pong()
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1: Real envs"):
        configs.make_env_factory(cfg, fake=False)
    # Process actors are ported; the pool's ready-fraction tuner is not.
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1: Observability, perf and control"):
        loop.train(
            agent=configs.make_agent(cfg),
            env_factory=configs.make_env_factory(cfg, fake=True),
            num_actors=1,
            learner_config=configs.make_learner_config(cfg),
            optimizer=configs.make_optimizer(cfg),
            total_steps=1,
            actor_mode="process",
            pool_mode="async",
            pool_ready_fraction="auto",
            device="cpu",
        )
    ring = dict(num_slots=2, unroll_length=2, batch_size=2,
                example_obs=np.zeros((4,), np.float32), num_actions=2)
    # Replay is ported; JAX's refusal of superbatch slots with it stays.
    with pytest.raises(ValueError, match="superbatch slots cannot be replayed"):
        TrajectoryRing(**ring, max_reuse=2, superbatch_k=2)
    # Superbatch slots are ported: K = 2 slots of K*B columns.
    superbatch = TrajectoryRing(**ring, superbatch_k=2)
    assert superbatch.total_cols == 4
    assert superbatch._slots[0].arrays.obs.shape == (2, 3, 2, 4)
    assert superbatch.validate_env_spec(np.zeros((4,), np.float32), 2) == []
    from torched_impala_tpu_torch.models.nets import ImpalaNet
    from torched_impala_tpu_torch.models.torsos import MLPTorso

    # The transformer core is ported; its sequence-parallel attention is not.
    for attention in ("ring", "ulysses"):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.md queue 1: DP and multi-process training"):
            ImpalaNet(2, MLPTorso(4, (8,)), core="transformer",
                      transformer=dict(d_model=8, num_heads=2, attention=attention))


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_no_jax():
    files = sorted((ROOT / "torched_impala_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = {
        str(f.relative_to(ROOT)): sorted(_imported_roots(f) & FORBIDDEN)
        for f in files
    }
    assert {k: v for k, v in bad.items() if v} == {}


def test_resolve_device_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_fake_env_trajectory_alignment():
    """The actor's first/cont/bootstrap alignment on scripted episodes."""
    from torched_impala_tpu_torch.envs.fake import ScriptedEnv
    from torched_impala_tpu_torch.models.agent import Agent
    from torched_impala_tpu_torch.models.nets import ImpalaNet
    from torched_impala_tpu_torch.models.torsos import MLPTorso
    from torched_impala_tpu_torch.runtime.param_store import ParamStore
    from torched_impala_tpu_torch.runtime.vector_actor import VectorActor

    net = ImpalaNet(2, MLPTorso(4, (8,)))
    store = ParamStore()
    store.publish(7, dict(net.named_parameters()))
    got = []
    actor = VectorActor(
        actor_id=0,
        envs=[ScriptedEnv(episode_len=3)],
        agent=Agent(net),
        param_store=store,
        enqueue=got.append,
        unroll_length=5,
        device=torch.device("cpu"),
    )
    actor.unroll_and_push()
    (traj,) = got
    # Steps within the episode: 0 1 2 | 0 1 | 2 (obs[T] is the bootstrap).
    np.testing.assert_array_equal(traj.obs[:, 0], [0, 1, 2, 0, 1, 2])
    np.testing.assert_array_equal(traj.first, [1, 0, 0, 1, 0, 0])
    np.testing.assert_array_equal(traj.cont, [1, 1, 0, 1, 1])
    assert traj.param_version == 7
    assert traj.behaviour_logits.shape == (5, 2)


class _BrokenEnv:
    """A ScriptedEnv that raises on its third step."""

    def __init__(self):
        from torched_impala_tpu_torch.envs.fake import ScriptedEnv

        self._env, self._steps = ScriptedEnv(episode_len=50), 0

    def reset(self, seed=None):
        return self._env.reset(seed)

    def step(self, action):
        self._steps += 1
        if self._steps == 3:
            raise RuntimeError("env fault")
        return self._env.step(action)


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize(
    "broken,max_actor_restarts",
    [((0,), 10), ((0, 1), 1), ((0, 1), 0)],
    ids=["one_keeps_crashing", "all_broken", "no_restart_budget"],
)
def test_actor_failure_is_raised_while_others_feed_the_learner(broken, max_actor_restarts):
    """The actor supervisor, as JAX's: actor 0's env raises on its third
    step after every restart while actor 1 feeds the learner, and the run
    reaches its steps with actor 0 restarted; when every actor is broken
    (or no restart is allowed) the run raises JAX's "all actor threads are
    dead and unrecoverable", chained to an actor's error."""
    from torched_impala_tpu_torch.envs.fake import ScriptedEnv
    from torched_impala_tpu_torch.models.agent import Agent
    from torched_impala_tpu_torch.models.nets import ImpalaNet
    from torched_impala_tpu_torch.models.torsos import MLPTorso
    from torched_impala_tpu_torch.optim import RMSProp
    from torched_impala_tpu_torch.runtime.learner import LearnerConfig

    def factory(seed, env_index):
        return _BrokenEnv() if env_index in broken else ScriptedEnv(episode_len=5)

    def logger(logs):
        # Slow steps until the supervisor's first restart shows, so the
        # run cannot end before its monitor has looked.
        if logs["actor_restarts"] == 0:
            time.sleep(0.2)

    kwargs = dict(
        agent=Agent(ImpalaNet(2, MLPTorso(4, (8,)))),
        env_factory=factory,
        num_actors=2,
        learner_config=LearnerConfig(batch_size=1, unroll_length=4),
        optimizer=RMSProp(1e-3),
        total_steps=40,
        device="cpu",
        logger=logger,
        log_every=1,
        max_actor_restarts=max_actor_restarts,
    )
    if len(broken) == 1:
        result = loop.train(**kwargs)
        assert result.learner.num_steps == 40
        assert result.actor_restarts >= 1
        assert result.final_logs["actor_restarts"] >= 1
        return
    with pytest.raises(RuntimeError, match="all actor threads are dead and unrecoverable") as info:
        loop.train(**kwargs)
    assert "env fault" in str(info.value.__cause__)
