"""The port's process env pool (torched_impala_tpu_torch/runtime/env_pool.py)
against the JAX package's, on the CPU.

- Both pools on the same fake factory (the CARTPOLE preset's fake env of
  each package: seeded random observations and rewards, 10-step
  episodes) and the same scripted actions give bit-identical obs,
  rewards, dones and episode events, lockstep, and per-worker streams in
  async mode.
- The pool's contracts: the lanes fold into `out_*` buffers in place, a
  crashed worker comes back as an episode boundary (reward 0, done True,
  fresh reset obs) in both modes, a spent restart budget raises, and a
  worker's reply to a step in flight never races a reset.
- A pooled `VectorActor` emits the same trajectories as a thread one over
  the same envs, for the MLP and the LSTM core.
- `loop.train` end to end in process mode: lockstep with the queue feed
  and with the trajectory ring, and async; every worker exits and the
  shared memory is unlinked after the run. The README's process-mode CLI
  example returns 0.
- In a fresh interpreter, a worker reports that neither JAX nor the JAX
  package is imported there and that torch runs one thread, and
  `stop_helpers` leaves the interpreter no child process.

Pools stay at 1-2 workers of 1-3 envs to keep the file fast.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from torched_impala_tpu import configs as jax_configs
from torched_impala_tpu.runtime.env_pool import ProcessEnvPool as JaxPool
from torched_impala_tpu_torch import configs, run
from torched_impala_tpu_torch.envs.fake import CrashingFactory
from torched_impala_tpu_torch.runtime import loop
from torched_impala_tpu_torch.runtime.env_pool import ProcessEnvPool
from torched_impala_tpu_torch.runtime.param_store import ParamStore
from torched_impala_tpu_torch.runtime.vector_actor import VectorActor

ROOT = Path(__file__).resolve().parents[1]
FACTORY = configs.make_env_factory(configs.CARTPOLE, fake=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def _port_forkserver():
    """Start this process's forkserver with the port's preload where no
    pool has started it yet, so each port worker forks with torch and the
    port's configs already imported (a process has one forkserver: where a
    JAX pool came first, port workers import them themselves)."""
    _pool(num_workers=1, envs_per_worker=1).close()


def _pool(cls=ProcessEnvPool, factory=FACTORY, num_workers=2, envs_per_worker=2, **kw):
    return cls(
        env_factory=factory,
        num_workers=num_workers,
        envs_per_worker=envs_per_worker,
        obs_shape=(4,),
        obs_dtype=np.float32,
        base_seed=5,
        **kw,
    )


def _actions(steps, n, seed=0):
    return np.random.default_rng(seed).integers(0, 2, size=(steps, n))


def test_lockstep_pool_matches_jax_pool():
    jax_pool = _pool(JaxPool, jax_configs.make_env_factory(jax_configs.CARTPOLE, fake=True))
    pool = _pool()
    try:
        np.testing.assert_array_equal(pool.reset_all(), jax_pool.reset_all())
        events = 0
        for acts in _actions(23, pool.num_envs):
            got, want = pool.step_all(acts), jax_pool.step_all(acts)
            for a, b in zip(got[:3], want[:3]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            assert got[3] == want[3]
            events += len(got[3])
        assert events == 2 * pool.num_envs  # two 10-step episodes each
    finally:
        pool.close()
        jax_pool.close()


def _async_streams(pool, steps):
    """Every worker's (rewards, dones, events, obs) per step, submitted one
    by one and answered in whatever order the workers finish."""
    W, E = pool.num_workers, pool.envs_per_worker
    acts = _actions(steps, pool.num_envs, seed=1)
    streams = {w: [] for w in range(W)}
    pool.reset_all()
    for t in range(steps):
        for w in range(W):
            assert pool.submit(w, acts[t, w * E : (w + 1) * E])
        answered = 0
        while answered < W:
            for w, rewards, dones, events, ok in pool.wait_any():
                assert ok
                streams[w].append((rewards, dones, events, pool.read_obs(w)))
                answered += 1
    return streams


def test_async_pool_matches_jax_pool_per_worker():
    jax_pool = _pool(
        JaxPool, jax_configs.make_env_factory(jax_configs.CARTPOLE, fake=True),
        mode="async", ready_fraction=0.5,
    )
    pool = _pool(mode="async", ready_fraction=0.5)
    try:
        got, want = _async_streams(pool, 12), _async_streams(jax_pool, 12)
        for w in want:
            for (r, d, e, o), (r2, d2, e2, o2) in zip(got[w], want[w], strict=True):
                np.testing.assert_array_equal(r, r2)
                np.testing.assert_array_equal(d, d2)
                np.testing.assert_array_equal(o, o2)
                assert e == e2
    finally:
        pool.close()
        jax_pool.close()


def test_step_all_fills_out_buffers_in_place():
    pool = _pool(num_workers=1, envs_per_worker=3)
    try:
        pool.reset_all()
        rewards = np.full((3,), 7.0, np.float32)
        dones = np.ones((3,), np.bool_)
        _, r, d, _ = pool.step_all(np.zeros(3), out_rewards=rewards, out_dones=dones)
        assert r is rewards and d is dones
        assert not dones.any() and not (rewards == 7.0).any()
    finally:
        pool.close()


def _first_obs(w, E=2):
    """Worker w's envs' first observations, as a fresh worker of `_pool`
    builds and resets them (seeds 5 + 1000 (w + 1) + i)."""
    return np.stack([FACTORY(5 + 1000 * (w + 1) + i, w * E + i).reset()[0] for i in range(E)])


def test_crashed_worker_is_a_clean_episode_boundary():
    """Lockstep: the third step crashes the worker; its rows come back as
    reward 0, done True and a fresh worker's reset obs, and one restart
    counts."""
    pool = _pool(factory=CrashingFactory(FACTORY, crash_after=3), num_workers=1,
                 max_restarts=5)
    try:
        pool.reset_all()
        for _ in range(2):
            obs, rewards, dones, _ = pool.step_all(np.zeros(2))
            assert not dones.any()
        obs, rewards, dones, events = pool.step_all(np.zeros(2))
        assert pool.restarts == 1 and events == []
        np.testing.assert_array_equal(rewards, 0.0)
        assert dones.all()
        np.testing.assert_array_equal(obs, _first_obs(0))
    finally:
        pool.close()


def test_async_crash_boundary_and_restart_budget():
    pool = _pool(factory=CrashingFactory(FACTORY, crash_after=2), num_workers=2,
                 mode="async", max_restarts=1)
    try:
        pool.reset_all()
        for w in range(2):
            assert pool.submit(w, np.zeros(2))
        results = []
        while len(results) < 2:
            results += pool.wait_any()
        assert all(ok for *_, ok in results)
        assert pool.submit(0, np.zeros(2))
        ((w, rewards, dones, events, ok),) = pool.wait_any(workers=[0])
        assert (w, ok, events, pool.restarts) == (0, False, [], 1)
        np.testing.assert_array_equal(rewards, 0.0)
        assert dones.all()
        np.testing.assert_array_equal(pool.read_obs(0), _first_obs(0))
        # The budget of one restart is spent: the next crash raises.
        assert pool.submit(1, np.zeros(2))
        with pytest.raises(RuntimeError, match="budget"):
            pool.wait_any(workers=[1])
    finally:
        pool.close()


def test_reset_all_drains_steps_in_flight():
    """A reset while steps are in flight reads their replies first, so
    none is taken for the reset's, and every worker can take a step."""
    pool = _pool(mode="async")
    try:
        pool.reset_all()
        for w in range(2):
            assert pool.submit(w, np.ones(2))
        assert pool.reset_all().shape == (4, 4)
        assert pool.wait_any(timeout=0) == []
        for w in range(2):
            assert pool.submit(w, np.ones(2))
        answered = []
        while len(answered) < 2:
            answered += pool.wait_any()
        assert sorted(w for w, *_ in answered) == [0, 1] and all(ok for *_, ok in answered)
        with pytest.raises(ValueError, match="picklable"):
            _pool(factory=lambda seed, index=None: None)
    finally:
        pool.close()


def _trajectories(envs, cfg, unrolls, seed):
    agent = configs.make_agent(cfg, seed=3)
    store = ParamStore()
    store.publish(0, dict(agent.net.named_parameters()))
    out = []
    actor = VectorActor(
        actor_id=0, envs=envs, agent=agent, param_store=store, enqueue=out.append,
        unroll_length=4, device=torch.device("cpu"), seed=seed,
    )
    for _ in range(unrolls):
        actor.unroll_and_push()
    return out


@pytest.mark.parametrize("use_lstm", [False, True], ids=["mlp", "lstm"])
def test_pooled_matches_thread_trajectories(use_lstm):
    """The same envs (the pool's seeds) and the same policy seed give the
    same trajectories from a pooled and a thread actor; with the LSTM
    core the carry crosses unrolls and a 10-step episode boundary."""
    cfg = dataclasses.replace(configs.CARTPOLE, use_lstm=use_lstm, lstm_size=8)
    pool = _pool()
    try:
        pooled = _trajectories(pool, cfg, unrolls=3, seed=11)
    finally:
        pool.close()
    envs = [FACTORY(5 + 1000 * (w + 1) + i, 2 * w + i) for w in range(2) for i in range(2)]
    for env in envs:
        env.reset()  # as each worker resets its envs once at start-up
    local = _trajectories(envs, cfg, unrolls=3, seed=11)
    assert len(pooled) == len(local) == 12
    assert any(not t.cont.all() for t in local)
    for p, q in zip(pooled, local):
        for a, b in zip(p[:6], q[:6]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(p.agent_state, q.agent_state):
            np.testing.assert_array_equal(a, b)


def _train(**kw):
    cfg = dataclasses.replace(configs.CARTPOLE, unroll_length=4, batch_size=4, traj_ring=kw.pop("ring"))
    return loop.train(
        agent=configs.make_agent(cfg, seed=0),
        env_factory=FACTORY,
        num_actors=2,
        envs_per_actor=2,
        actor_mode="process",
        learner_config=configs.make_learner_config(cfg),
        optimizer=configs.make_optimizer(cfg),
        total_steps=3,
        device="cpu",
        log_every=1,
        **kw,
    )


@pytest.mark.parametrize(
    "kw", [dict(ring=False), dict(ring=True), dict(ring=False, pool_mode="async")],
    ids=["queue", "ring", "async"],
)
def test_train_process_mode_end_to_end(kw):
    result = _train(**kw)
    assert result.learner.num_steps == 3 and result.num_frames == 3 * 4 * 4
    assert np.isfinite(result.final_logs["total_loss"])
    assert (result.learner.traj_ring is not None) == kw["ring"]
    # Two pools of one worker; all exited, their shared memory unlinked.
    assert len(result.pool_pids) == 2 and len(result.pool_shm_names) == 2
    assert not any(os.path.exists(f"/proc/{pid}") for pid in result.pool_pids)
    assert not any(os.path.exists(f"/dev/shm/{name}") for name in result.pool_shm_names)


def test_ring_env_count_must_divide_batch_size():
    with pytest.raises(ValueError, match="divide"):
        loop.train(
            agent=configs.make_agent(configs.CARTPOLE),
            env_factory=FACTORY,
            num_actors=1,
            envs_per_actor=3,
            learner_config=dataclasses.replace(
                configs.make_learner_config(configs.CARTPOLE), batch_size=4, traj_ring=True
            ),
            optimizer=configs.make_optimizer(configs.CARTPOLE),
            total_steps=1,
            device="cpu",
        )


def test_process_cli_returns_zero(capsys):
    """The process-mode CPU command of README.md, run as documented: the
    Pong preset's own actor mode, with the ring."""
    readme = " ".join((ROOT / "README.md").read_text().replace("\\\n", " ").split())
    assert f"python -m torched_impala_tpu_torch.run {run.PROCESS_CPU_EXAMPLE}" in readme
    assert configs.PONG.actor_mode == "process"
    assert run.main(run.PROCESS_CPU_EXAMPLE.split()) == 0
    assert "done: steps=3" in capsys.readouterr().out


PROBE = '''
import sys

import numpy as np


class ProbeEnv:
    """Its observation says what its worker process has imported."""

    def reset(self, seed=None):
        torch = sys.modules.get("torch")
        return np.array([
            "jax" in sys.modules,
            "torched_impala_tpu" in sys.modules,
            torch.get_num_threads() if torch is not None else -1,
        ], np.float32), {}


def probe_factory(seed, env_index=None):
    return ProbeEnv()
'''

SCRIPT = '''
import json
import os

import numpy as np

from probe_env import probe_factory
from torched_impala_tpu_torch.runtime.env_pool import ProcessEnvPool, stop_helpers


def children():
    found = []
    for entry in os.listdir("/proc"):
        try:
            with open(f"/proc/{entry}/stat") as f:
                if int(f.read().rsplit(")", 1)[1].split()[1]) == os.getpid():
                    found.append(int(entry))
        except (OSError, ValueError, IndexError):
            continue
    return found


if __name__ == "__main__":
    pool = ProcessEnvPool(env_factory=probe_factory, num_workers=2, envs_per_worker=1,
                          obs_shape=(3,), obs_dtype=np.float32)
    try:
        obs = pool.reset_all().tolist()
    finally:
        pool.close()
    before = len(children())
    stop_helpers()
    print(json.dumps({"obs": obs, "children_before": before, "children_after": children()}))
'''


@pytest.fixture(scope="module")
def fresh_run(tmp_path_factory):
    """One pool of two probe workers in a fresh interpreter (one forkserver
    a process: a pool built after a JAX pool in this process would share
    that pool's preload), closed, then `stop_helpers`."""
    tmp_path = tmp_path_factory.mktemp("fresh")
    (tmp_path / "probe_env.py").write_text(textwrap.dedent(PROBE))
    (tmp_path / "main.py").write_text(textwrap.dedent(SCRIPT))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(ROOT)]))
    out = subprocess.run(
        [sys.executable, str(tmp_path / "main.py")], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_workers_import_no_jax(fresh_run):
    """Each worker sees neither JAX nor the JAX package, and one torch
    thread."""
    assert fresh_run["obs"] == [[0.0, 0.0, 1.0]] * 2


def test_stop_helpers_leaves_no_process(fresh_run):
    """The forkserver and the resource tracker outlive the closed pool, and
    `stop_helpers` ends both before it returns."""
    assert fresh_run["children_before"] >= 1
    assert fresh_run["children_after"] == []
