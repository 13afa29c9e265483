"""The port's actor supervisor (torched_impala_tpu_torch/runtime/supervisor.py)
held against the JAX package's (torched_impala_tpu/runtime/supervisor.py).

The same scenarios run through both supervisors with the same plain
actors (a `run(stop_event)` and an `error`, which either supervisor
drives) and their outcomes are compared: the backoff delays for one
`jitter_seed`, to the float; restarts of a crashing actor; a restart
budget spent (unrecoverable); a failed respawn that consumes a restart
and leaves the monitor alive; a clean exit, never restarted; a negative
jitter refused. Then the port's loop end to end: envs that crash keep a
run going through restarts, and a fleet that cannot recover fails.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torched_impala_tpu.runtime import supervisor as jax_supervisor
from torched_impala_tpu.telemetry import Registry
from torched_impala_tpu_torch.runtime import loop
from torched_impala_tpu_torch.runtime import supervisor


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _Actor:
    """Runs `steps` beats of `beat` seconds, then raises `error` or exits
    cleanly; stops early on the stop event."""

    def __init__(self, steps=0, error=None, beat=0.0):
        self.steps, self.raise_error, self.beat = steps, error, beat
        self.error = None
        self.beats = 0

    def run(self, stop_event):
        for _ in range(self.steps):
            if stop_event.wait(self.beat):
                return
            self.beats += 1
        if self.raise_error is not None:
            self.error = self.raise_error
            raise self.error


def _supervisor(module, make_actor, **kwargs):
    """`module`'s supervisor over `make_actor`, with its stop event."""
    extra = {"telemetry": Registry()} if module is jax_supervisor else {}
    stop = threading.Event()
    return module.ActorSupervisor(make_actor=make_actor, stop_event=stop, **kwargs, **extra), stop


def _supervisors(make_actor, **kwargs):
    """(jax, port) supervisors over the same actor factory."""
    return [_supervisor(m, make_actor, **kwargs) for m in (jax_supervisor, supervisor)]


def _wait_for(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


@pytest.mark.parametrize("jitter,seed", [(0.25, 7), (1.0, 3), (0.0, 0)])
@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_backoff_delays_match_jax_to_the_float(monkeypatch, jitter, seed):
    """Both supervisors restart one instantly crashing slot 6 times by
    hand at a frozen clock: the same delays, bit for bit (base 0.05 x 2^k
    x (1 + jitter x U), capped at 1.0)."""
    clock = SimpleNamespace(monotonic=lambda: 1000.0)
    monkeypatch.setattr(jax_supervisor, "time", clock)
    monkeypatch.setattr(supervisor, "time", clock)
    delays = []
    for sup, stop in _supervisors(lambda slot: _Actor(error=RuntimeError("boom")),
                                  num_actors=1, backoff_base=0.05, backoff_max=1.0,
                                  backoff_jitter=jitter, jitter_seed=seed,
                                  max_restarts_per_actor=None):
        with sup._lock:
            sup._spawn_locked(0, sup._make_actor(0))
        got = []
        for _ in range(6):
            sup._threads[0].join(timeout=5)
            sup._next_restart_at[0] = 0.0
            sup._maybe_restart(0)
            got.append(sup._next_restart_at[0] - 1000.0)
        stop.set()
        sup._threads[0].join(timeout=5)
        delays.append(got)
    assert delays[0] == delays[1]
    assert delays[1][-1] == 1.0  # capped
    if jitter == 0.0:
        np.testing.assert_allclose(delays[1][:5], [0.05, 0.1, 0.2, 0.4, 0.8])


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_restarts_a_crashing_actor_like_jax():
    def outcome(sup, stop, spawned):
        sup.start()
        try:
            assert _wait_for(lambda: sup.restarts >= 3)
        finally:
            stop.set()
            sup.join()
        return sup.restarts >= 3, len(spawned) == 1 + sup.restarts, sup.can_recover()

    results = []
    for module in (jax_supervisor, supervisor):
        spawned = []

        def make_actor(slot, spawned=spawned):
            spawned.append(slot)
            return _Actor(steps=2, error=RuntimeError("crash"), beat=0.01)

        sup, stop = _supervisor(module, make_actor, num_actors=1, check_interval=0.01,
                                backoff_base=0.01, backoff_jitter=0.0)
        results.append(outcome(sup, stop, spawned))
    # Stopped, the last actor exits cleanly: nothing left to recover.
    assert results[0] == results[1] == (True, True, False)


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_budget_exhaustion_is_unrecoverable_like_jax():
    results = []
    for sup, stop in _supervisors(lambda slot: _Actor(error=RuntimeError("chaos env")),
                                  num_actors=1, check_interval=0.01, backoff_base=0.01,
                                  max_restarts_per_actor=2):
        sup.start()
        assert _wait_for(lambda: sup.alive_count() == 0 and not sup.can_recover())
        stop.set()
        sup.join()
        results.append((sup.restarts, sup.can_recover(), repr(sup.errors()[0])))
    assert results[0] == results[1] == (2, False, "RuntimeError('chaos env')")


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_spawn_failure_consumes_a_restart_and_the_monitor_lives_like_jax():
    results = []
    for module in (jax_supervisor, supervisor):
        calls = [0]

        def make_actor(slot, calls=calls):
            calls[0] += 1
            if calls[0] == 2:
                raise RuntimeError("env re-init failed")
            if calls[0] == 1:
                return _Actor(error=RuntimeError("crash"))
            return _Actor(steps=1000, beat=0.01)

        sup, stop = _supervisor(module, make_actor, num_actors=1, check_interval=0.01,
                                backoff_base=0.01, backoff_jitter=0.0)
        sup.start()
        try:
            assert _wait_for(lambda: calls[0] >= 3 and sup.actors[0].beats > 0)
        finally:
            stop.set()
            sup.join()
        results.append((sup.restarts, calls[0], any("re-init" in repr(e) for e in sup.errors())))
    assert results[0] == results[1] == (2, 3, True)


def test_clean_exit_is_not_restarted_like_jax():
    results = []
    for sup, stop in _supervisors(lambda slot: _Actor(steps=1), num_actors=2,
                                  check_interval=0.01):
        sup.start()
        assert _wait_for(lambda: sup.alive_count() == 0)
        time.sleep(0.1)  # the monitor has looked, and must not restart
        stop.set()
        sup.join()
        results.append((sup.restarts, sup.can_recover(), sup.errors()))
    assert results[0] == results[1] == (0, False, [])


def test_negative_jitter_refused_like_jax():
    for module in (jax_supervisor, supervisor):
        with pytest.raises(ValueError, match="backoff_jitter"):
            module.ActorSupervisor(make_actor=lambda slot: _Actor(), num_actors=1,
                                   stop_event=threading.Event(), backoff_jitter=-0.1)


def _crashing_run(crash_after, **kwargs):
    from torched_impala_tpu_torch.envs.fake import CrashingEnv, FakeDiscreteEnv
    from torched_impala_tpu_torch.models.agent import Agent
    from torched_impala_tpu_torch.models.nets import ImpalaNet
    from torched_impala_tpu_torch.models.torsos import MLPTorso
    from torched_impala_tpu_torch.optim import RMSProp
    from torched_impala_tpu_torch.runtime.learner import LearnerConfig

    def env_factory(seed, env_index=None):
        return CrashingEnv(FakeDiscreteEnv(obs_shape=(6,), num_actions=3, seed=seed),
                           crash_after=crash_after)

    return loop.train(
        agent=Agent(ImpalaNet(3, MLPTorso(6, (16,)))), env_factory=env_factory, num_actors=2,
        learner_config=LearnerConfig(batch_size=2, unroll_length=5), optimizer=RMSProp(1e-3),
        device="cpu", **kwargs,
    )


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_training_survives_crashing_envs():
    """As JAX's: envs crash every 25 steps; the run reaches its steps
    through supervisor restarts (the logger slows the steps until one
    shows, so the run cannot end before the monitor looks)."""

    def logger(logs):
        if logs["actor_restarts"] == 0:
            time.sleep(0.1)

    result = _crashing_run(25, total_steps=20, logger=logger, log_every=1)
    assert result.learner.num_steps == 20
    assert result.actor_restarts >= 1
    assert np.isfinite(result.final_logs["total_loss"])


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_unrecoverable_fleet_fails_loudly():
    with pytest.raises(RuntimeError, match="unrecoverable") as info:
        _crashing_run(1, total_steps=4, max_actor_restarts=1)
    assert "chaos: env crashed" in str(info.value.__cause__)
