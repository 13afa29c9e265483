"""Actor supervisor: keeps the rollout fleet alive (counterpart of
`torched_impala_tpu/runtime/supervisor.py`).

A monitor thread watches every actor thread and, when one dies with an
error, builds a fresh actor for its slot (`make_actor(slot)`) and starts
it. Actors are stateless up to the published params, so a restart is
cheap: the new actor pulls the current params from the `ParamStore`. In
process mode an actor drives an env pool, and its replacement attaches
to the same live pool (the pool repairs its own dead workers).

Restarts back off per slot, exponentially with a seeded jitter factor in
[1, 1 + jitter] so many slots crashing on one cause do not restart in
lockstep, and stop at `max_restarts_per_actor`; a slot past its budget
stays dead. `alive_count()` and `can_recover()` feed the learner's
watchdog; `restarts` counts on a plain attribute until the port's
telemetry registry lands (ROADMAP.md queue 1: Observability, perf and
control).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, List, Optional


class ActorSupervisor:
    """Own and babysit `num_actors` actor threads. `make_actor(slot)`
    returns a fresh actor (with `run(stop_event)` and `error`); it is
    called once at `start()` and again at every restart."""

    def __init__(
        self,
        *,
        make_actor: Callable[[int], Any],
        num_actors: int,
        stop_event: threading.Event,
        check_interval: float = 0.5,
        max_restarts_per_actor: Optional[int] = 10,
        backoff_base: float = 0.5,
        backoff_max: float = 30.0,
        backoff_jitter: float = 0.25,
        jitter_seed: Optional[int] = None,
        on_restart: Optional[Callable[[int, BaseException], None]] = None,
    ) -> None:
        """`jitter_seed` pins the jitter stream (tests)."""
        if backoff_jitter < 0:
            raise ValueError(f"backoff_jitter must be >= 0, got {backoff_jitter}")
        self._make_actor = make_actor
        self._num = num_actors
        self._stop = stop_event
        self._interval = check_interval
        self._max_restarts = max_restarts_per_actor
        self._backoff_base = backoff_base
        self._backoff_max = backoff_max
        self._backoff_jitter = backoff_jitter
        self._jitter_rng = random.Random(jitter_seed)
        self._on_restart = on_restart

        self.actors: List[Any] = []
        self._threads: List[threading.Thread] = []
        self._restart_counts = [0] * num_actors
        self._next_restart_at = [0.0] * num_actors
        self._restarting = [False] * num_actors
        self._spawn_errors: List[Optional[BaseException]] = [None] * num_actors
        self._monitor: Optional[threading.Thread] = None
        self.restarts = 0
        # Guards the slots' state: the watchdog reads alive_count() and
        # can_recover() from the learner thread, and a slot mid-restart
        # must never look dead and unrecoverable.
        self._lock = threading.Lock()

    def _spawn_locked(self, slot: int, actor: Any) -> None:
        thread = threading.Thread(
            target=actor.run, args=(self._stop,), name=f"actor-{slot}", daemon=True
        )
        if slot < len(self.actors):
            self.actors[slot] = actor
            self._threads[slot] = thread
        else:
            self.actors.append(actor)
            self._threads.append(thread)
        thread.start()

    def start(self) -> None:
        with self._lock:
            for slot in range(self._num):
                self._spawn_locked(slot, self._make_actor(slot))
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="actor-supervisor", daemon=True
        )
        self._monitor.start()

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self._interval):
            for slot in range(self._num):
                self._maybe_restart(slot)

    def _maybe_restart(self, slot: int) -> None:
        now = time.monotonic()
        with self._lock:
            thread = self._threads[slot]
            actor = self.actors[slot]
            if thread.is_alive() or actor.error is None:
                return  # running, or a clean exit
            if self._max_restarts is not None and self._restart_counts[slot] >= self._max_restarts:
                return  # budget spent; the slot stays dead
            if now < self._next_restart_at[slot]:
                return  # backing off
            error = actor.error
            self._restarting[slot] = True
            self._restart_counts[slot] += 1
            self.restarts += 1
            backoff = min(
                self._backoff_max,
                self._backoff_base
                * (2 ** (self._restart_counts[slot] - 1))
                * (1.0 + self._backoff_jitter * self._jitter_rng.random()),
            )
            self._next_restart_at[slot] = now + backoff
        # The callback and the actor's construction (env builds, a pool's
        # reset) run outside the lock; `restarting` keeps can_recover()
        # truthful meanwhile.
        try:
            if self._on_restart is not None:
                self._on_restart(slot, error)
            new_actor = self._make_actor(slot)
        except BaseException as e:  # noqa: BLE001 - must not kill the monitor
            # A failed respawn consumes the restart and leaves the errored
            # actor in place: retried after its backoff, or unrecoverable
            # once the budget is spent.
            with self._lock:
                self._spawn_errors[slot] = e
                self._restarting[slot] = False
            return
        with self._lock:
            self._spawn_locked(slot, new_actor)
            self._restarting[slot] = False

    def alive_count(self) -> int:
        with self._lock:
            return sum(t.is_alive() for t in self._threads) + sum(self._restarting)

    def can_recover(self) -> bool:
        """True if a slot is alive, mid-restart, or dead with an error and
        within its restart budget (the monitor will revive it)."""
        with self._lock:
            for slot in range(self._num):
                if self._restarting[slot] or self._threads[slot].is_alive():
                    return True
                if self.actors[slot].error is not None and (
                    self._max_restarts is None
                    or self._restart_counts[slot] < self._max_restarts
                ):
                    return True
        return False

    def errors(self) -> List[BaseException]:
        with self._lock:
            errs = [a.error for a in self.actors if a.error is not None]
            errs.extend(e for e in self._spawn_errors if e is not None)
        return errs

    def join(self, timeout_per_thread: float = 5.0) -> None:
        if self._monitor is not None:
            self._monitor.join(timeout=self._interval + 1.0)
        for t in self._threads:
            t.join(timeout=timeout_per_thread)
