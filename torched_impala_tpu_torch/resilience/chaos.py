"""Chaos harness: declarative fault plans injected into the live pipeline
(counterpart of `torched_impala_tpu/resilience/chaos.py`).

A `ChaosPlan` is a list of `Fault`s, each naming a KIND, the site event
it fires at (`at` = the Nth event observed at that site) and an optional
target, parsed from JSON (`--chaos-plan plan.json`, the JAX package's
schema) or built in code.

  kind                site      effect
  ------------------  --------  ------------------------------------------
  kill_env_worker     pool      SIGKILL worker `target`'s process; the
                                pool's repair respawns it and reports an
                                episode boundary
  delay_lane          pool      sleep `duration_s` in the parent's lane
                                path: a wedged or slow worker
  raise_in_actor      actor     raise ChaosError at the start of actor
                                `target`'s unroll; the supervisor must
                                restart it
  wedge_queue         enqueue   block one trajectory enqueue for
                                `duration_s`: a starved learner
  crash_learner       learner   raise ChaosError from the post-step hook:
                                the run dies WITHOUT a final checkpoint,
                                as a killed learner would
  corrupt_checkpoint  save      overwrite bytes inside the just-written
                                checkpoint; the recovery scan must reject
                                it and fall back one step

The JAX package has four more kinds, whose sites the port does not have
yet; a fault of one raises NotImplementedError naming its ROADMAP.md
item: `kill_host` (DP and multi-process training: its survivor-driven
restart belongs to the multi-host launcher), `kill_server_mid_wave`,
`corrupt_pinned_version` and `wedge_shm_ring` (Serving).

Sites count from 1; a fault fires once, when its site's counter reaches
`at` (and its target matches, where both sides name one). Sites are hit
from actor threads, the learner thread and the checkpoint writer
concurrently, so the counters take a lock. Fired faults are counted on
plain attributes (`fired`) until the port's telemetry registry lands
(ROADMAP.md queue 1: Observability, perf and control).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import sys
import threading
import time
from typing import Callable, List, Sequence

KINDS = (
    "kill_env_worker",
    "delay_lane",
    "raise_in_actor",
    "wedge_queue",
    "crash_learner",
    "corrupt_checkpoint",
    "kill_server_mid_wave",
    "corrupt_pinned_version",
    "wedge_shm_ring",
    "kill_host",
)

_SITE_OF = {
    "kill_env_worker": "pool",
    "delay_lane": "pool",
    "raise_in_actor": "actor",
    "wedge_queue": "enqueue",
    "crash_learner": "learner",
    "corrupt_checkpoint": "save",
}

# The JAX kinds whose sites the port lacks, with the ROADMAP.md queue 1
# item that brings each site.
NOT_PORTED = {
    "kill_host": "DP and multi-process training",
    "kill_server_mid_wave": "Serving",
    "corrupt_pinned_version": "Serving",
    "wedge_shm_ring": "Serving",
}


class ChaosError(RuntimeError):
    """An injected fault (not a real bug), recognizable in logs and tests."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault: fire at the `at`-th event on `kind`'s site."""

    kind: str
    at: int
    target: int = -1  # worker index / actor slot; -1 = any
    duration_s: float = 0.0  # delay_lane / wedge_queue only

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected one of {KINDS}")
        if self.kind in NOT_PORTED:
            raise NotImplementedError(
                f"fault kind {self.kind!r} is not ported yet: its site comes "
                f"with ROADMAP.md queue 1: {NOT_PORTED[self.kind]}"
            )
        if self.at < 1:
            raise ValueError(
                f"fault {self.kind}: `at` counts site events from 1, got {self.at}"
            )
        if self.duration_s < 0:
            raise ValueError(f"fault {self.kind}: negative duration_s")

    @property
    def site(self) -> str:
        return _SITE_OF[self.kind]


@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    """An ordered fault list."""

    faults: tuple

    def __init__(self, faults: Sequence[Fault]) -> None:
        object.__setattr__(self, "faults", tuple(faults))

    @classmethod
    def from_dicts(cls, objs: Sequence[dict]) -> "ChaosPlan":
        faults = []
        for i, obj in enumerate(objs):
            unknown = set(obj) - {f.name for f in dataclasses.fields(Fault)}
            if unknown:
                raise ValueError(
                    f"fault #{i}: unknown field(s) {sorted(unknown)}; "
                    "schema is kind/at/target/duration_s"
                )
            faults.append(Fault(**obj))
        return cls(faults)

    @classmethod
    def from_json(cls, path: str) -> "ChaosPlan":
        with open(path, encoding="utf-8") as f:
            objs = json.load(f)
        if not isinstance(objs, list):
            raise ValueError(f"chaos plan {path} must be a JSON list of fault objects")
        return cls.from_dicts(objs)


class ChaosInjector:
    """Executes a `ChaosPlan` through the pipeline's hooks (`loop.train`
    wires them). Each fired fault is appended to `fired` and leaves a
    line on stderr, so a chaos run's log explains itself."""

    def __init__(self, plan: ChaosPlan) -> None:
        self.plan = plan
        self._lock = threading.Lock()
        self._counts = {site: 0 for site in set(_SITE_OF.values())}
        self._armed: List[Fault] = list(plan.faults)
        self.fired: List[Fault] = []

    def _trigger(self, site: str, target: int = -1) -> List[Fault]:
        """Advance `site`'s counter; pop every armed fault due now."""
        with self._lock:
            self._counts[site] += 1
            n = self._counts[site]
            due, rest = [], []
            for f in self._armed:
                if (
                    f.site == site
                    and n >= f.at
                    and (f.target < 0 or target < 0 or f.target == target)
                ):
                    due.append(f)
                else:
                    rest.append(f)
            self._armed = rest
            self.fired.extend(due)
        for f in due:
            print(
                f"[chaos] firing {f.kind} (site={site} event #{n} target={target})",
                file=sys.stderr,
                flush=True,
            )
        return due

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._armed)

    # ---- site hooks -----------------------------------------------------

    def pool_hook(self, pool) -> None:
        """`pool.chaos_hook`, called once per dispatch wave.
        kill_env_worker SIGKILLs a live worker process; delay_lane stalls
        the parent's lane path."""
        for f in self._trigger("pool"):
            if f.kind == "kill_env_worker":
                w = min(f.target if f.target >= 0 else 0, pool.num_workers - 1)
                proc = pool._procs[w]
                if proc is not None and proc.pid and proc.is_alive():
                    os.kill(proc.pid, signal.SIGKILL)
            elif f.kind == "delay_lane":
                time.sleep(f.duration_s)

    def actor_hook(self, actor_id: int) -> None:
        """The actor's chaos hook, called at each unroll start;
        raise_in_actor raises ChaosError there."""
        for f in self._trigger("actor", target=actor_id):
            if f.kind == "raise_in_actor":
                raise ChaosError(f"injected actor crash (actor {actor_id})")

    def wrap_enqueue(self, enqueue: Callable) -> Callable:
        """The learner's enqueue with the wedge_queue seam: one enqueue
        blocks for duration_s."""

        def chaotic_enqueue(traj):
            for f in self._trigger("enqueue"):
                if f.kind == "wedge_queue":
                    time.sleep(f.duration_s)
            return enqueue(traj)

        return chaotic_enqueue

    def learner_hook(self, num_steps: int) -> None:
        """A post-step hook; crash_learner aborts the run with ChaosError
        (teardown runs, the final checkpoint does not)."""
        for f in self._trigger("learner"):
            if f.kind == "crash_learner":
                raise ChaosError(f"injected learner crash at step {num_steps}")

    def checkpoint_hook(self, path: str, step: int) -> None:
        """AsyncCheckpointer's post_save; corrupt_checkpoint scribbles over
        bytes mid-file, which the zip CRCs must catch."""
        for f in self._trigger("save"):
            if f.kind == "corrupt_checkpoint":
                corrupt_file(path)

    def install(self, *, pools: Sequence = (), checkpointer=None) -> None:
        """Wire the hooks that ride attributes (the actor, enqueue and
        post-step hooks are wired where those are built: loop.train)."""
        for pool in pools:
            pool.chaos_hook = self.pool_hook
        if checkpointer is not None:
            checkpointer._post_save = self.checkpoint_hook


def corrupt_file(path: str, offset_frac: float = 0.5, nbytes: int = 64) -> None:
    """Overwrite `nbytes` bytes in the middle of `path` in place (no
    rename: bit rot or a torn write, not an atomic writer)."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(max(0, int(size * offset_frac) - nbytes // 2))
        f.write(b"\xde\xad\xbe\xef" * (nbytes // 4 + 1))
