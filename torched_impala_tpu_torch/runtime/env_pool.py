"""ProcessEnvPool: env stepping in worker processes, per-step data in shared
memory (counterpart of `torched_impala_tpu/runtime/env_pool.py`).

At 32-512 actors, stepping emulators in threads of one process binds on
the interpreter lock. The pool moves the envs into worker processes that
own the emulators and nothing else, and feeds central batched inference
(a `VectorActor` thread on the card). Workers import numpy and the env
factory, never touch CUDA, and step E envs each behind a small pipe
protocol. Every per-step payload lives in one SharedMemory segment that
the parent reads and writes in place:

  [ obs block   [N, *obs_shape] ]  worker-written next observations
  [ action lane [N] int32       ]  parent-written actions
  [ reward lane [N] float32     ]  worker-written step rewards
  [ done lane   [N] bool        ]  worker-written done (= next `first`) flags

so in the steady state the pipe carries only payload-free tokens, error
reports and the episodes completed that step.

Protocol (per worker):
  parent -> worker : ("step",) with the actions already in the action
                     lane | ("reset",) | ("close",)
  worker -> parent : ("stepped", events) with next obs, rewards and dones
                     already in their lanes; `events` lists the
                     (env_local_idx, episode_return, episode_len) of the
                     episodes that ended this step. Workers reset finished
                     envs at once, so the done lane doubles as the next
                     step's `first` flags.
  worker -> parent : ("error", repr) then exit: the pool starts a fresh
                     worker (envs are stateless up to the published
                     params) and counts a restart against its budget.

Scheduling modes (`mode=`):
  "lockstep": `step_all(actions)` waits for every worker each step.
  "async": the ready-set protocol. The parent drives workers one by one
      through `submit(w, actions)` / `wait_any()`, and the driving
      `VectorActor` runs inference over whichever `ready_fraction` of the
      workers has reported; stragglers catch up on a later wave. A worker
      that dies or times out mid-wave is restarted with reset envs, and
      its rows come back as an episode boundary (reward 0, done True,
      fresh reset obs) through `ok=False` results.

The env factory must be picklable: a module-level function, a
`functools.partial` of one, or `configs.make_env_factory`'s factory
object; a lambda or closure raises at construction.

Start method: forkserver (spawn where the platform has none). The server
is a fresh interpreter, so it is safe to start after the parent has set
up CUDA; it imports the port's configs and envs once (`_preload`) and
each worker is a fork of it that shares those pages. A process has one
forkserver, whose preload list is set by whichever pool started it first.
It and the resource tracker outlive the pools; `stop_helpers` ends both.
Each worker sets torch's and OpenMP's threads to 1, so 32 workers do not
each start a full thread pool.

Not ported here: the telemetry lanes and flight recorder of the JAX pool
and `ready_fraction="auto"`, which belong to ROADMAP.md's "Observability,
perf and control" item.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import sys
import time
from multiprocessing import connection as mp_connection
from multiprocessing import shared_memory
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

try:
    _CTX = mp.get_context("forkserver")

    def _preload() -> None:
        # The modules workers import when they unpickle a factory:
        # imported once in the server, shared copy-on-write by every fork.
        _CTX.set_forkserver_preload(
            ["torched_impala_tpu_torch.configs", "torched_impala_tpu_torch.envs"]
        )

except ValueError:  # a platform without forkserver
    _CTX = mp.get_context("spawn")

    def _preload() -> None:
        pass


def stop_helpers() -> None:
    """Stop the helper processes that outlive every pool, the forkserver
    and the resource tracker, and wait until both have exited. Without
    this they end a moment after this process does; a later pool starts
    them again. Call it only once every pool is closed."""
    from multiprocessing import forkserver, resource_tracker

    if _CTX.get_start_method() == "forkserver":
        forkserver._forkserver._stop()
    # After the forkserver: it holds the tracker's pipe open too.
    resource_tracker._resource_tracker._stop()


def align(offset: int, to: int = 8) -> int:
    """`offset` rounded up to a multiple of `to` (the lanes' layout)."""
    return (offset + to - 1) // to * to


def _one_thread() -> None:
    """Keep a worker to one compute thread: the forkserver's preload
    imported torch, whose thread pool would otherwise take every core in
    each of 32 workers."""
    os.environ["OMP_NUM_THREADS"] = "1"
    torch = sys.modules.get("torch")
    if torch is not None:
        torch.set_num_threads(1)


def _worker_main(
    conn,
    shm_name: str,
    shm_offset: int,
    lane_offsets: tuple,
    factory_bytes: bytes,
    num_envs: int,
    base_seed: int,
    first_env_index: int,
    obs_shape: tuple,
    obs_dtype_str: str,
) -> None:
    """Worker process body: build the envs, then step on command.

    `lane_offsets` are the (action, reward, done) byte offsets of this
    worker's slice of the lanes. Actions are read from the action lane
    after the ("step",) token arrives, and rewards, dones and next obs are
    written to their lanes before the ("stepped", events) reply: the pipe's
    send and receive order the lane writes. Numpy only: nothing here
    touches CUDA."""
    _one_thread()
    shm = shared_memory.SharedMemory(name=shm_name)
    try:
        obs_dtype = np.dtype(obs_dtype_str)
        nbytes = num_envs * int(np.prod(obs_shape)) * obs_dtype.itemsize
        obs_block = np.ndarray(
            (num_envs, *obs_shape),
            dtype=obs_dtype,
            buffer=shm.buf[shm_offset : shm_offset + nbytes],
        )
        act_off, rew_off, done_off = lane_offsets
        act_lane = np.ndarray(
            (num_envs,), np.int32, buffer=shm.buf[act_off : act_off + 4 * num_envs]
        )
        rew_lane = np.ndarray(
            (num_envs,), np.float32, buffer=shm.buf[rew_off : rew_off + 4 * num_envs]
        )
        done_lane = np.ndarray(
            (num_envs,), np.bool_, buffer=shm.buf[done_off : done_off + num_envs]
        )
        factory = pickle.loads(factory_bytes)
        from torched_impala_tpu_torch.envs.factory import call_env_factory

        envs = [
            call_env_factory(factory, base_seed + i, first_env_index + i)
            for i in range(num_envs)
        ]
        ep_return = np.zeros((num_envs,), np.float64)
        ep_len = np.zeros((num_envs,), np.int64)

        def reset_envs() -> None:
            # The seeds of the thread path's first resets, so pooled and
            # thread trajectories agree from any reset.
            for i, env in enumerate(envs):
                obs, _ = env.reset(seed=base_seed + i)
                obs_block[i] = np.asarray(obs)
            ep_return[:] = 0.0
            ep_len[:] = 0

        reset_envs()
        conn.send(("ready",))
        while True:
            msg = conn.recv()
            if msg[0] == "close":
                return
            if msg[0] == "reset":
                reset_envs()
                conn.send(("reset_done",))
                continue
            if msg[0] != "step":
                raise RuntimeError(f"unknown command {msg!r}")
            events: List[Tuple[int, float, int]] = []
            for i, env in enumerate(envs):
                obs, reward, terminated, truncated, _ = env.step(int(act_lane[i]))
                done = bool(terminated or truncated)
                rew_lane[i] = reward
                done_lane[i] = done
                ep_return[i] += float(reward)
                ep_len[i] += 1
                if done:
                    events.append((i, float(ep_return[i]), int(ep_len[i])))
                    ep_return[i] = 0.0
                    ep_len[i] = 0
                    obs, _ = env.reset()
                obs_block[i] = np.asarray(obs)
            conn.send(("stepped", events))
    except EOFError:
        pass
    except BaseException as e:  # noqa: BLE001 - report, then die
        try:
            conn.send(("error", repr(e)))
        except OSError:
            pass
    finally:
        shm.close()


class ProcessEnvPool:
    """W worker processes x E envs each, presented as one batched env.

    Worker w's env i is built and reset with seed `base_seed + SEED_STRIDE
    (w + 1) + i` and global index `first_env_index + w E + i`: the seeds
    and indices of the thread path's actor slots.

    Lockstep surface (`VectorActor`'s pooled path): `num_envs`,
    `reset_all() -> obs[N]` and `step_all(actions[N]) -> (obs[N],
    rewards[N], dones[N], events)`, where `dones` are the next step's
    `first` flags and `events` lists (global_env_idx, episode_return,
    episode_len).

    Async (ready-set) surface, with `mode="async"`: `submit(w, actions[E])
    -> bool`, `wait_any() -> [(w, rewards[E], dones[E], events, ok)]` and
    `read_obs(w) -> obs[E]`, with `num_workers`, `envs_per_worker` and
    `ready_fraction` for the driving actor to size its waves.
    """

    SEED_STRIDE = 1000
    # A worker silent this long is taken for dead (an env step of a real
    # emulator can take seconds; none takes minutes).
    STEP_TIMEOUT_S = 300.0

    def __init__(
        self,
        *,
        env_factory: Callable,
        num_workers: int,
        envs_per_worker: int,
        obs_shape: Sequence[int],
        obs_dtype,
        base_seed: int = 0,
        first_env_index: int = 0,
        max_restarts: int = 10,
        mode: str = "lockstep",
        ready_fraction: float = 0.5,
    ) -> None:
        if num_workers < 1 or envs_per_worker < 1:
            raise ValueError("need >= 1 worker and >= 1 env per worker")
        if mode not in ("lockstep", "async"):
            raise ValueError(f"unknown pool mode {mode!r}; expected 'lockstep' or 'async'")
        if ready_fraction == "auto":
            raise NotImplementedError(
                "ready_fraction='auto' (the pool's straggler-rate tuner) is not "
                "ported yet (ROADMAP.md queue 1: Observability, perf and control)"
            )
        if isinstance(ready_fraction, str) or not 0.0 < float(ready_fraction) <= 1.0:
            raise ValueError(f"ready_fraction must be a float in (0, 1], got {ready_fraction!r}")
        try:
            self._factory_bytes = pickle.dumps(env_factory)
        except Exception as e:
            raise ValueError(
                "process actors need a picklable env factory (a module-level "
                "function, functools.partial, or configs.make_env_factory "
                "output): closures and lambdas cannot reach a worker process"
            ) from e
        self._num_workers = num_workers
        self._envs_per_worker = envs_per_worker
        self._obs_shape = tuple(obs_shape)
        self._obs_dtype = np.dtype(obs_dtype)
        self._base_seed = base_seed
        self._first_env_index = first_env_index
        self._max_restarts = max_restarts
        self.mode = mode
        self.ready_fraction = float(ready_fraction)
        self.restarts = 0
        # Chaos seam (resilience/chaos.py): when set, called with the pool
        # at each lockstep step and each async submit, before any send.
        self.chaos_hook: Optional[Callable] = None

        n = num_workers * envs_per_worker
        obs_bytes = n * int(np.prod(self._obs_shape)) * self._obs_dtype.itemsize
        # 8-byte aligned lanes keep the int32/float32 views aligned.
        self._act_off = align(obs_bytes)
        self._rew_off = align(self._act_off + 4 * n)
        self._done_off = align(self._rew_off + 4 * n)
        self._shm = shared_memory.SharedMemory(create=True, size=max(1, self._done_off + n))
        buf = self._shm.buf
        self._obs_block = np.ndarray((n, *self._obs_shape), dtype=self._obs_dtype, buffer=buf)
        self._act_lane = np.ndarray(
            (n,), np.int32, buffer=buf[self._act_off : self._act_off + 4 * n]
        )
        self._rew_lane = np.ndarray(
            (n,), np.float32, buffer=buf[self._rew_off : self._rew_off + 4 * n]
        )
        self._done_lane = np.ndarray(
            (n,), np.bool_, buffer=buf[self._done_off : self._done_off + n]
        )
        self._procs: List[Optional[mp.process.BaseProcess]] = [None] * num_workers
        self._conns: List = [None] * num_workers
        self._in_flight: set = set()  # workers with an unanswered step token
        self._closed = False
        try:
            # Start every worker before waiting on any: the ready-waits
            # overlap the workers' start-up.
            _preload()
            for w in range(num_workers):
                self._start(w)
            for w in range(num_workers):
                self._wait_ready(w)
        except BaseException:
            self.close()
            raise

    # -- worker lifecycle --------------------------------------------------

    @property
    def shm_name(self) -> str:
        """The shared-memory segment's name (unlinked by `close`)."""
        return self._shm.name

    @property
    def pids(self) -> List[int]:
        """The worker processes' pids, in worker order."""
        return [p.pid for p in self._procs if p is not None]

    def _worker_slice(self, w: int) -> slice:
        E = self._envs_per_worker
        return slice(w * E, (w + 1) * E)

    def _start(self, w: int) -> None:
        parent_conn, child_conn = _CTX.Pipe()
        E = self._envs_per_worker
        offset = w * E * int(np.prod(self._obs_shape)) * self._obs_dtype.itemsize
        lane_offsets = (
            self._act_off + 4 * w * E,
            self._rew_off + 4 * w * E,
            self._done_off + w * E,
        )
        proc = _CTX.Process(
            target=_worker_main,
            args=(
                child_conn,
                self._shm.name,
                offset,
                lane_offsets,
                self._factory_bytes,
                E,
                self._base_seed + self.SEED_STRIDE * (w + 1),
                self._first_env_index + w * E,
                self._obs_shape,
                self._obs_dtype.str,
            ),
            daemon=True,
        )
        proc.start()
        child_conn.close()
        self._procs[w] = proc
        self._conns[w] = parent_conn

    def _wait_ready(self, w: int) -> None:
        msg = self._recv(w)
        if msg[0] != "ready":
            raise RuntimeError(f"env worker {w} failed to start: {msg!r}")

    def _recv(self, w: int):
        conn = self._conns[w]
        if not conn.poll(self.STEP_TIMEOUT_S):
            raise TimeoutError(f"env worker {w} did not respond within {self.STEP_TIMEOUT_S}s")
        return conn.recv()

    def _restart(self, w: int, reason: str) -> None:
        """Replace worker `w` by a fresh one (its envs reset), counting one
        restart; raises once the budget is spent."""
        self._in_flight.discard(w)  # a fresh worker has nothing in flight
        if self.restarts >= self._max_restarts:
            raise RuntimeError(
                f"env worker {w} died ({reason}) and the pool restart budget "
                f"({self._max_restarts}) is spent"
            )
        self.restarts += 1
        proc = self._procs[w]
        if proc is not None and proc.is_alive():
            proc.terminate()
        if proc is not None:
            proc.join(timeout=10)
        self._conns[w].close()
        self._start(w)
        self._wait_ready(w)

    # -- batched env surface ----------------------------------------------

    @property
    def num_envs(self) -> int:
        return self._num_workers * self._envs_per_worker

    @property
    def num_workers(self) -> int:
        return self._num_workers

    @property
    def envs_per_worker(self) -> int:
        return self._envs_per_worker

    def reset_all(self) -> np.ndarray:
        """Reset every env (workers re-seed as at start-up) and return a
        copy of the initial observations. Steps still in flight (async
        mode) are drained first, so no late reply races the reset's."""
        for w in sorted(self._in_flight):
            try:
                self._recv(w)
            except (EOFError, OSError, TimeoutError):
                pass  # a dead worker is repaired through the send below
        self._in_flight.clear()
        dead: List[int] = []
        for w in range(self._num_workers):
            try:
                self._conns[w].send(("reset",))
            except (BrokenPipeError, OSError) as e:
                self._restart(w, f"send failed: {e!r}")
                dead.append(w)  # the fresh worker already wrote reset obs
        for w in range(self._num_workers):
            if w in dead:
                continue
            try:
                msg = self._recv(w)
                if msg[0] != "reset_done":
                    raise RuntimeError(f"env worker {w}: unexpected reply {msg!r}")
            except (EOFError, OSError, TimeoutError, RuntimeError) as e:
                self._restart(w, repr(e))
        return np.array(self._obs_block)

    def step_all(
        self,
        actions: np.ndarray,
        out_rewards: Optional[np.ndarray] = None,
        out_dones: Optional[np.ndarray] = None,
    ):
        """Step every env once; returns (next_obs, rewards, dones, events).

        Rows of `next_obs` for finished envs are fresh reset observations
        and their `dones` entry is True. A worker that failed is restarted
        in place: its envs reset, its rows reported done with zero reward
        (an episode boundary for the learner, not a poisoned unroll).

        `out_rewards` / `out_dones` (`[num_envs]` float32 / bool) receive
        the reward and done lanes in place and are returned as the
        rewards and dones: the lanes fold straight into the caller's
        unroll (or ring) rows. Every row is written each call."""
        n = self.num_envs
        rewards = out_rewards if out_rewards is not None else np.zeros((n,), np.float32)
        dones = out_dones if out_dones is not None else np.zeros((n,), np.bool_)
        events: List[Tuple[int, float, int]] = []
        if self.chaos_hook is not None:
            self.chaos_hook(self)
        self._act_lane[:] = np.asarray(actions, np.int32)
        dead: List[int] = []
        for w in range(self._num_workers):
            try:
                self._conns[w].send(("step",))
            except (BrokenPipeError, OSError) as e:
                self._restart(w, f"send failed: {e!r}")
                dead.append(w)
        for w in range(self._num_workers):
            sl = self._worker_slice(w)
            if w in dead:
                rewards[sl] = 0.0
                dones[sl] = True
                continue
            try:
                msg = self._recv(w)
                if msg[0] == "error":
                    raise RuntimeError(f"env worker {w}: {msg[1]}")
                if msg[0] != "stepped":
                    raise RuntimeError(f"env worker {w}: unexpected reply {msg!r}")
                rewards[sl] = self._rew_lane[sl]
                dones[sl] = self._done_lane[sl]
                events.extend((sl.start + i, ret, length) for i, ret, length in msg[1])
            except (EOFError, OSError, TimeoutError, RuntimeError) as e:
                self._restart(w, repr(e))
                rewards[sl] = 0.0
                dones[sl] = True
        return np.array(self._obs_block), rewards, dones, events

    # -- async (ready-set) surface ----------------------------------------

    def submit(self, w: int, actions) -> bool:
        """Queue one step for worker `w`: write its action-lane slice and
        send the token. True with the step in flight; False when the worker
        was found dead: it has been restarted with reset envs (fresh obs
        in the block), no step is in flight, and the caller records the
        transition as an episode boundary (reward 0, done True)."""
        if w in self._in_flight:
            raise RuntimeError(
                f"worker {w} already has a step in flight; wait_any() it before "
                "submitting again"
            )
        if self.chaos_hook is not None:
            self.chaos_hook(self)
        self._act_lane[self._worker_slice(w)] = np.asarray(actions, np.int32)
        try:
            self._conns[w].send(("step",))
        except (BrokenPipeError, OSError) as e:
            self._restart(w, f"send failed: {e!r}")
            return False
        self._in_flight.add(w)
        return True

    def _crash_result(self, w: int):
        E = self._envs_per_worker
        return (w, np.zeros((E,), np.float32), np.ones((E,), np.bool_), [], False)

    def wait_any(self, workers=None, timeout: Optional[float] = None, copy: bool = True):
        """Block until at least one in-flight worker answers its step;
        return every answer available as [(w, rewards[E], dones[E],
        events, ok)], events with global env indices.

        `workers` restricts the wait to a subset of the in-flight workers.
        A dead or erroring worker comes back with ok=False after a
        restart (reward 0, done True, fresh obs). An explicit `timeout`
        makes the call a bounded poll that returns [] when nothing is
        ready; only the default full step timeout counts the silent
        workers as dead and restarts them.

        `copy=False` returns views of the reward and done lanes, valid
        until the worker's next `submit`."""
        waiting = sorted(
            self._in_flight if workers is None else self._in_flight & set(workers)
        )
        if not waiting:
            return []
        poll_only = timeout is not None
        timeout = self.STEP_TIMEOUT_S if timeout is None else timeout
        conn_map = {self._conns[w]: w for w in waiting}
        ready = mp_connection.wait(list(conn_map), timeout)
        results = []
        if not ready:
            if poll_only:
                return []
            for w in waiting:
                self._restart(w, f"no step reply within {timeout}s")
                results.append(self._crash_result(w))
            return results
        for conn in ready:
            w = conn_map[conn]
            sl = self._worker_slice(w)
            try:
                msg = conn.recv()
                self._in_flight.discard(w)
                if msg[0] == "error":
                    raise RuntimeError(f"env worker {w}: {msg[1]}")
                if msg[0] != "stepped":
                    raise RuntimeError(f"env worker {w}: unexpected reply {msg!r}")
                events = [(sl.start + i, ret, length) for i, ret, length in msg[1]]
                rewards = self._rew_lane[sl]
                dones = self._done_lane[sl]
                if copy:
                    rewards, dones = rewards.copy(), dones.copy()
                results.append((w, rewards, dones, events, True))
            except (EOFError, OSError, RuntimeError) as e:
                self._restart(w, repr(e))
                results.append(self._crash_result(w))
        return results

    def read_obs(self, w: int) -> np.ndarray:
        """Copy of worker `w`'s current observation rows (after its reply:
        the reply orders the worker's writes)."""
        return np.array(self._obs_block[self._worker_slice(w)])

    def close(self) -> None:
        """Stop every worker (close token, then terminate stragglers) and
        unlink the shared-memory segment. Idempotent."""
        if self._closed:
            return
        self._closed = True
        for conn in self._conns:
            if conn is not None:
                try:
                    conn.send(("close",))
                except OSError:
                    pass
        deadline = time.monotonic() + 10
        for proc in self._procs:
            if proc is not None:
                proc.join(timeout=max(0.1, deadline - time.monotonic()))
                if proc.is_alive():
                    proc.terminate()
                    proc.join(timeout=5)
        for conn in self._conns:
            if conn is not None:
                conn.close()
        # The views into the segment go before it closes, or the buffer
        # export keeps the mapping alive.
        del self._obs_block, self._act_lane, self._rew_lane, self._done_lane
        self._shm.close()
        try:
            self._shm.unlink()
        except FileNotFoundError:
            pass

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
