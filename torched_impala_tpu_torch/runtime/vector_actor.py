"""VectorActor: E envs in lockstep, one batched policy step per timestep
(counterpart of `torched_impala_tpu/runtime/vector_actor.py`).

Each unroll cycle loads the latest published params into the actor's
private net, steps its E envs for T steps with one `Agent.step` on the
actor's device per timestep, and emits E single-env `Trajectory`s.
Alignment is the JAX actor's:

- obs[t], first[t] are what the policy saw at step t; first[t] is set
  where obs[t] starts an episode (initially all set);
- cont[t] = 0 where the step ended the episode (truncation counts as
  termination), and the env is reset at once, so obs[t+1] is the new
  episode's first observation with first[t+1] set;
- obs[T], first[T] are the bootstrap observation and flag;
- agent_state is env i's recurrent carry at obs[0], before the core's
  reset by first[0] (the learner's unroll applies that reset again).

`envs` is either a list of gymnasium-API envs, stepped in this thread, or
a `ProcessEnvPool`, whose worker processes step the envs while this
thread runs the batched inference. A lockstep pool steps every env each
timestep; an async pool (the ready-set protocol) drops that barrier:
each worker keeps its own time index, inference runs in waves over
whichever `pool.ready_fraction` of the workers has answered, and
stragglers catch up on a later wave. Every row of a worker advances once
per answer into that worker's own `t` row of the unroll buffers, so each
env's trajectory stays time-contiguous.

With a `TrajectoryRing` the unroll is written straight into a block of E
columns of a learner batch slot and committed there; `enqueue` is never
called.
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from torched_impala_tpu_torch.models.agent import Agent
from torched_impala_tpu_torch.runtime.param_store import ParamStore
from torched_impala_tpu_torch.runtime.traj_ring import TrajectoryRing
from torched_impala_tpu_torch.runtime.types import QueueClosed, Trajectory, map_state


class VectorActor:
    def __init__(
        self,
        *,
        actor_id: int,
        envs: Sequence,
        agent: Agent,
        param_store: ParamStore,
        enqueue: Callable[[Trajectory], None],
        unroll_length: int,
        device: torch.device,
        seed: int = 0,
        on_episode_return: Optional[Callable[[int, float, int], None]] = None,
        traj_ring: Optional[TrajectoryRing] = None,
        chaos: Optional[Callable[[int], None]] = None,
    ) -> None:
        """`agent` is cloned: the actor keeps a private net on `device`.
        `envs` is a list of envs or a `ProcessEnvPool` (module docstring);
        with `traj_ring` the env count must divide the ring's batch
        (`loop.train` checks it, and `TrajectoryRing.acquire` refuses a
        block that does not). `chaos` (resilience/chaos.py) is called with
        `actor_id` at each unroll start; a raise_in_actor fault raises
        there, before any env step or ring block, and takes the real
        crash's path to the supervisor."""
        self._id = actor_id
        self._chaos = chaos
        self._agent = agent.clone()
        self._agent.net.to(device)
        self._device = torch.device(device)
        self._param_store = param_store
        self._enqueue = enqueue
        self._unroll_length = unroll_length
        self._on_episode_return = on_episode_return
        self._generator = torch.Generator(device=self._device)
        self._generator.manual_seed(seed)
        self._version = None
        self.error: Optional[BaseException] = None
        if hasattr(envs, "step_all"):  # a ProcessEnvPool
            self._pool = envs
            self._envs = []
            self._obs = self._pool.reset_all()  # [E, ...]
        else:
            if not envs:
                raise ValueError("VectorActor needs at least one env")
            self._pool = None
            self._envs = list(envs)
            self._obs = np.stack(
                [np.asarray(env.reset(seed=seed + i)[0]) for i, env in enumerate(self._envs)]
            )  # [E, ...]
        E = self.num_envs
        self._ring = traj_ring
        if traj_ring is not None:
            # A drift between env and ring buffers fails here, not as
            # garbled batches.
            problems = traj_ring.validate_env_spec(self._obs[0], agent.net.num_actions)
            if unroll_length != traj_ring.unroll_length:
                problems.append(
                    f"traj_ring unroll_length {traj_ring.unroll_length} != actor "
                    f"unroll_length {unroll_length}"
                )
            if problems:
                raise ValueError("; ".join(problems))
        # The pool's done lane folds into this row each step; cont and
        # first are computed from it.
        self._dones_scratch = np.zeros((E,), np.bool_)
        self._first = np.ones((E,), np.bool_)
        self._state = self._agent.initial_state(E)
        self._episode_return = np.zeros((E,), np.float64)
        self._episode_len = np.zeros((E,), np.int64)

    @property
    def num_envs(self) -> int:
        return self._pool.num_envs if self._pool is not None else len(self._envs)

    def _load_latest(self) -> int:
        version, params = self._param_store.get()
        if version != self._version:
            self._agent.load_params(params)
            self._version = version
        return version

    def _policy(self, obs: np.ndarray, first: np.ndarray, state):
        return self._agent.step(
            torch.from_numpy(obs).to(self._device),
            torch.from_numpy(first).to(self._device),
            state,
            self._generator,
        )

    def _report(self, events) -> None:
        if self._on_episode_return is not None:
            for _, ret, length in events:
                self._on_episode_return(self._id, ret, length)

    def unroll(self) -> List[Trajectory]:
        """Step all E envs for T steps with the latest params; return E
        single-env trajectories (none with a ring: the unroll was
        committed into a batch slot)."""
        if self._chaos is not None:
            self._chaos(self._id)
        param_version = self._load_latest()
        T, E = self._unroll_length, self.num_envs
        block = None
        if self._ring is not None:
            # Blocks while every slot is busy; QueueClosed after stop.
            block = self._ring.acquire(E)
            bufs = (block.obs, block.first, block.actions, block.rewards, block.cont,
                    block.behaviour_logits)
        else:
            bufs = (
                np.empty((T + 1, E, *self._obs.shape[1:]), self._obs.dtype),
                np.empty((T + 1, E), np.bool_),
                np.empty((T, E), np.int32),
                np.empty((T, E), np.float32),
                np.empty((T, E), np.float32),
                np.empty((T, E, self._agent.net.num_actions), np.float32),
            )
        # The carry (or KV cache) at obs[0], on the host once per unroll:
        # trajectory i gets its own rows [i:i+1] of every leaf (np.array
        # copies, so no later step can alias it).
        start_state = map_state(lambda x: np.array(x.cpu()), self._state)
        try:
            if self._pool is not None and self._pool.mode == "async":
                self._unroll_async(*bufs)
            else:
                self._unroll_lockstep(*bufs)
            if block is not None:
                map_state(np.copyto, block.agent_state, start_state)
                self._ring.commit(block, param_version)
                return []
        except BaseException:
            # The reserved columns hold garbage: surrender them, so the
            # slot recycles instead of delivering.
            if block is not None:
                self._ring.abort(block)
            raise
        obs_buf, first_buf, actions, rewards, cont, logits_buf = bufs
        return [
            Trajectory(
                obs=obs_buf[:, i],
                first=first_buf[:, i],
                actions=actions[:, i],
                behaviour_logits=logits_buf[:, i],
                rewards=rewards[:, i],
                cont=cont[:, i],
                agent_state=map_state(lambda x: x[i : i + 1], start_state),
                actor_id=self._id,
                param_version=param_version,
            )
            for i in range(E)
        ]

    def _unroll_lockstep(self, obs_buf, first_buf, actions, rewards, cont, logits_buf) -> None:
        T = self._unroll_length
        for t in range(T):
            obs_buf[t] = self._obs
            first_buf[t] = self._first
            out = self._policy(self._obs, self._first, self._state)
            self._state = out.state
            acts = out.action.cpu().numpy()
            logits_buf[t] = out.policy_logits.cpu().numpy()
            if self._pool is not None:
                # The workers step the envs and reset finished ones; the
                # reward lane folds straight into this unroll row.
                actions[t] = acts
                next_obs, _, dones, events = self._pool.step_all(
                    acts, out_rewards=rewards[t], out_dones=self._dones_scratch
                )
                cont[t] = np.where(dones, 0.0, 1.0)
                self._obs = next_obs
                self._first = dones.copy()
                self._report(events)
                continue
            for i, env in enumerate(self._envs):
                next_obs, reward, terminated, truncated, _ = env.step(int(acts[i]))
                done = bool(terminated or truncated)
                actions[t, i] = acts[i]
                rewards[t, i] = float(reward)
                cont[t, i] = 0.0 if done else 1.0
                self._episode_return[i] += float(reward)
                self._episode_len[i] += 1
                if done:
                    if self._on_episode_return is not None:
                        self._on_episode_return(
                            self._id,
                            float(self._episode_return[i]),
                            int(self._episode_len[i]),
                        )
                    self._episode_return[i] = 0.0
                    self._episode_len[i] = 0
                    next_obs, _ = env.reset()
                self._obs[i] = np.asarray(next_obs)
                self._first[i] = done
        obs_buf[T] = self._obs
        first_buf[T] = self._first

    def _unroll_async(self, obs_buf, first_buf, actions, rewards, cont, logits_buf) -> None:
        """The ready-set unroll against an async pool (JAX
        `_unroll_async_body`): a wave takes the first `wave_k` workers to
        answer (first come, first served, so none starves), runs one
        batched inference over their rows and submits their actions. The
        unroll ends when every worker reaches T."""
        pool = self._pool
        T = self._unroll_length
        W, Ew = pool.num_workers, pool.envs_per_worker
        wave_k = max(1, math.ceil(pool.ready_fraction * W))
        obs_buf[0] = self._obs
        first_buf[0] = self._first
        t_w = np.zeros((W,), np.int64)
        submit_t = np.zeros((W,), np.float64)
        ewma_step = None  # of the normal submit-to-answer seconds
        # No step is in flight between unrolls (the last one's tail drained
        # every answer), so every worker starts actionable at t = 0.
        actionable = collections.deque(range(W))
        completed = 0

        def advance(w, step_rewards, dones, events, timed=True) -> None:
            # Record worker w's step t_w[w]; its rows' next obs and first
            # are now current.
            nonlocal completed, ewma_step
            if timed:
                dur = time.monotonic() - submit_t[w]
                if ewma_step is None:
                    ewma_step = dur
                elif dur < 2.0 * ewma_step:
                    # Track normal steps only: a straggler's stall must not
                    # widen the grace window below.
                    ewma_step = 0.8 * ewma_step + 0.2 * dur
            t, sl = int(t_w[w]), slice(w * Ew, (w + 1) * Ew)
            rewards[t, sl] = step_rewards
            cont[t, sl] = np.where(dones, 0.0, 1.0)
            obs = pool.read_obs(w)
            obs_buf[t + 1, sl] = obs
            first_buf[t + 1, sl] = dones
            self._obs[sl] = obs
            self._first[sl] = dones
            t_w[w] = t + 1
            self._report(events)
            if t + 1 >= T:
                completed += 1
            else:
                actionable.append(w)

        while completed < W:
            # Wait only until the first wave_k workers (or every one left
            # below T) are ready, never for the whole pool.
            while len(actionable) < min(wave_k, W - completed):
                for w, rw, dn, events, _ok in pool.wait_any(copy=False):
                    advance(w, rw, dn, events)
            # A grace window of a quarter of a normal step for the rest: a
            # pool without stragglers then coalesces into one full wave a
            # timestep, while a straggler costs its wave only the grace.
            if ewma_step is not None:
                deadline = time.monotonic() + 0.25 * ewma_step
                while completed + len(actionable) < W:
                    budget = deadline - time.monotonic()
                    if budget <= 0:
                        break
                    answers = pool.wait_any(timeout=budget, copy=False)
                    if not answers:
                        break
                    for w, rw, dn, events, _ok in answers:
                        advance(w, rw, dn, events)
            else:
                for w, rw, dn, events, _ok in pool.wait_any(timeout=0, copy=False):
                    advance(w, rw, dn, events)
            remaining = W - completed
            if remaining == 0:
                break
            # A full wave when every remaining worker is ready, else
            # exactly wave_k, so the batch shapes stay few.
            take = len(actionable) if len(actionable) == remaining else min(wave_k, len(actionable))
            wave = [actionable.popleft() for _ in range(take)]
            rows = np.concatenate([np.arange(w * Ew, (w + 1) * Ew) for w in wave])
            rows_t = torch.from_numpy(rows).to(self._device)
            out = self._policy(
                self._obs[rows], self._first[rows], map_state(lambda x: x[rows_t], self._state)
            )
            self._state = map_state(
                lambda full, new: full.index_copy(0, rows_t, new), self._state, out.state
            )
            acts = out.action.cpu().numpy()
            wave_logits = out.policy_logits.cpu().numpy()
            for j, w in enumerate(wave):
                t, sl = int(t_w[w]), slice(w * Ew, (w + 1) * Ew)
                seg = slice(j * Ew, (j + 1) * Ew)
                actions[t, sl] = acts[seg]
                logits_buf[t, sl] = wave_logits[seg]
                submit_t[w] = time.monotonic()
                if not pool.submit(w, acts[seg]):
                    # A dead worker, restarted by the pool with reset envs:
                    # the action resolves as an episode boundary.
                    advance(
                        w, np.zeros((Ew,), np.float32), np.ones((Ew,), np.bool_), [],
                        timed=False,
                    )

    def unroll_and_push(self) -> None:
        for traj in self.unroll():
            self._enqueue(traj)

    def run(self, stop_event: threading.Event) -> None:
        """Actor loop until `stop_event` or the learner closes its queue or
        ring. Errors are recorded on `self.error` for the train loop's
        watchdog, then re-raised."""
        try:
            while not stop_event.is_set():
                try:
                    self.unroll_and_push()
                except QueueClosed:
                    return
        except BaseException as e:  # noqa: BLE001 - the watchdog reads it
            self.error = e
            raise
