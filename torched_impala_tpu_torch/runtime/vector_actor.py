"""VectorActor: E envs in lockstep, one batched policy step per timestep
(counterpart of `torched_impala_tpu/runtime/vector_actor.py` on its thread
path; the process env pool and the trajectory ring are not ported yet).

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
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from torched_impala_tpu_torch.models.agent import Agent
from torched_impala_tpu_torch.runtime.param_store import ParamStore
from torched_impala_tpu_torch.runtime.types import QueueClosed, Trajectory


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
    ) -> None:
        """`agent` is cloned: the actor keeps a private net on `device`."""
        if not envs:
            raise ValueError("VectorActor needs at least one env")
        self._id = actor_id
        self._envs = list(envs)
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
        E = len(self._envs)
        self._obs = np.stack(
            [np.asarray(env.reset(seed=seed + i)[0]) for i, env in enumerate(self._envs)]
        )  # [E, ...]
        self._first = np.ones((E,), np.bool_)
        self._state = self._agent.initial_state(E)
        self._episode_return = np.zeros((E,), np.float64)
        self._episode_len = np.zeros((E,), np.int64)

    @property
    def num_envs(self) -> int:
        return len(self._envs)

    def _load_latest(self) -> int:
        version, params = self._param_store.get()
        if version != self._version:
            self._agent.load_params(params)
            self._version = version
        return version

    def unroll(self) -> List[Trajectory]:
        """Step all E envs for T steps with the latest params; return E
        single-env trajectories."""
        param_version = self._load_latest()
        T, E = self._unroll_length, self.num_envs
        obs_buf = np.empty((T + 1, E, *self._obs.shape[1:]), self._obs.dtype)
        first_buf = np.empty((T + 1, E), np.bool_)
        actions = np.empty((T, E), np.int32)
        rewards = np.empty((T, E), np.float32)
        cont = np.empty((T, E), np.float32)
        logits_buf = None
        # The carry at obs[0], on the host once per unroll: trajectory i
        # gets its own rows [i:i+1] (np.array copies, so no later step
        # can alias it).
        start_state = tuple(np.array(x.cpu()) for x in self._state)
        for t in range(T):
            obs_buf[t] = self._obs
            first_buf[t] = self._first
            out = self._agent.step(
                torch.from_numpy(self._obs).to(self._device),
                torch.from_numpy(self._first).to(self._device),
                self._state,
                self._generator,
            )
            self._state = out.state
            acts = out.action.cpu().numpy()
            logits = out.policy_logits.cpu().numpy()
            if logits_buf is None:
                logits_buf = np.empty((T, E, logits.shape[-1]), np.float32)
            logits_buf[t] = logits
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
        return [
            Trajectory(
                obs=obs_buf[:, i],
                first=first_buf[:, i],
                actions=actions[:, i],
                behaviour_logits=logits_buf[:, i],
                rewards=rewards[:, i],
                cont=cont[:, i],
                agent_state=tuple(x[i : i + 1] for x in start_state),
                actor_id=self._id,
                param_version=param_version,
            )
            for i in range(E)
        ]

    def unroll_and_push(self) -> None:
        for traj in self.unroll():
            self._enqueue(traj)

    def run(self, stop_event: threading.Event) -> None:
        """Actor loop until `stop_event` or the learner closes its queue.
        Errors are recorded on `self.error` for the train loop's watchdog,
        then re-raised."""
        try:
            while not stop_event.is_set():
                try:
                    self.unroll_and_push()
                except QueueClosed:
                    return
        except BaseException as e:  # noqa: BLE001 - the watchdog reads it
            self.error = e
            raise
