"""Deterministic fake environments for tests and throughput runs (copied
from `torched_impala_tpu/envs/fake.py`: the port keeps its own copy).

They give the observation and action contracts of the real emulators
(ALE, DMLab) without the emulators, which the hosts of the port lack.
"""

from __future__ import annotations

import numpy as np


class ScriptedEnv:
    """Gymnasium-API env with scripted episode lengths and rewards.

    Observation is a float32 vector encoding (step_in_episode, episode_idx);
    reward is +1 on every step; episodes last `episode_len` steps. Useful for
    asserting trajectory alignment (first flags, bootstrapping, returns).
    """

    def __init__(self, episode_len: int = 5, obs_size: int = 4):
        self._episode_len = episode_len
        self._obs_size = obs_size
        self._t = 0
        self._episode = 0

    @property
    def action_space_n(self) -> int:
        return 2

    def _obs(self) -> np.ndarray:
        obs = np.zeros((self._obs_size,), np.float32)
        obs[0] = self._t
        obs[1] = self._episode
        return obs

    def reset(self, seed=None):
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        self._t += 1
        terminated = self._t >= self._episode_len
        if terminated:
            self._episode += 1
        return self._obs(), 1.0, terminated, False, {}


class FakeAtariEnv:
    """84x84x4 uint8 random-pixel env with fixed-length episodes — stands in
    for ALE in throughput runs and pixel-pipeline tests."""

    def __init__(self, episode_len: int = 1000, num_actions: int = 6, seed=0):
        self._rng = np.random.default_rng(seed)
        self._episode_len = episode_len
        self._num_actions = num_actions
        self._t = 0

    @property
    def action_space_n(self) -> int:
        return self._num_actions

    def _obs(self) -> np.ndarray:
        return self._rng.integers(0, 256, size=(84, 84, 4), dtype=np.uint8)

    def reset(self, seed=None):
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        self._t += 1
        terminated = self._t >= self._episode_len
        if terminated:
            self._t = 0
        reward = float(self._rng.uniform() < 0.05)
        return self._obs(), reward, terminated, False, {}


class FakeDiscreteEnv:
    """Random vector-obs env with configurable reward scale and task id."""

    def __init__(
        self,
        obs_shape=(8,),
        num_actions: int = 4,
        episode_len: int = 10,
        reward_scale: float = 1.0,
        task_id: int = 0,
        seed: int = 0,
    ):
        self._rng = np.random.default_rng(seed)
        self._obs_shape = tuple(obs_shape)
        self._num_actions = num_actions
        self._episode_len = episode_len
        self._reward_scale = reward_scale
        self.task_id = task_id
        self._t = 0

    @property
    def action_space_n(self) -> int:
        return self._num_actions

    def _obs(self) -> np.ndarray:
        return self._rng.normal(size=self._obs_shape).astype(np.float32)

    def reset(self, seed=None):
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        self._t += 1
        terminated = self._t >= self._episode_len
        if terminated:
            self._t = 0
        reward = float(self._rng.normal()) * self._reward_scale
        return self._obs(), reward, terminated, False, {}


class CrashingFactory:
    """Picklable env factory that wraps another factory's envs in
    `CrashingEnv`: a fault for the env pool's restart path."""

    def __init__(self, inner, crash_after: int):
        self.inner = inner
        self.crash_after = crash_after

    def __call__(self, seed: int, env_index=None):
        from torched_impala_tpu_torch.envs.factory import call_env_factory

        env = call_env_factory(self.inner, seed, env_index)
        return CrashingEnv(env, crash_after=self.crash_after)


class CrashingEnv:
    """Wraps another env and raises after `crash_after` total steps; each
    fresh instance crashes again after its own `crash_after` steps."""

    def __init__(self, inner, crash_after: int):
        self._inner = inner
        self._crash_after = crash_after
        self._steps = 0

    @property
    def action_space_n(self) -> int:
        return self._inner.action_space_n

    def reset(self, seed=None):
        return self._inner.reset(seed=seed)

    def step(self, action):
        self._steps += 1
        if self._steps >= self._crash_after:
            raise RuntimeError(f"chaos: env crashed after {self._steps} steps")
        return self._inner.step(action)
