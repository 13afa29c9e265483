"""Deterministic fake environments for tests and throughput runs (copied
from `torched_impala_tpu/envs/fake.py`: the port keeps its own copy).

They give the observation and action contracts of the real emulators
(ALE, DMLab) without the emulators, which the hosts of the port lack.
"""

from __future__ import annotations

import time

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
    """Random-pixel uint8 env with fixed-length episodes, stands in for ALE
    in throughput runs and pixel-pipeline tests: 84x84x4 frames, or any
    `obs_shape` (64x64x3 Procgen, 72x96x3 DMLab). Every shape draws from
    one generator in the same order, so its pixels, rewards and episode
    ends are those of the JAX factory's fakes for the same seed (its
    `FakeAtariEnv`, or `_ShapedPixels` off 84x84x4). `task_id` is the
    task the env factory assigned."""

    def __init__(
        self,
        episode_len: int = 1000,
        num_actions: int = 6,
        seed=0,
        obs_shape=(84, 84, 4),
        task_id: int = 0,
    ):
        self._rng = np.random.default_rng(seed)
        self._episode_len = episode_len
        self._num_actions = num_actions
        self._obs_shape = tuple(obs_shape)
        self.task_id = task_id
        self._t = 0

    @property
    def action_space_n(self) -> int:
        return self._num_actions

    def _obs(self) -> np.ndarray:
        return self._rng.integers(0, 256, size=self._obs_shape, dtype=np.uint8)

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


class StragglerEnv:
    """Wraps another env and adds a delay to each step: `base_delay_s`
    always (an emulator's cost), plus `straggler_delay_s` with probability
    `straggler_prob` (the long-tail stall, a slow frame or an auto-reset,
    that a lockstep pool puts on every wave). Tests of the async pool's
    ready-set waves run on it."""

    def __init__(
        self,
        inner,
        base_delay_s: float = 0.0,
        straggler_delay_s: float = 0.0,
        straggler_prob: float = 0.0,
        seed: int = 0,
    ):
        self._inner = inner
        self._base_delay_s = base_delay_s
        self._straggler_delay_s = straggler_delay_s
        self._straggler_prob = straggler_prob
        self._rng = np.random.default_rng(seed)
        self.task_id = getattr(inner, "task_id", 0)

    @property
    def action_space_n(self) -> int:
        return self._inner.action_space_n

    def reset(self, seed=None):
        return self._inner.reset(seed=seed)

    def step(self, action):
        delay = self._base_delay_s
        if self._straggler_delay_s > 0.0 and self._rng.uniform() < self._straggler_prob:
            delay += self._straggler_delay_s
        if delay > 0.0:
            time.sleep(delay)
        return self._inner.step(action)


class StragglerFactory:
    """Picklable env factory that wraps another factory's envs in
    `StragglerEnv` (seeded `seed + 17`), for thread and process actors."""

    def __init__(
        self,
        inner,
        base_delay_s: float = 0.0,
        straggler_delay_s: float = 0.0,
        straggler_prob: float = 0.0,
    ):
        self.inner = inner
        self.base_delay_s = base_delay_s
        self.straggler_delay_s = straggler_delay_s
        self.straggler_prob = straggler_prob

    def __call__(self, seed: int, env_index=None):
        from torched_impala_tpu_torch.envs.factory import call_env_factory

        env = call_env_factory(self.inner, seed, env_index)
        return StragglerEnv(
            env,
            base_delay_s=self.base_delay_s,
            straggler_delay_s=self.straggler_delay_s,
            straggler_prob=self.straggler_prob,
            seed=seed + 17,
        )


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
