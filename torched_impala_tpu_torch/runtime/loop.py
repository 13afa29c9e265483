"""Experiment wiring: the actors and one learner (counterpart of
`torched_impala_tpu/runtime/loop.py:train`).

`train()` builds the learner on `device` and its actors, and runs the
learner for `total_steps` updates. Actors come in two modes:

- "thread": `num_actors` actor threads, each stepping `envs_per_actor`
  envs itself with batched inference on the same device;
- "process": `num_actors` worker processes of `envs_per_actor` envs each
  (runtime/env_pool.py), split into two pools when there are two workers
  or more, each pool driven by its own batched-inference `VectorActor`
  thread: while one thread waits on its workers' env steps, the other
  runs its policy batch. `pool_mode` schedules the pools ("lockstep" or
  the "async" ready set, with `pool_ready_fraction`).

With `learner_config.traj_ring` the actors write their unrolls straight
into the learner's batch slots (runtime/traj_ring.py) instead of
enqueueing trajectories; every actor's env count must divide the batch.

There is no actor supervisor yet (ROADMAP.md queue 1: Checkpoint and
resilience): an actor's error is raised, at once when the learner starves
for batches, else when the run ends. Pools repair their own dead workers
within their restart budget.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from torched_impala_tpu_torch.device import resolve_device
from torched_impala_tpu_torch.envs.factory import call_env_factory
from torched_impala_tpu_torch.models.agent import Agent
from torched_impala_tpu_torch.optim import RMSProp
from torched_impala_tpu_torch.runtime.learner import Learner, LearnerConfig
from torched_impala_tpu_torch.runtime.vector_actor import VectorActor


@dataclasses.dataclass
class TrainResult:
    episode_returns: list  # (actor_id, return, length) in completion order
    final_logs: Mapping[str, Any]
    learner: Learner
    num_frames: int
    # The process-mode pools' worker pids and shared-memory names, for
    # checks after the run (all exited and unlinked by then).
    pool_pids: list = dataclasses.field(default_factory=list)
    pool_shm_names: list = dataclasses.field(default_factory=list)


def _pool_groups(num_actors: int) -> list[list[int]]:
    """Worker slots of each pool: one pool under two workers, else two
    halves."""
    if num_actors < 2:
        return [list(range(num_actors))]
    return [list(range(num_actors // 2)), list(range(num_actors // 2, num_actors))]


def train(
    *,
    agent: Agent,
    env_factory: Callable[..., Any],  # (seed, env_index) -> env
    num_actors: int,
    learner_config: LearnerConfig,
    optimizer: RMSProp,
    total_steps: int,
    envs_per_actor: int = 1,
    actor_mode: str = "thread",
    pool_mode: str = "lockstep",
    pool_ready_fraction: float = 0.5,
    seed: int = 0,
    device: str | torch.device | None = None,
    logger: Optional[Callable[[Mapping[str, Any]], None]] = None,
    log_every: int = 50,
) -> TrainResult:
    """Run the actor-learner loop for `total_steps` learner updates.

    `device=None` is the CUDA card (raises without one); pass "cpu" for
    the plain PyTorch path. In process mode the env factory must be
    picklable (`configs.make_env_factory`'s is)."""
    if actor_mode not in ("thread", "process"):
        raise ValueError(f"unknown actor_mode {actor_mode!r}")
    if pool_mode not in ("lockstep", "async"):
        raise ValueError(f"unknown pool_mode {pool_mode!r}")
    device = resolve_device(device)
    episode_returns: collections.deque = collections.deque(maxlen=10_000)
    returns_lock = threading.Lock()

    def on_episode_return(actor_id: int, ret: float, length: int) -> None:
        with returns_lock:
            episode_returns.append((actor_id, ret, length))

    step_logs: dict = {}

    def learner_logger(logs: Mapping[str, Any]) -> None:
        step_logs.update(logs)
        if logger is not None:
            with returns_lock:
                recent = [r for _, r, _ in list(episode_returns)[-100:]]
            merged = dict(logs)
            merged["episode_return_mean"] = (
                float(np.mean(recent)) if recent else float("nan")
            )
            logger(merged)

    # One observation shapes the pools' shared memory and the ring's slots.
    example_obs = None
    if actor_mode == "process" or learner_config.traj_ring:
        example_obs = np.asarray(call_env_factory(env_factory, seed, 0).reset(seed=seed)[0])
    learner = Learner(
        agent=agent,
        optimizer=optimizer,
        config=dataclasses.replace(learner_config, log_interval=log_every),
        device=device,
        logger=learner_logger,
        example_obs=example_obs,
    )
    pools: list = []
    if actor_mode == "process":
        from torched_impala_tpu_torch.runtime.env_pool import ProcessEnvPool

        # Worker slot w keeps the thread path's seeds and global env
        # indices whatever the split.
        try:
            for group in _pool_groups(num_actors):
                pools.append(
                    ProcessEnvPool(
                        env_factory=env_factory,
                        num_workers=len(group),
                        envs_per_worker=envs_per_actor,
                        obs_shape=example_obs.shape,
                        obs_dtype=example_obs.dtype,
                        base_seed=seed + 1000 * group[0],
                        first_env_index=group[0] * envs_per_actor,
                        mode=pool_mode,
                        ready_fraction=pool_ready_fraction,
                    )
                )
        except BaseException:
            # A failed later pool must not leak the earlier pools' workers
            # and shared memory.
            for pool in pools:
                pool.close()
            raise
    ring = learner.traj_ring
    try:
        if ring is not None:
            # Each unroll cycle fills whole column blocks of one slot:
            # checked here, where the fleet's shapes are known, so a bad
            # combination fails at start-up instead of wedging the ring.
            B = learner_config.batch_size
            counts = {p.num_envs for p in pools} if pools else {envs_per_actor}
            for E in sorted(counts):
                if E > B or B % E:
                    raise ValueError(
                        f"traj_ring: actor env count {E} must divide batch_size {B} "
                        "(each unroll cycle fills whole column blocks of one batch slot)"
                    )
        actors = []
        for slot in range(len(pools) if pools else num_actors):
            base_seed = seed + 1000 * (slot + 1)
            if pools:
                envs = pools[slot]
            else:
                envs = [
                    call_env_factory(env_factory, base_seed + j, slot * envs_per_actor + j)
                    for j in range(envs_per_actor)
                ]
            actors.append(
                VectorActor(
                    actor_id=slot,
                    envs=envs,
                    agent=agent,
                    param_store=learner.param_store,
                    enqueue=learner.enqueue,
                    unroll_length=learner_config.unroll_length,
                    device=device,
                    seed=base_seed,
                    on_episode_return=on_episode_return,
                    traj_ring=ring,
                )
            )
        stop_event = threading.Event()
        threads = [
            threading.Thread(target=actor.run, args=(stop_event,), name=f"actor-{i}", daemon=True)
            for i, actor in enumerate(actors)
        ]
        for th in threads:
            th.start()

        def watchdog() -> None:
            # No batch for a second: fail loudly if an actor died.
            for i, actor in enumerate(actors):
                if actor.error is not None:
                    raise RuntimeError(f"actor {i} failed") from actor.error

        try:
            learner.run(total_steps, stop_event, watchdog=watchdog)
        finally:
            stop_event.set()
            # Actors blocked in enqueue or acquire see the stop within 0.5 s
            # (QueueClosed).
            learner.stop()
            for th in threads:
                th.join(timeout=30.0)
            learner.join()
    finally:
        # After the actor threads: a pool is closed only once nothing
        # steps it.
        pool_pids = [pid for pool in pools for pid in pool.pids]
        pool_shm_names = [pool.shm_name for pool in pools]
        for pool in pools:
            pool.close()
    # An actor that failed while the others kept the learner fed.
    watchdog()
    with returns_lock:
        returns = list(episode_returns)
    return TrainResult(
        episode_returns=returns,
        final_logs=dict(step_logs),
        learner=learner,
        num_frames=learner.num_frames,
        pool_pids=pool_pids,
        pool_shm_names=pool_shm_names,
    )
