"""Experiment wiring: N actor threads + one learner (counterpart of
`torched_impala_tpu/runtime/loop.py:train`, thread actors only).

`train()` builds the learner on `device`, starts `num_actors` actor
threads that each step `envs_per_actor` envs with batched inference on
the same device, and runs the learner for `total_steps` updates. There is
no actor supervisor yet: the first actor error stops the run and is
raised.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from torched_impala_tpu_torch.device import resolve_device
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
    seed: int = 0,
    device: str | torch.device | None = None,
    logger: Optional[Callable[[Mapping[str, Any]], None]] = None,
    log_every: int = 50,
) -> TrainResult:
    """Run the actor-learner loop for `total_steps` learner updates.

    `device=None` is the CUDA card (raises without one); pass "cpu" for
    the plain PyTorch path."""
    if actor_mode != "thread":
        raise NotImplementedError(
            f"actor_mode={actor_mode!r} is not ported yet; only 'thread' "
            "actors run (ROADMAP.md queue 1, item 5: the process env pool)"
        )
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

    learner = Learner(
        agent=agent,
        optimizer=optimizer,
        config=dataclasses.replace(learner_config, log_interval=log_every),
        device=device,
        logger=learner_logger,
    )
    actors = []
    for slot in range(num_actors):
        base_seed = seed + 1000 * (slot + 1)
        envs = [
            env_factory(base_seed + j, slot * envs_per_actor + j)
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
            )
        )
    stop_event = threading.Event()
    threads = [
        threading.Thread(
            target=actor.run, args=(stop_event,), name=f"actor-{i}", daemon=True
        )
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
        # Actors blocked in enqueue see the stop within 0.5 s (QueueClosed).
        learner.stop()
        for th in threads:
            th.join(timeout=30.0)
        learner.join()
    with returns_lock:
        returns = list(episode_returns)
    return TrainResult(
        episode_returns=returns,
        final_logs=dict(step_logs),
        learner=learner,
        num_frames=learner.num_frames,
    )
