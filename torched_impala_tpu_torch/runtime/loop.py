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
With `learner_config.steps_per_dispatch` = K the learner takes K steps a
dispatch: the post-step hooks (checkpoint saves, chaos, `on_learner_step`)
run once a dispatch with the step count, and a budget that K does not
divide runs its largest multiple of K, with a warning (`Learner.run`).

Actors run under an `ActorSupervisor` (runtime/supervisor.py): an actor
that dies with an error is rebuilt after a backoff, within
`max_actor_restarts` a slot; a process-mode actor attaches again to its
live pool, and each pool repairs its own dead workers within
`max_actor_restarts` x its worker count. The run fails only when every
actor is dead and none can be restarted ("all actor threads are dead and
unrecoverable"). `TrainResult.actor_restarts` counts both kinds.

Checkpoint and resume (resilience/, utils/checkpoint.py):

- `async_checkpointer` (a `resilience.AsyncCheckpointer`) takes the
  interval saves: a post-step hook hands an on-device clone of the state
  (`Learner.get_state_device`) to its writer thread when a save is due,
  so the loop never waits on the disk; its cadence counts from the step the
  run starts at. `checkpointer` (a synchronous `utils.checkpoint.
  Checkpointer`) saves every `checkpoint_interval` steps instead when
  there is no async checkpointer. Each writes a final save on a clean
  finish; a crash leaves the last interval save.
- `resume` ("auto" or True) restores, before any actor starts, the newer
  of the two backends by step: the async checkpointer's manifests (the
  config hash checked against `config_hash`, a corrupt newest checkpoint
  skipped for the one before) or the synchronous checkpointer's files.
  `Learner.set_state` republishes the params at the restored frame
  count, and `total_steps` counts the restored steps.
- `chaos` (a `resilience.ChaosPlan`, a list of `Fault`s or a
  `ChaosInjector`) arms the fault hooks of the pools, the actors' unroll
  starts, the enqueue, the learner's post-step and the async
  checkpointer's writer (resilience/chaos.py).

`learner_config.loss.health_diagnostics=True` stands up the
training-health plane (telemetry/health.py): the step's health_* logs
become `health/*` gauges of the global registry at each log interval,
the burn-rate health alerts run over them, and an alert's firing or a
learner crash writes a postmortem bundle under `postmortem_dir`.
"""

from __future__ import annotations

import collections
import dataclasses
import sys
import threading
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from torched_impala_tpu_torch.device import resolve_device
from torched_impala_tpu_torch.envs.factory import call_env_factory
from torched_impala_tpu_torch.models.agent import Agent
from torched_impala_tpu_torch.optim import RMSProp
from torched_impala_tpu_torch.resilience import recovery
from torched_impala_tpu_torch.resilience.chaos import ChaosInjector, ChaosPlan
from torched_impala_tpu_torch.resilience.checkpointer import AsyncCheckpointer
from torched_impala_tpu_torch.runtime.learner import Learner, LearnerConfig
from torched_impala_tpu_torch.runtime.supervisor import ActorSupervisor
from torched_impala_tpu_torch.runtime.vector_actor import VectorActor
from torched_impala_tpu_torch.telemetry import HealthMonitor, PostmortemWriter, get_registry
from torched_impala_tpu_torch.utils.checkpoint import Checkpointer


@dataclasses.dataclass
class TrainResult:
    episode_returns: list  # (actor_id, return, length) in completion order
    final_logs: Mapping[str, Any]
    learner: Learner
    num_frames: int
    # Supervisor restarts of actors plus the pools' worker restarts.
    actor_restarts: int = 0
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


def _restore(learner, *, checkpointer, async_checkpointer, config_hash, batch_size) -> None:
    """Restore the newest state of the two backends into `learner` (the
    async checkpointer's manifests against the synchronous checkpointer's
    files, by step); nothing when neither holds a checkpoint."""
    restored, restored_step = None, -1
    if async_checkpointer is not None:
        found = recovery.restore_latest(
            async_checkpointer.directory,
            learner.get_state(),
            config_hash=config_hash,
            host_count=1,
            global_batch_size=batch_size,
        )
        if found is not None:
            manifest, restored = found
            restored_step = manifest.step
            print(
                f"[resume] manifest @ step {manifest.step} (param_version "
                f"{manifest.param_version}) from {async_checkpointer.directory}",
                file=sys.stderr,
                flush=True,
            )
    if checkpointer is not None:
        step = checkpointer.latest_step()
        if step is not None and step > restored_step:
            restored = checkpointer.restore(learner.get_state(), step)
            print(
                f"[resume] checkpoint @ step {step} from {checkpointer.directory}",
                file=sys.stderr,
                flush=True,
            )
    if restored is not None:
        learner.set_state(restored)


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
    checkpointer: Optional[Checkpointer] = None,
    checkpoint_interval: int = 0,
    resume=False,
    async_checkpointer: Optional[AsyncCheckpointer] = None,
    config_hash: Optional[str] = None,
    chaos=None,
    max_actor_restarts: Optional[int] = 10,
    on_learner_step: Optional[Callable[[int], None]] = None,
    postmortem_dir: str = "postmortems",
) -> TrainResult:
    """Run the actor-learner loop until `total_steps` TOTAL learner
    updates, restored progress included: a resumed run takes only the
    remainder, so the lr schedule and the frame budget stay those of one
    uninterrupted run.

    `device=None` is the CUDA card (raises without one); pass "cpu" for
    the plain PyTorch path. In process mode the env factory must be
    picklable (`configs.make_env_factory`'s is). `on_learner_step(n)` is
    called once with the starting (maybe restored) step and after every
    learner dispatch (every step at K = 1). Checkpoint, resume and chaos:
    module docstring."""
    if actor_mode not in ("thread", "process"):
        raise ValueError(f"unknown actor_mode {actor_mode!r}")
    if pool_mode not in ("lockstep", "async"):
        raise ValueError(f"unknown pool_mode {pool_mode!r}")
    device = resolve_device(device)
    episode_returns: collections.deque = collections.deque(maxlen=10_000)
    returns_lock = threading.Lock()
    pools: list = []
    supervisor: Optional[ActorSupervisor] = None

    def on_episode_return(actor_id: int, ret: float, length: int) -> None:
        with returns_lock:
            episode_returns.append((actor_id, ret, length))

    step_logs: dict = {}

    def learner_logger(logs: Mapping[str, Any]) -> None:
        merged = dict(logs)
        merged["actor_restarts"] = supervisor.restarts if supervisor is not None else 0
        merged["pool_restarts"] = sum(pool.restarts for pool in pools)
        step_logs.update(merged)
        if logger is not None:
            with returns_lock:
                recent = [r for _, r, _ in list(episode_returns)[-100:]]
            merged["episode_return_mean"] = (
                float(np.mean(recent)) if recent else float("nan")
            )
            logger(merged)

    injector = None
    if chaos is not None:
        if isinstance(chaos, ChaosInjector):
            injector = chaos
        else:
            injector = ChaosInjector(chaos if isinstance(chaos, ChaosPlan) else ChaosPlan(chaos))
        if async_checkpointer is not None:
            injector.install(checkpointer=async_checkpointer)

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
    if learner_config.loss.health_diagnostics:
        # Only with the step's health logs; otherwise the learner keeps no
        # monitor and its log-interval branch is the logger's alone.
        learner.attach_health(
            HealthMonitor(registry=get_registry(), postmortem=PostmortemWriter(postmortem_dir))
        )
    if resume:
        # Before any actor starts: they first see the restored params.
        _restore(
            learner,
            checkpointer=checkpointer,
            async_checkpointer=async_checkpointer,
            config_hash=config_hash,
            batch_size=learner_config.batch_size,
        )

    post_hooks: list = []
    if async_checkpointer is not None:
        # Interval saves through the background writer: the hook clones
        # the state on the device when a save is due, nothing more.
        async_checkpointer.anchor(learner.num_steps)

        def async_checkpoint_hook(num_steps: int) -> None:
            async_checkpointer.maybe_save(
                num_steps, learner.get_state_device, param_version=learner.num_frames
            )

        post_hooks.append(async_checkpoint_hook)
    elif checkpointer is not None and checkpoint_interval > 0:
        last_saved = [learner.num_steps]

        def checkpoint_hook(num_steps: int) -> None:
            # On the learner thread, between steps: a consistent state.
            if num_steps - last_saved[0] >= checkpoint_interval:
                checkpointer.save(num_steps, learner.get_state())
                last_saved[0] = num_steps

        post_hooks.append(checkpoint_hook)
    if injector is not None:
        post_hooks.append(injector.learner_hook)
    if on_learner_step is not None:
        post_hooks.append(on_learner_step)
        on_learner_step(learner.num_steps)
    # Learner.run takes the largest multiple of K of these, so a resumed
    # run never overshoots total_steps either.
    remaining_steps = max(0, total_steps - learner.num_steps)

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
                        max_restarts=(
                            max_actor_restarts * len(group)
                            if max_actor_restarts is not None
                            else 1_000_000
                        ),
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
    enqueue = learner.enqueue
    actor_chaos = None
    if injector is not None:
        enqueue = injector.wrap_enqueue(learner.enqueue)
        actor_chaos = injector.actor_hook
        injector.install(pools=pools)
    stop_event = threading.Event()
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

        def make_actor(slot: int) -> VectorActor:
            # Fresh envs at every (re)spawn; a process-mode actor attaches
            # to its live pool, which repairs its own workers.
            base_seed = seed + 1000 * (slot + 1)
            if pools:
                envs = pools[slot]
            else:
                envs = [
                    call_env_factory(env_factory, base_seed + j, slot * envs_per_actor + j)
                    for j in range(envs_per_actor)
                ]
            return VectorActor(
                actor_id=slot,
                envs=envs,
                agent=agent,
                param_store=learner.param_store,
                enqueue=enqueue,
                unroll_length=learner_config.unroll_length,
                device=device,
                seed=base_seed,
                on_episode_return=on_episode_return,
                traj_ring=ring,
                chaos=actor_chaos,
            )

        def on_restart(slot: int, error: BaseException) -> None:
            # stderr: this runs on the monitor thread.
            print(
                f"[supervisor] restarting actor {slot} "
                f"(restart #{supervisor.restarts}): {error!r}",
                file=sys.stderr,
                flush=True,
            )

        supervisor = ActorSupervisor(
            make_actor=make_actor,
            num_actors=len(pools) if pools else num_actors,
            stop_event=stop_event,
            max_restarts_per_actor=max_actor_restarts,
            on_restart=on_restart,
        )
        supervisor.start()

        def watchdog() -> None:
            # No batch for a second: fail only when every slot is dead and
            # no restart can revive one.
            if supervisor.alive_count() == 0 and not supervisor.can_recover():
                errors = supervisor.errors()
                detail = f"first actor error: {errors[0]!r}" if errors else "no recorded errors"
                raise RuntimeError(
                    f"all actor threads are dead and unrecoverable "
                    f"({supervisor.restarts} restarts performed); {detail}"
                ) from (errors[0] if errors else None)

        try:
            learner.run(remaining_steps, stop_event, watchdog=watchdog, post_step=post_hooks)
        finally:
            stop_event.set()
            # Actors blocked in enqueue or acquire see the stop within 0.5 s
            # (QueueClosed).
            learner.stop()
            supervisor.join(timeout_per_thread=30.0)
            learner.join()
    finally:
        stop_event.set()
        # After the actor threads: a pool is closed only once nothing
        # steps it.
        pool_pids = [pid for pool in pools for pid in pool.pids]
        pool_shm_names = [pool.shm_name for pool in pools]
        for pool in pools:
            pool.close()
    # Final saves only on a clean finish: after a crash (a real one or a
    # chaos crash_learner) resume starts from the last interval save.
    if async_checkpointer is not None:
        async_checkpointer.save_now(
            learner.num_steps, learner.get_state(), param_version=learner.num_frames
        )
        async_checkpointer.wait()
    if checkpointer is not None:
        checkpointer.save(learner.num_steps, learner.get_state())
        checkpointer.wait()
    with returns_lock:
        returns = list(episode_returns)
    return TrainResult(
        episode_returns=returns,
        final_logs=dict(step_logs),
        learner=learner,
        num_frames=learner.num_frames,
        actor_restarts=supervisor.restarts + sum(pool.restarts for pool in pools),
        pool_pids=pool_pids,
        pool_shm_names=pool_shm_names,
    )
