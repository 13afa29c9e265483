"""The learner: batcher thread, SGD step, param publication (counterpart of
`torched_impala_tpu/runtime/learner.py:Learner` on its single-device,
queue-fed path).

Actors `enqueue` single-env `Trajectory`s; a batcher thread collects B of
them, stacks them time-major (`stack_trajectories`), moves the batch to
the learner's device and hands it over through a bounded queue (double
buffering). `step_once` takes one batch and one SGD step:

    unroll the net over [T+1, B] from the batch's start state ->
    impala_loss (V-trace on the device: the CUDA kernel on the card; with
    fused_epilogue, the fused V-trace + loss-sums kernel instead) ->
    backward -> global-norm clip
    scale = min(1, max_grad_norm / (||g|| + 1e-8)) -> RMSProp

then publishes the params for the actors. The clip
formula is the JAX learner's exactly; `torch.nn.utils.clip_grad_norm_`
adds 1e-6 instead and is not used. `max_grad_norm=None` skips the clip
and takes the unclipped step, as the JAX learner does.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from torched_impala_tpu_torch.models.agent import Agent
from torched_impala_tpu_torch.ops import precision
from torched_impala_tpu_torch.ops.losses import ImpalaLossConfig, impala_loss
from torched_impala_tpu_torch.optim import RMSProp
from torched_impala_tpu_torch.runtime.param_store import ParamStore
from torched_impala_tpu_torch.runtime.types import QueueClosed, Trajectory, map_state


@dataclasses.dataclass(frozen=True)
class LearnerConfig:
    batch_size: int = 8
    unroll_length: int = 20
    loss: ImpalaLossConfig = ImpalaLossConfig()
    # IMPALA paper's global-norm clip; None takes unclipped steps.
    max_grad_norm: Optional[float] = 40.0
    # Call the logger every N steps; converting the logs to floats waits
    # for the device, so keep this > 1 for throughput runs.
    log_interval: int = 1


def stack_trajectories(trajs: list[Trajectory]) -> Trajectory:
    """Stack B unrolls into one time-major batch: leaves `[T(+1), B, ...]`;
    the agent_state leaves (batch 1 each) concatenate on axis 0, keeping
    the state's type."""
    return Trajectory(
        obs=np.stack([t.obs for t in trajs], axis=1),
        first=np.stack([t.first for t in trajs], axis=1),
        actions=np.stack([t.actions for t in trajs], axis=1),
        behaviour_logits=np.stack([t.behaviour_logits for t in trajs], axis=1),
        rewards=np.stack([t.rewards for t in trajs], axis=1),
        cont=np.stack([t.cont for t in trajs], axis=1),
        agent_state=map_state(
            lambda *leaves: np.concatenate(leaves, axis=0),
            *(t.agent_state for t in trajs),
        ),
        actor_id=-1,
        param_version=min(t.param_version for t in trajs),
    )


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


class Learner:
    """Single-device learner over the agent's net (the master params)."""

    def __init__(
        self,
        *,
        agent: Agent,
        optimizer: RMSProp,
        config: LearnerConfig,
        device: torch.device,
        logger: Optional[Callable[[Mapping[str, Any]], None]] = None,
    ) -> None:
        self._agent = agent
        self._optimizer = optimizer
        self._config = config
        self._device = torch.device(device)
        self._logger = logger
        agent.net.to(self._device)
        self._params = dict(agent.net.named_parameters())
        optimizer.init(self._params)
        precision.assert_f32_accumulators(
            {
                "master_params": self._params.values(),
                "optimizer_state": optimizer.nu.values(),
            },
            context="Learner.__init__",
        )
        self.num_frames = 0
        self.num_steps = 0
        self.last_batch_device: Optional[torch.device] = None
        # Actors may lead by two batches; two device batches in flight
        # (double buffering).
        self._traj_q: queue.Queue = queue.Queue(maxsize=2 * config.batch_size)
        self._batch_q: queue.Queue = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self._batcher_thread: Optional[threading.Thread] = None
        # A batcher failure is re-raised from step_once (single writer).
        self.error: Optional[BaseException] = None
        self._wait_accum = 0.0
        self._last_log_t: Optional[float] = None
        self._last_log_frames = 0
        self.param_store = ParamStore()
        self._publish()

    # ---- feeding -------------------------------------------------------

    def enqueue(self, traj: Trajectory) -> None:
        """Called by actors; blocks while the learner is behind, raises
        QueueClosed after `stop()`."""
        while True:
            if self._stop.is_set():
                raise QueueClosed()
            try:
                self._traj_q.put(traj, timeout=0.5)
                return
            except queue.Full:
                continue

    def _collect(self) -> Optional[list[Trajectory]]:
        trajs: list[Trajectory] = []
        while len(trajs) < self._config.batch_size:
            if self._stop.is_set():
                return None
            try:
                trajs.append(self._traj_q.get(timeout=0.5))
            except queue.Empty:
                continue
        return trajs

    def _to_device(self, batch: Trajectory) -> tuple:
        dev = self._device

        def put(x: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(x).to(dev, non_blocking=True)

        return (
            put(batch.obs),
            put(batch.first),
            put(batch.actions.astype(np.int64)),
            put(batch.behaviour_logits),
            put(batch.rewards),
            put(batch.cont),
            map_state(put, batch.agent_state),
        )

    def _batcher_loop(self) -> None:
        try:
            while not self._stop.is_set():
                trajs = self._collect()
                if trajs is None:
                    return
                batch = stack_trajectories(trajs)
                item = (self._to_device(batch), batch.param_version)
                while not self._stop.is_set():
                    try:
                        self._batch_q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 - surfaced via step_once
            self.error = e
            raise

    def start(self) -> None:
        if self._batcher_thread is None:
            self._batcher_thread = threading.Thread(
                target=self._batcher_loop, name="batcher", daemon=True
            )
            self._batcher_thread.start()

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: float = 10.0) -> None:
        if self._batcher_thread is not None:
            self._batcher_thread.join(timeout)

    # ---- stepping ------------------------------------------------------

    def _publish(self) -> None:
        self.param_store.publish(self.num_frames, self._params)

    def train_step(self, arrays: tuple) -> dict[str, torch.Tensor]:
        """One SGD step on a device batch (`_to_device`'s tuple: the six
        trajectory arrays and the start state); returns device-scalar logs."""
        obs, first, actions, behaviour_logits, rewards, cont, state = arrays
        cfg = self._config
        net_out, _ = self._agent.unroll(obs, first, state)
        values = net_out.values[..., 0]  # [T+1, B]
        out = impala_loss(
            target_logits=net_out.policy_logits[:-1],
            behaviour_logits=behaviour_logits,
            values=values[:-1],
            bootstrap_value=values[-1],
            actions=actions,
            rewards=rewards,
            discounts=cfg.loss.discount * cont,
            config=cfg.loss,
        )
        names = list(self._params)
        grads = torch.autograd.grad(out.total, [self._params[k] for k in names])
        grad_norm = global_norm(grads)
        if cfg.max_grad_norm is not None:
            scale = torch.clamp(cfg.max_grad_norm / (grad_norm + 1e-8), max=1.0)
            grads = [g * scale for g in grads]
        self._optimizer.step(self._params, dict(zip(names, grads)))
        logs = {k: v.detach() for k, v in out.logs.items()}
        logs["grad_norm_unclipped"] = grad_norm.detach()
        with torch.no_grad():
            logs["weight_norm"] = global_norm(self._params.values())
        return logs

    def step_once(self, timeout: Optional[float] = None) -> Mapping[str, Any]:
        """Block for one device batch, take one SGD step, publish params.
        Raises queue.Empty on timeout."""
        if self.error is not None:
            raise RuntimeError("learner batcher thread died") from self.error
        t0 = time.monotonic()
        try:
            arrays, batch_version = self._batch_q.get(timeout=timeout)
        finally:
            self._wait_accum += time.monotonic() - t0
        self.last_batch_device = arrays[0].device
        logs = self.train_step(arrays)
        cfg = self._config
        self.num_frames += cfg.unroll_length * cfg.batch_size
        self.num_steps += 1
        logs["num_frames"] = self.num_frames
        logs["num_steps"] = self.num_steps
        logs["param_lag_frames"] = self.num_frames - batch_version
        self._publish()
        if self._logger is not None and self.num_steps % cfg.log_interval == 0:
            now = time.monotonic()
            if self._last_log_t is not None:
                elapsed = max(now - self._last_log_t, 1e-9)
                logs["frames_per_sec"] = (
                    self.num_frames - self._last_log_frames
                ) / elapsed
                logs["batch_wait_frac"] = min(self._wait_accum / elapsed, 1.0)
            else:
                logs["frames_per_sec"] = float("nan")
                logs["batch_wait_frac"] = float("nan")
            self._last_log_t = now
            self._last_log_frames = self.num_frames
            self._wait_accum = 0.0
            self._logger(
                {
                    k: float(v) if isinstance(v, torch.Tensor) else v
                    for k, v in logs.items()
                }
            )
        return logs

    def run(
        self,
        max_steps: int,
        stop_event: Optional[threading.Event] = None,
        watchdog: Optional[Callable[[], None]] = None,
    ) -> None:
        """`max_steps` SGD steps, then stop. `watchdog` runs whenever no
        batch arrives within a second and should raise if the producers
        are dead."""
        self.start()
        steps = 0
        try:
            while steps < max_steps:
                if stop_event is not None and stop_event.is_set():
                    break
                try:
                    self.step_once(timeout=1.0)
                    steps += 1
                except queue.Empty:
                    if watchdog is not None:
                        watchdog()
        finally:
            self.stop()
            if stop_event is not None:
                stop_event.set()

    # ---- state ---------------------------------------------------------

    def get_state(self) -> dict:
        """Host copies of the params, optimizer state and counters."""
        opt = self._optimizer.state_dict()
        return {
            "params": {k: v.detach().cpu().clone() for k, v in self._params.items()},
            "opt_state": {
                "count": opt["count"],
                "nu": {k: v.cpu() for k, v in opt["nu"].items()},
            },
            "num_frames": self.num_frames,
            "num_steps": self.num_steps,
        }

    def set_state(self, state: Mapping[str, Any]) -> None:
        """Restore a `get_state()` dict and republish the params."""
        precision.assert_f32_accumulators(
            {"optimizer_state": state["opt_state"]["nu"].values()},
            context="Learner.set_state",
        )
        with torch.no_grad():
            for k, v in state["params"].items():
                self._params[k].copy_(v)
        self._optimizer.load_state_dict(state["opt_state"])
        self.num_frames = int(state["num_frames"])
        self.num_steps = int(state["num_steps"])
        self._publish()

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return self._params
