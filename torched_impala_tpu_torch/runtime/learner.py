"""The learner: batcher thread, SGD step, param publication (counterpart of
`torched_impala_tpu/runtime/learner.py:Learner` on its single-device
path).

Two feeds. The queue feed: actors `enqueue` single-env `Trajectory`s; a
batcher thread collects B of them, stacks them time-major
(`stack_trajectories`), moves the batch to the learner's device and hands
it over through a bounded queue (double buffering). The ring feed
(`LearnerConfig.traj_ring`): actors write their unrolls straight into the
batch slots of a `TrajectoryRing`, and the batcher copies each completed
slot to the device as it is (`_ring_batcher_loop`). `step_once` takes one
batch and one SGD step (K of them with `steps_per_dispatch`, below):

    unroll the net over [T+1, B] from the batch's start state ->
    impala_loss (V-trace on the device: the CUDA kernel on the card; with
    fused_epilogue, the fused V-trace + loss-sums kernel instead) ->
    backward -> global-norm clip
    scale = min(1, max_grad_norm / (||g|| + 1e-8)) -> RMSProp

then publishes the params for the actors every `publish_interval`
steps. The clip formula is the JAX learner's exactly;
`torch.nn.utils.clip_grad_norm_` adds 1e-6 instead and is not used.
`max_grad_norm=None` skips the clip and takes the unclipped step, as the
JAX learner does. The norms, the clip and the optimizer are multi-tensor
ops over the params' list (`torch._foreach_*`), a few launches a step
whatever the number of tensors.

With `grad_accum=G > 1` the batch is split into G microbatches of B/G
columns, in JAX's order (microbatch g is columns g*B/G ... (g+1)*B/G - 1
of every `[T(+1), B, ...]` array and rows of the `[B, ...]` start
state). Each runs unroll, loss and `torch.autograd.grad` in turn, its
graph freed before the next is built, and its grads are summed into one
f32 accumulator list (divided by G for reduction="mean"); then one clip
and one optimizer step. Only one microbatch's activations are alive at a
time: the memory lever of JAX's microbatch scan.

With `steps_per_dispatch=K > 1` (JAX's K-step dispatch) one batch is a
`[K, T+1, B, ...]` superbatch: the queue feed's batcher collects K rounds
of B unrolls and stacks each in place into its `[k]` slice of one host
buffer (`_assemble_superbatch`), or the ring's superbatch slot already is
one; one host-to-device copy moves it, and `train_dispatch` takes K
`train_step`s over its slices back to back, with no host sync between
them (grad_accum nests inside each). The counters advance by K steps and
K*T*B frames a dispatch, and publish and log fire on the dispatch that
crosses their interval (`crossed_interval`). JAX's chunked fallback
(`_run_fused_chunked`: a K > 4 superbatch dispatched in chunks of 4,
because XLA on the TPU refuses its layouts) is not ported: nothing here
refuses a K.

With `donate_batch` and the ring, a slot lives until the step that
consumed it has finished, not only until its copy: on the card the
learner records an event on the train step's stream after the K-th step
and hands (slot, event) back to the batcher, which releases the slot once
the event has completed, without waiting for it; on the CPU the step
reads the slot itself (no staging clone) and hands it back when it
returns.

With `train_dtype="bfloat16"` (JAX's full-bf16 step) each `_grads`
lowers the f32 master params with `ops/precision.py:cast_to_compute`
and runs the unroll, the loss and the backward on them, bound into the
learner's own copy of the net (`models/nets.py:bound_params`; the actors
clone the agent's net, which is never rebound). The grads land on the
f32 masters with JAX's rounding: bf16-rounded for every param but the
LSTM cell's (`ImpalaNet.straight_through_params`), so the clip, RMSProp,
`grad_accum`, `steps_per_dispatch` and the ring see float32 as before.
The torso runs in bf16 (`configs.make_agent` forces it), the heads and
the LSTM core in float32 on the rounded values.

With the loss's `health_diagnostics` each step's logs carry JAX's
training-health keys: the loss's (ops/losses.py:health_diagnostics_logs,
averaged over microbatches as every per-step log is) and the step's own,
each param group's clipped grad norm and update-to-weight ratio
(`_health_step_logs`; under K > 1 the last step's, as every log). A
`telemetry.health.HealthMonitor` attached by `attach_health` gets each
log interval's floats and a crash of `run`. JAX's PopArt drift keys come
with PopArt (ROADMAP.md queue 1: DMLab-30) and its replay step's health
logs with replay (Replay).
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import queue
import re
import sys
import threading
import time
import warnings
from typing import Any, Callable, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch

from torched_impala_tpu_torch.models.agent import Agent
from torched_impala_tpu_torch.models.nets import bound_params
from torched_impala_tpu_torch.ops import precision
from torched_impala_tpu_torch.ops.losses import (
    SUM_REDUCED_LOG_KEYS,
    ImpalaLossConfig,
    impala_loss,
)
from torched_impala_tpu_torch.optim import RMSProp
from torched_impala_tpu_torch.runtime.param_store import ParamStore
from torched_impala_tpu_torch.runtime.traj_ring import TrajectoryRing
from torched_impala_tpu_torch.runtime.types import (
    QueueClosed,
    Trajectory,
    crossed_interval,
    map_state,
)
from torched_impala_tpu_torch.utils.checkpoint import validate_restored_shapes


@dataclasses.dataclass(frozen=True)
class LearnerConfig:
    batch_size: int = 8
    unroll_length: int = 20
    loss: ImpalaLossConfig = ImpalaLossConfig()
    # IMPALA paper's global-norm clip; None takes unclipped steps.
    max_grad_norm: Optional[float] = 40.0
    # Publish the params to the actors every N steps (1 = every step);
    # `set_state` republishes at once whatever N.
    publish_interval: int = 1
    # Call the logger every N steps; converting the logs to floats waits
    # for the device, so keep this > 1 for throughput runs.
    log_interval: int = 1
    # Host trajectory queue capacity in unrolls (bounds the actors' lead);
    # None = 2 * batch_size.
    queue_capacity: Optional[int] = None
    # Device batch queue depth; 2 = double buffering. The trajectory
    # ring's slots are this many in flight, one filling and one spare.
    device_queue_depth: int = 2
    # Sum the grads of G microbatches of batch_size / G columns before one
    # optimizer step (module docstring): the activations of one microbatch
    # are alive at a time, and the update is the full batch's. batch_size
    # must divide by G.
    grad_accum: int = 1
    # The trajectory ring (runtime/traj_ring.py): vectorized actors write
    # unrolls straight into [T+1, B, ...] batch slots (pinned host memory
    # on the card) and the batcher copies a completed slot to the device
    # on a side stream, with no host stacking. Every actor's env count
    # must divide batch_size (loop.train checks). With steps_per_dispatch
    # K > 1 the slots are superbatch slots, [K, T+1, B, ...].
    traj_ring: bool = False
    # K SGD steps a dispatch on a [K, T+1, B, ...] superbatch (module
    # docstring). Params publish and logs land on the dispatch that crosses
    # their interval, so the actors may lag up to K - 1 more updates, and
    # the ring's slots wait for K*B columns. K >= 1.
    steps_per_dispatch: int = 1
    # The ring slot is the step's own input and is released only after the
    # step that consumed it (module docstring); the ring gets two more slots
    # for the longer hold. On the queue feed the device batch already
    # belongs to the step, and this changes nothing. Results are bit for
    # bit those without it. JAX also refuses it with data_device and with
    # replay, which the port has not yet (ROADMAP.md queue 1: Feed-path and
    # layout options; Replay): add both refusals when they land.
    donate_batch: bool = False
    # The train step's compute dtype (JAX's full-bf16 step): "bfloat16"
    # lowers the f32 master params to bf16 inside the differentiated
    # closure (module docstring); the grads, the RMSProp moments and the
    # master params stay float32. "float32" is the plain step.
    train_dtype: str = "float32"


class BatchLineage(NamedTuple):
    """Provenance of one batch as the health monitor sees it (JAX's
    `runtime/learner.py:BatchLineage`, same fields): `batch` is the
    learner's dispatch sequence number; `lineage` and `versions` (the
    consumed unrolls' lineage IDs and param versions) stay empty, since
    the port's feed carries only the batch's least version; replay's
    `reuse_count` and `staleness` keep their fresh-batch values, 1 and 0;
    `ring_slot` is the donated ring slot, -1 for none."""

    batch: int
    lineage: tuple = ()
    versions: tuple = ()
    reuse_count: int = 1
    staleness: int = 0
    ring_slot: int = -1


# Sanitizer of module names -> health gauge sub-keys
# (`health/grad_norm_<group>` must satisfy the registry's NAME_RE).
_HEALTH_GROUP_RE = re.compile(r"[^a-z0-9_]+")


def health_param_groups(names) -> dict[str, list[int]]:
    """The per-layer-group health gauges' groups of a net's param names:
    one group per top-level module (the name's first component, flax's
    top-level module name, since the port keeps flax's names), in
    first-seen order, named as JAX's `_health_param_groups` names them
    (lower case, runs of other characters as `_`, "group" if nothing is
    left, `_2`, `_3`, ... on collisions); each maps to the indices of its
    params in `names`."""
    modules: dict[str, list[int]] = {}
    for i, name in enumerate(names):
        modules.setdefault(name.split(".", 1)[0], []).append(i)
    out: dict[str, list[int]] = {}
    for key, idx in modules.items():
        group = _HEALTH_GROUP_RE.sub("_", key.lower()).strip("_") or "group"
        base, n = group, 1
        while group in out:
            n += 1
            group = f"{base}_{n}"
        out[group] = idx
    return out


def stack_trajectories(trajs: list[Trajectory], out: Optional[Trajectory] = None) -> Trajectory:
    """Stack B unrolls into one time-major batch: leaves `[T(+1), B, ...]`;
    the agent_state leaves (batch 1 each) concatenate on axis 0, keeping
    the state's type.

    `out` (preallocated arrays or views of the result's shapes) takes the
    stack in place: the K-step batcher passes the `[k]` slices of its
    `[K, ...]` superbatch, so each unroll is copied once."""
    if out is not None:
        for name in ("obs", "first", "actions", "behaviour_logits", "rewards", "cont"):
            np.stack([getattr(t, name) for t in trajs], axis=1, out=getattr(out, name))
        map_state(
            lambda dst, *leaves: np.concatenate(leaves, axis=0, out=dst),
            out.agent_state,
            *(t.agent_state for t in trajs),
        )
        return out._replace(actor_id=-1, param_version=min(t.param_version for t in trajs))
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


def alloc_stack_buffers(trajs: list[Trajectory], K: Optional[int] = None) -> Trajectory:
    """Empty arrays shaped and typed as `stack_trajectories(trajs)`' output,
    or with K a `[K, ...]` superbatch of K such batches (the trajectory
    ring's slots take these shapes)."""
    t0, B = trajs[0], len(trajs)
    lead = () if K is None else (K,)

    def stacked(x):
        return np.empty(lead + (x.shape[0], B) + x.shape[1:], x.dtype)

    return Trajectory(
        obs=stacked(t0.obs),
        first=stacked(t0.first),
        actions=stacked(t0.actions),
        behaviour_logits=stacked(t0.behaviour_logits),
        rewards=stacked(t0.rewards),
        cont=stacked(t0.cont),
        agent_state=map_state(
            lambda x: np.empty(lead + (B * x.shape[0],) + x.shape[1:], x.dtype), t0.agent_state
        ),
        actor_id=-1,
        param_version=0,
    )


def stack_superbatch(batches: list[Trajectory]) -> Trajectory:
    """Stack K batches on a new leading axis: leaves `[K, T(+1), B, ...]`,
    agent_state leaves `[K, B, ...]`; the param version is the least of
    the K. The reference the in-place assembly is tested against (it
    copies each batch a second time; the batcher stacks each round into
    its slice instead)."""
    return Trajectory(
        *(np.stack([b[i] for b in batches]) for i in range(6)),
        agent_state=map_state(lambda *leaves: np.stack(leaves), *(b.agent_state for b in batches)),
        actor_id=-1,
        param_version=min(b.param_version for b in batches),
    )


def superbatch_slice(arrays: tuple, k: int) -> tuple:
    """Batch k of a device superbatch (`_to_device`'s tuple with `[K, ...]`
    leaves): views, contiguous since k indexes the leading axis."""
    *tb, state = arrays
    return (*(x[k] for x in tb), map_state(lambda x: x[k], state))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), as
    multi-tensor ops: each tensor's 2-norm in one `_foreach_norm`, then the
    2-norm of those norms."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


def split_batch(arrays: tuple, grad_accum: int) -> list[tuple]:
    """`_to_device`'s tuple as `grad_accum` microbatches in JAX's order:
    microbatch g holds columns g*Bm ... (g+1)*Bm - 1 of every
    `[T(+1), B, ...]` array and those rows of every `[B, ...]` leaf of the
    start state (Bm = B / grad_accum), each contiguous."""
    *tb, state = arrays
    bm = tb[0].shape[1] // grad_accum
    return [
        (
            *(x[:, g * bm : (g + 1) * bm].contiguous() for x in tb),
            map_state(lambda x: x[g * bm : (g + 1) * bm].contiguous(), state),
        )
        for g in range(grad_accum)
    ]


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
        example_obs: Optional[np.ndarray] = None,
    ) -> None:
        """`example_obs` (one observation) shapes the trajectory ring's
        slots; it is needed only with `config.traj_ring`."""
        self._agent = agent
        self._optimizer = optimizer
        self._config = config
        self._device = torch.device(device)
        self._logger = logger
        K = config.steps_per_dispatch
        if K < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {K}")
        G = config.grad_accum
        if G < 1:
            raise ValueError(f"grad_accum must be >= 1, got {G}")
        if config.batch_size % G:
            raise ValueError(
                f"batch_size {config.batch_size} not divisible by grad_accum {G}"
            )
        precision.validate_compute_dtype("train_step", config.train_dtype)
        agent.net.to(self._device)
        self._params = dict(agent.net.named_parameters())
        # The bf16 step's net: private module objects over the master
        # params (the memo shares them, no copy), rebound to the lowered
        # masters around each `_grads` (module docstring).
        self._train_cast = None
        if config.train_dtype != "float32":
            self._train_cast = getattr(torch, config.train_dtype)
            self._train_net = copy.deepcopy(agent.net, {id(p): p for p in self._params.values()})
            self._straight_through = frozenset(agent.net.straight_through_params())
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
        # By default actors may lead by two dispatches' worth of unrolls (a
        # dispatch takes K*B), and two device batches are in flight (double
        # buffering).
        self._traj_q: queue.Queue = queue.Queue(
            maxsize=config.queue_capacity or 2 * config.batch_size * K
        )
        self._batch_q: queue.Queue = queue.Queue(maxsize=config.device_queue_depth)
        self._stop = threading.Event()
        self._batcher_thread: Optional[threading.Thread] = None
        # A batcher failure is re-raised from step_once (single writer).
        self.error: Optional[BaseException] = None
        self._wait_accum = 0.0
        self._last_log_t: Optional[float] = None
        self._last_log_frames = 0
        # Donated ring slots the learner has handed back, (slot, event
        # recorded after the consuming step or None), for the batcher.
        self._consumed: collections.deque = collections.deque()
        self._consumed_lock = threading.Lock()
        # The ring: the device queue's depth in slots in flight, one
        # filling and one spare, and two more under donate_batch, whose
        # slots are held through their step (JAX's count).
        self.traj_ring: Optional[TrajectoryRing] = None
        if config.traj_ring:
            if example_obs is None:
                raise ValueError("traj_ring needs example_obs to shape its slots")
            self.traj_ring = TrajectoryRing(
                num_slots=self._batch_q.maxsize + 2 + (2 if config.donate_batch else 0),
                unroll_length=config.unroll_length,
                batch_size=config.batch_size,
                example_obs=example_obs,
                num_actions=agent.net.num_actions,
                agent_state_example=agent.initial_state(1),
                pin_memory=self._device.type == "cuda",
                superbatch_k=K,
            )
        # The training-health plane: the groups of the per-group step logs
        # (with the loss's health_diagnostics) and the monitor that
        # `attach_health` binds (None: no monitor).
        self._health = None
        self._health_groups = None
        if config.loss.health_diagnostics:
            groups = health_param_groups(list(self._params))
            self._health_groups = list(groups)
            group_of = torch.empty(len(self._params), dtype=torch.long)
            for g, idx in enumerate(groups.values()):
                group_of[idx] = g
            self._health_group_of = group_of.to(self._device)
        self._batch_seq = 0
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

    def _assemble_superbatch(self, K: int) -> Optional[Trajectory]:
        """K rounds of B unrolls, each stacked in place into its `[k]`
        slice of one `[K, ...]` host superbatch, so each unroll is copied
        once (JAX's `_assemble_superbatch`); its param version is the
        least of the K rounds'. None once stopped."""
        sb, versions = None, []
        for k in range(K):
            trajs = self._collect()
            if trajs is None:
                return None
            if sb is None:
                sb = alloc_stack_buffers(trajs, K)
            view = Trajectory(
                *(x[k] for x in sb[:6]), agent_state=map_state(lambda x: x[k], sb.agent_state)
            )
            versions.append(stack_trajectories(trajs, out=view).param_version)
        return sb._replace(param_version=min(versions))

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

    def _push(self, item: tuple) -> bool:
        """Hand a device batch to the learner; False once stopped."""
        while not self._stop.is_set():
            try:
                self._batch_q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _batcher_loop(self) -> None:
        try:
            if self.traj_ring is not None:
                self._ring_batcher_loop()
                return
            K = self._config.steps_per_dispatch
            while not self._stop.is_set():
                if K == 1:
                    trajs = self._collect()
                    batch = None if trajs is None else stack_trajectories(trajs)
                else:
                    batch = self._assemble_superbatch(K)
                if batch is None:
                    return
                if not self._push((self._to_device(batch), batch.param_version, None, None)):
                    return
        except BaseException as e:  # noqa: BLE001 - surfaced via step_once
            self.error = e
            raise

    def _ring_batcher_loop(self) -> None:
        """The ring's consumer: a completed slot already is a batch, so it
        goes to the device as it is.

        On the card the slot's pinned buffers are copied with
        `non_blocking=True` on a side stream, and an event recorded after
        the copies goes with the batch: `step_once` makes the train step's
        stream wait on it. The slot is released only once its event has
        completed (`release_after_transfer`); until then the DMA may still
        read it. At most the device queue's depth of slots wait so, and
        each pass of the loop (a timed-out `pop_ready` too) returns the
        slots whose copies are done, so the writers get them back while
        the batcher waits for the next slot.

        On the CPU, `.to("cpu")` would alias the slot, and a recycled slot
        would overwrite a queued batch: each batch is staged through one
        owning copy instead, and the slot is released at once.

        With `donate_batch` the slot goes with its batch (the queue item's
        fourth element) and comes back from `step_once` once the step that
        consumed it has been queued; each pass releases the slots handed
        back whose events have completed (`_release_consumed`), never
        waiting for one. On the CPU the batch is the slot itself."""
        ring = self.traj_ring
        cuda = self._device.type == "cuda"
        donate = self._config.donate_batch
        copy_stream = torch.cuda.Stream(self._device) if cuda else None
        inflight: collections.deque = collections.deque()  # (slot, event)
        keep = self._batch_q.maxsize
        while not self._stop.is_set():
            # With copies in flight or slots to hand back, wake often.
            view = ring.pop_ready(timeout=0.01 if inflight or donate else 0.5)
            if view is not None and cuda:
                with torch.cuda.stream(copy_stream):
                    arrays = self._ring_to_device(view.tensors)
                    event = torch.cuda.Event()
                    event.record(copy_stream)
                if not donate:
                    inflight.append((view.slot, event))
            elif view is not None and donate:
                arrays, event = self._ring_to_device(view.tensors), None
            elif view is not None:
                owned = view.tensors
                owned = (*(t.clone() for t in owned[:6]), map_state(torch.clone, owned[6]))
                arrays = self._ring_to_device(owned)
                event = None
                ring.release(view.slot)
            # Slots whose copies are done go back on every pass; past the
            # queue's depth, wait for the oldest.
            while inflight and (len(inflight) > keep or inflight[0][1].query()):
                ring.release_after_transfer(*inflight.popleft())
            if donate:
                self._release_consumed()
            donated = view.slot if view is not None and donate else None
            if view is not None and not self._push((arrays, view.param_version, event, donated)):
                return

    def _hand_back(self, slot: int, consumed: Optional[torch.cuda.Event]) -> None:
        """A donated slot back to the batcher (learner thread), with the
        event recorded after the step that consumed it (None: the step has
        finished)."""
        with self._consumed_lock:
            self._consumed.append((slot, consumed))

    def _release_consumed(self) -> None:
        """Release the handed-back slots whose steps have finished, in
        order (the steps run in order on one stream); never waits."""
        done = []
        with self._consumed_lock:
            while self._consumed and (
                self._consumed[0][1] is None or self._consumed[0][1].query()
            ):
                done.append(self._consumed.popleft()[0])
        for slot in done:
            self.traj_ring.release(slot)

    def _ring_to_device(self, tensors: tuple) -> tuple:
        """A slot's tensors as the train step's tuple on the device (the
        copies are enqueued on the current stream; actions widen to int64
        there)."""
        obs, first, actions, logits, rewards, cont, state = tensors

        def put(x: torch.Tensor) -> torch.Tensor:
            return x.to(self._device, non_blocking=True)

        return (
            put(obs), put(first), put(actions).long(), put(logits), put(rewards),
            put(cont), map_state(put, state),
        )

    def start(self) -> None:
        if self._batcher_thread is None:
            self._batcher_thread = threading.Thread(
                target=self._batcher_loop, name="batcher", daemon=True
            )
            self._batcher_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self.traj_ring is not None:
            # Actors blocked in acquire raise QueueClosed and exit.
            self.traj_ring.close()

    def join(self, timeout: float = 10.0) -> None:
        if self._batcher_thread is not None:
            self._batcher_thread.join(timeout)

    # ---- stepping ------------------------------------------------------

    def _publish(self) -> None:
        self.param_store.publish(self.num_frames, self._params)

    def _grads(self, arrays: tuple) -> tuple[list[torch.Tensor], dict]:
        """Unroll, loss and `torch.autograd.grad` on one (micro)batch: the
        grads in the params' order and the loss's device-scalar logs. The
        graph is freed on return."""
        if self._train_cast is None:
            return self._grads_on(self._agent.net, arrays)
        lowered = precision.cast_to_compute(
            self._params, self._train_cast, self._straight_through
        )
        # Bound through the backward too: a rematerialized torso runs its
        # forward again there.
        with bound_params(self._train_net, lowered):
            return self._grads_on(self._train_net, arrays)

    def _grads_on(self, net, arrays: tuple) -> tuple[list[torch.Tensor], dict]:
        obs, first, actions, behaviour_logits, rewards, cont, state = arrays
        cfg = self._config
        net_out, _ = net(obs, first, state, unroll=True)
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
        grads = torch.autograd.grad(out.total, list(self._params.values()))
        return list(grads), {k: v.detach() for k, v in out.logs.items()}

    def train_step(self, arrays: tuple) -> dict[str, torch.Tensor]:
        """One SGD step on a device batch (`_to_device`'s tuple: the six
        trajectory arrays and the start state), over `grad_accum`
        microbatches; returns device-scalar logs. With G > 1 the logs of
        SUM_REDUCED_LOG_KEYS are summed over the microbatches under
        reduction="sum" and every other log is their mean, as JAX's scan
        combines them."""
        cfg = self._config
        G = cfg.grad_accum
        if G == 1:
            # One microbatch's logs as they are: none of the stack-and-reduce
            # launches that combine G of them.
            grads, logs = self._grads(arrays)
        else:
            micro_logs = []
            for g, micro in enumerate(split_batch(arrays, G)):
                micro_grads, micro_log = self._grads(micro)
                micro_logs.append(micro_log)
                if g == 0:
                    grads = micro_grads
                elif g == 1:
                    # A new list: autograd may hand two params one tensor, or
                    # a broadcast view, so only this sum's tensors are the
                    # accumulator that later microbatches add into in place.
                    grads = torch._foreach_add(grads, micro_grads)
                else:
                    torch._foreach_add_(grads, micro_grads)
                del micro_grads  # not held through the next microbatch's backward
            if cfg.loss.reduction == "mean":
                torch._foreach_div_(grads, float(G))
            summed = SUM_REDUCED_LOG_KEYS if cfg.loss.reduction == "sum" else ()
            logs = {
                k: torch.stack([m[k] for m in micro_logs]).sum(0)
                if k in summed
                else torch.stack([m[k] for m in micro_logs]).mean(0)
                for k in micro_logs[0]
            }
        grad_norm = global_norm(grads)
        if cfg.max_grad_norm is not None:
            scale = torch.clamp(cfg.max_grad_norm / (grad_norm + 1e-8), max=1.0)
            grads = torch._foreach_mul(grads, scale)
        updates = self._optimizer.step(self._params, dict(zip(self._params, grads)))
        logs["grad_norm_unclipped"] = grad_norm.detach()
        with torch.no_grad():
            logs["weight_norm"] = global_norm(self._params.values())
            if self._health_groups is not None:
                logs.update(self._health_step_logs(grads, updates))
        return logs

    def _health_step_logs(self, grads, updates) -> dict[str, torch.Tensor]:
        """Per-group health logs of one step (JAX's `_health_step_logs`):
        `health_grad_norm_<g>`, the global norm of group g's grads as the
        optimizer took them (clipped), and `health_update_ratio_<g>` =
        ||u_g|| / (||p_g|| + 1e-8), the optimizer's updates against the
        params after the step. Every tensor's norm comes from one
        multi-tensor norm; each group's sums of squares from one
        `index_add_`."""
        n = len(self._params)
        norms = torch.stack(torch._foreach_norm([*grads, *updates, *self._params.values()]))
        sums = torch.zeros(3, len(self._health_groups), device=norms.device, dtype=norms.dtype)
        sums.index_add_(1, self._health_group_of, torch.square(norms).view(3, n))
        g_norm, u_norm, p_norm = torch.sqrt(sums)
        ratio = u_norm / (p_norm + 1e-8)
        logs = {}
        for i, group in enumerate(self._health_groups):
            logs[f"health_grad_norm_{group}"] = g_norm[i]
        for i, group in enumerate(self._health_groups):
            logs[f"health_update_ratio_{group}"] = ratio[i]
        return logs

    def train_dispatch(self, arrays: tuple) -> dict[str, torch.Tensor]:
        """`steps_per_dispatch` = K SGD steps on a device batch: at K = 1
        `train_step(arrays)`; else `arrays` is a `[K, ...]` superbatch and
        step k takes `train_step` on its slice k, back to back with no host
        sync (JAX's `_train_multi_impl`, a scan over K steps). Returns the
        last step's device-scalar logs, as the scan does."""
        K = self._config.steps_per_dispatch
        if K == 1:
            return self.train_step(arrays)
        for k in range(K):
            logs = self.train_step(superbatch_slice(arrays, k))
        return logs

    def step_once(self, timeout: Optional[float] = None) -> Mapping[str, Any]:
        """Block for one device batch, take one dispatch of
        `steps_per_dispatch` SGD steps, publish params on the interval.
        Raises queue.Empty on timeout."""
        if self.error is not None:
            raise RuntimeError("learner batcher thread died") from self.error
        t0 = time.monotonic()
        try:
            arrays, batch_version, copied, donated = self._batch_q.get(timeout=timeout)
        finally:
            self._wait_accum += time.monotonic() - t0
        if copied is not None:
            # A ring batch copied on the batcher's side stream: this
            # stream waits for the copies, and the caching allocator keeps
            # the batch's memory until this stream is done with it (the
            # whole [K, ...] tensors, not only the steps' slices).
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(copied)
            for t in (*arrays[:6], *arrays[6]):
                t.record_stream(stream)
        self.last_batch_device = arrays[0].device
        try:
            logs = self.train_dispatch(arrays)
        finally:
            # A donated slot goes back even when the step raised; on the
            # card only after what the step enqueued has run.
            if donated is not None:
                consumed = None
                if self._device.type == "cuda":
                    consumed = torch.cuda.Event()
                    consumed.record(torch.cuda.current_stream(self._device))
                self._hand_back(donated, consumed)
        cfg = self._config
        K = cfg.steps_per_dispatch
        self.num_frames += K * cfg.unroll_length * cfg.batch_size
        self.num_steps += K
        self._batch_seq += 1
        logs["num_frames"] = self.num_frames
        logs["num_steps"] = self.num_steps
        logs["param_lag_frames"] = self.num_frames - batch_version
        if crossed_interval(self.num_steps, K, cfg.publish_interval):
            self._publish()
        if (self._logger is not None or self._health is not None) and crossed_interval(
            self.num_steps, K, cfg.log_interval
        ):
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
            host_logs = {
                k: float(v) if isinstance(v, torch.Tensor) else v for k, v in logs.items()
            }
            if self._logger is not None:
                self._logger(host_logs)
            if self._health is not None:
                # The same floats the logger got: no device sync of its own.
                self._health.observe(
                    host_logs,
                    lineage=BatchLineage(
                        batch=self._batch_seq - 1, ring_slot=-1 if donated is None else donated
                    ),
                )
        return logs

    def attach_health(self, monitor) -> None:
        """Attach a `telemetry.health.HealthMonitor`: `step_once` hands it
        each log interval's floats (the logger's) and the batch's
        `BatchLineage`, and `run` hands it a crash. Its bundles record
        this learner's config and counters; the port keeps no PRNG key.
        Pair with `config.loss.health_diagnostics=True` for the step's
        health logs; without it only the grad-spike ratio has data."""
        self._health = monitor
        monitor.bind_context(
            config=self._config,
            get_rng=None,
            get_counters=lambda: {"num_steps": self.num_steps, "num_frames": self.num_frames},
        )

    def run(
        self,
        max_steps: int,
        stop_event: Optional[threading.Event] = None,
        watchdog: Optional[Callable[[], None]] = None,
        post_step: Sequence[Callable[[int], None]] = (),
    ) -> None:
        """`max_steps` SGD steps, then stop. With `steps_per_dispatch` = K
        each dispatch takes K steps, so it runs the largest multiple of K
        that fits and never overshoots the budget (the lr schedule and the
        frame budget line up with `total_steps`); a remainder is left
        unrun, with a warning (JAX's rule). Each hook of `post_step` runs
        after every dispatch with the learner's `num_steps`, on this thread
        (checkpoint saves, chaos, the caller's own); a hook that raises
        ends the run. `watchdog` runs whenever no batch arrives within a
        second and should raise if the producers are dead. With a health
        monitor attached, an error that ends the run writes a crash bundle
        before it propagates."""
        self.start()
        K = self._config.steps_per_dispatch
        if max_steps % K:
            warnings.warn(
                f"step budget {max_steps} is not a multiple of steps_per_dispatch={K}; "
                f"the final {max_steps % K} step(s) will not run",
                stacklevel=2,
            )
        steps = 0
        try:
            while steps + K <= max_steps:
                if stop_event is not None and stop_event.is_set():
                    break
                try:
                    self.step_once(timeout=1.0)
                    steps += K
                except queue.Empty:
                    if watchdog is not None:
                        watchdog()
                    continue
                for hook in post_step:
                    hook(self.num_steps)
        except BaseException as e:
            # A postmortem bundle before teardown (an attached monitor
            # writes one a lifetime); the error propagates unchanged.
            if self._health is not None:
                self._health.on_crash(e)
            raise
        finally:
            self.stop()
            if stop_event is not None:
                stop_event.set()

    # ---- state ---------------------------------------------------------

    def get_state(self) -> dict:
        """Host copies of the params, optimizer state and counters
        (utils/checkpoint.py names its entries)."""
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

    def get_state_device(self) -> dict:
        """`get_state`-shaped, with clones on the learner's device in place
        of host copies: the learner-thread half of an async save
        (resilience/checkpointer.py). The clones are queued on the current
        stream, the one that runs the train step, so they are ordered
        before the next step's in-place update; nothing waits for the
        device here."""
        with torch.no_grad():
            return {
                "params": {k: v.detach().clone() for k, v in self._params.items()},
                "opt_state": {
                    "count": self._optimizer.count,
                    "nu": {k: v.clone() for k, v in self._optimizer.nu.items()},
                },
                "num_frames": self.num_frames,
                "num_steps": self.num_steps,
            }

    def set_state(self, state: Mapping[str, Any]) -> None:
        """Restore a `get_state()` dict and republish the params, so actors
        act on the restored policy at its restored frame count.

        Everything is checked before anything is replaced, so a bad state
        leaves the learner as it was: the params' names and shapes against
        the live params here, then `RMSProp.load_state_dict` checks `nu`'s
        names, shapes and float32 rule before it writes `nu`, and only then
        are the params written (`Tensor.copy_` would broadcast a wrong
        shape silently). With a trajectory ring, the slots a dead writer
        left half committed are then discarded."""
        validate_restored_shapes(state["params"], self._params, what="params")
        self._optimizer.load_state_dict(state["opt_state"])
        with torch.no_grad():
            for k, v in state["params"].items():
                self._params[k].copy_(v)
        self.num_frames = int(state["num_frames"])
        self.num_steps = int(state["num_steps"])
        self._publish()
        if self.traj_ring is not None:
            torn = self.traj_ring.discard_torn()
            if torn:
                print(
                    f"[learner] restore discarded {torn} torn ring slot(s) "
                    "from a writer that died mid-commit",
                    file=sys.stderr,
                    flush=True,
                )

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return self._params
