"""Trajectory ring: actors write unrolls straight into the learner's batch
slots (counterpart of `torched_impala_tpu/runtime/traj_ring.py`).

On the queue feed every unroll is copied three times: shared-memory lanes
into per-env `Trajectory` arrays, `np.stack` into a batch, then a
pageable host-to-device copy. The ring keeps a pool of `num_slots`
preallocated, time-major `[T+1, B, ...]` unroll slots, each shaped like
`learner.alloc_stack_buffers`' output, so a completed slot IS a learner
batch:

- an actor `acquire(E)`s a block of E columns of the filling slot and
  writes every timestep of its unroll into those columns (rewards and
  dones straight out of the env pool's lanes, actions and logits at
  inference time): no per-env arrays, no `np.stack`;
- `commit(block, param_version)` publishes the columns; once all B
  columns of a slot are committed it moves to the ready queue, and the
  learner's batcher copies it to the card as it is;
- slots recycle through a free list, with a generation counter on each slot:
  the batcher returns a slot only after its host-to-device copy has
  completed (`release_after_transfer`), and a stale block (its slot
  recycled under a writer that outlived it) fails loudly at commit.

Backpressure falls out of the free list: with every slot filling, ready
or in flight, `acquire` blocks, where a full trajectory queue blocked
`enqueue`.

On the card the slot buffers are pinned host memory (`torch.empty(...,
pin_memory=True)`, with numpy views for the writers), so the batcher's
copies are asynchronous DMA on a side stream; on the CPU device they are
ordinary memory.

Not ported here: replay (`max_reuse > 1`, ROADMAP.md queue 1: Replay)
and superbatch slots (`superbatch_k > 1`, ROADMAP.md queue 1: The
learner step's launches); both raise NotImplementedError.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from torched_impala_tpu_torch.runtime.types import QueueClosed, Trajectory, map_state


class RingBlock(NamedTuple):
    """A writer's view of E columns of one slot.

    The arrays are numpy views into the slot buffers (`obs` `[T+1, E,
    ...]`, `first` `[T+1, E]`, `actions`/`rewards`/`cont` `[T, E]`,
    `behaviour_logits` `[T, E, A]`, agent_state leaves `[E, ...]`):
    writing a timestep row writes the learner batch. `slot`/`gen` identify
    the reservation for commit and abort."""

    slot: int
    cols: slice
    gen: int
    obs: np.ndarray
    first: np.ndarray
    actions: np.ndarray
    behaviour_logits: np.ndarray
    rewards: np.ndarray
    cont: np.ndarray
    agent_state: Any


class ReadySlot(NamedTuple):
    """A completed slot handed to the batcher. `tensors` is the batch as
    the train step takes it, (obs, first, actions, behaviour_logits,
    rewards, cont, agent_state), over the slot's own memory (pinned on
    the card), valid until `release(slot)`. `versions` lists the
    committed blocks' param versions in column order."""

    slot: int
    tensors: tuple
    param_version: int
    versions: tuple = ()


class _Slot:
    __slots__ = ("tensors", "arrays", "gen", "next_col", "committed",
                 "aborted", "blocks", "delivered")

    def __init__(self, tensors: Trajectory):
        self.tensors = tensors
        # Numpy views of the same memory, for the writers.
        self.arrays = Trajectory(
            *(t.numpy() for t in tensors[:6]),
            agent_state=map_state(lambda t: t.numpy(), tensors.agent_state),
        )
        self.gen = 0
        self.next_col = 0  # columns handed out to writers
        self.committed = 0  # columns committed or aborted
        self.aborted = False
        self.blocks: dict = {}  # col_start -> param_version per committed block
        self.delivered = False  # being consumed by the batcher


class TrajectoryRing:
    """Preallocated pool of `[T+1, B, ...]` unroll slots shared between
    `VectorActor` writers and the `Learner` batcher."""

    def __init__(
        self,
        *,
        num_slots: int,
        unroll_length: int,
        batch_size: int,
        example_obs: np.ndarray,
        num_actions: int,
        agent_state_example: Any = (),
        pin_memory: bool = False,
        max_reuse: int = 1,
        superbatch_k: int = 1,
    ) -> None:
        if max_reuse != 1:
            raise NotImplementedError(
                f"max_reuse={max_reuse}: replaying ring slots is not ported yet "
                "(ROADMAP.md queue 1: Replay)"
            )
        if superbatch_k != 1:
            raise NotImplementedError(
                f"superbatch_k={superbatch_k}: superbatch slots are not ported yet "
                "(ROADMAP.md queue 1: The learner step's launches)"
            )
        if num_slots < 2:
            # One slot can never overlap filling with a transfer in flight.
            raise ValueError(f"need >= 2 slots, got {num_slots}")
        if unroll_length < 1 or batch_size < 1:
            raise ValueError("unroll_length and batch_size must be >= 1")
        obs = np.asarray(example_obs)
        T, B = unroll_length, batch_size
        self.unroll_length = T
        self.batch_size = B
        self.num_slots = num_slots
        self.obs_shape = obs.shape
        self.obs_dtype = obs.dtype
        self.num_actions = int(num_actions)
        self.pin_memory = pin_memory

        obs_dtype = torch.from_numpy(np.zeros((), obs.dtype)).dtype

        def empty(shape, dtype) -> torch.Tensor:
            return torch.empty(shape, dtype=dtype, pin_memory=pin_memory)

        # Per-env agent-state template (leaves [1, ...], as each
        # Trajectory carries); slot leaves hold [B, ...].
        def slot_tensors() -> Trajectory:
            return Trajectory(
                obs=empty((T + 1, B) + obs.shape, obs_dtype),
                first=empty((T + 1, B), torch.bool),
                actions=empty((T, B), torch.int32),
                behaviour_logits=empty((T, B, self.num_actions), torch.float32),
                rewards=empty((T, B), torch.float32),
                cont=empty((T, B), torch.float32),
                agent_state=map_state(
                    lambda x: empty((B * x.shape[0],) + tuple(x.shape[1:]), x.dtype),
                    agent_state_example,
                ),
            )

        self._slots: List[_Slot] = [_Slot(slot_tensors()) for _ in range(num_slots)]
        self._free: collections.deque = collections.deque(range(num_slots))
        self._ready: collections.deque = collections.deque()
        self._filling: Optional[int] = None
        self._closed = False
        self._cond = threading.Condition()

    # -- writer (actor) side ----------------------------------------------

    def acquire(self, num_cols: int) -> RingBlock:
        """Reserve `num_cols` columns of the filling slot; blocks while
        every slot is busy (the ring's backpressure). Raises QueueClosed
        after `close()`. `num_cols` must divide `batch_size`, so a block
        never straddles two slots."""
        if num_cols < 1 or self.batch_size % num_cols:
            raise ValueError(
                f"block of {num_cols} columns must divide batch_size "
                f"{self.batch_size} (one batch = whole blocks only)"
            )
        with self._cond:
            while True:
                if self._closed:
                    raise QueueClosed()
                if self._filling is None and self._free:
                    self._filling = self._free.popleft()
                if self._filling is not None:
                    s = self._filling
                    slot = self._slots[s]
                    c0 = slot.next_col
                    slot.next_col += num_cols
                    if slot.next_col >= self.batch_size:
                        self._filling = None  # fully handed out
                    return self._block(s, slice(c0, c0 + num_cols))
                self._cond.wait(timeout=0.5)

    def _block(self, s: int, cols: slice) -> RingBlock:
        slot = self._slots[s]
        buf = slot.arrays
        return RingBlock(
            slot=s,
            cols=cols,
            gen=slot.gen,
            obs=buf.obs[:, cols],
            first=buf.first[:, cols],
            actions=buf.actions[:, cols],
            behaviour_logits=buf.behaviour_logits[:, cols],
            rewards=buf.rewards[:, cols],
            cont=buf.cont[:, cols],
            agent_state=map_state(lambda x: x[cols], buf.agent_state),
        )

    def commit(self, block: RingBlock, param_version: int) -> None:
        """Publish a fully written block. When the slot's last block
        commits, the slot becomes a ready batch. Committing against a
        recycled slot (generation mismatch: a stale writer) raises."""
        with self._cond:
            slot = self._slots[block.slot]
            if slot.gen != block.gen:
                raise RuntimeError(
                    f"stale ring block: slot {block.slot} generation {block.gen} "
                    f"was recycled (now {slot.gen}); the writer held its block "
                    "across a slot recycle"
                )
            slot.blocks[block.cols.start] = param_version
            slot.committed += block.cols.stop - block.cols.start
            self._maybe_complete_locked(block.slot)

    def abort(self, block: RingBlock) -> None:
        """Give up a block after a writer crash: its columns hold garbage,
        so when the slot completes it is recycled instead of delivered
        (one lost batch, never a poisoned one). A stale generation (the
        slot already moved on) is ignored."""
        with self._cond:
            slot = self._slots[block.slot]
            if slot.gen != block.gen:
                return
            slot.aborted = True
            slot.committed += block.cols.stop - block.cols.start
            self._maybe_complete_locked(block.slot)

    def _maybe_complete_locked(self, s: int) -> None:
        slot = self._slots[s]
        if slot.committed < self.batch_size:
            return
        if slot.aborted:
            self._recycle_locked(s)
        else:
            self._ready.append(s)
        self._cond.notify_all()

    # -- consumer (learner batcher) side ----------------------------------

    def pop_ready(self, timeout: Optional[float] = None) -> Optional[ReadySlot]:
        """The next completed slot (views, valid until `release`); None on
        timeout or after close. The batch's param_version is the smallest
        of its columns', as `stack_trajectories` takes it."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                if self._ready:
                    return self._deliver_locked(self._ready.popleft())
                if self._closed:
                    return None
                budget = None if deadline is None else deadline - time.monotonic()
                if budget is not None and budget <= 0:
                    return None
                self._cond.wait(timeout=budget)

    def _deliver_locked(self, s: int) -> ReadySlot:
        slot = self._slots[s]
        slot.delivered = True
        buf = slot.tensors
        return ReadySlot(
            slot=s,
            tensors=(buf.obs, buf.first, buf.actions, buf.behaviour_logits, buf.rewards,
                     buf.cont, buf.agent_state),
            param_version=min(slot.blocks.values()),
            versions=tuple(slot.blocks[c] for c in sorted(slot.blocks)),
        )

    def release(self, s: int) -> None:
        """Return slot `s` to the free list (the generation bump makes any
        block still held for it stale). Call only once nothing reads its
        buffers: after its device copy completed, or after an owning host
        copy was taken."""
        with self._cond:
            self._slots[s].delivered = False
            self._recycle_locked(s)
            self._cond.notify_all()

    def release_after_transfer(self, s: int, event: Optional[torch.cuda.Event]) -> None:
        """Wait for `event` (recorded after slot `s`'s host-to-device copies
        on their stream), then release the slot: until the event completes
        the DMA may still read the slot's pinned buffers, so the wait is
        never skipped. `event=None` releases at once (nothing in flight)."""
        if event is not None:
            event.synchronize()
        self.release(s)

    def discard_torn(self) -> int:
        """Recycle every torn slot (columns handed out, but the slot neither
        complete, ready, free nor delivered: what a writer that died
        mid-unroll without aborting leaves behind). The generation bump
        makes a zombie writer's commit raise instead of poisoning a batch.
        Safe at any time: a quiescent ring discards nothing. Returns the
        number of slots discarded."""
        discarded = 0
        with self._cond:
            busy = set(self._ready) | set(self._free)
            for s, slot in enumerate(self._slots):
                if s in busy or slot.delivered:
                    continue
                if slot.next_col == 0 and slot.committed == 0:
                    continue
                if self._filling == s:
                    self._filling = None
                self._recycle_locked(s)
                discarded += 1
            if discarded:
                self._cond.notify_all()
        return discarded

    def _recycle_locked(self, s: int) -> None:
        slot = self._slots[s]
        slot.gen += 1
        slot.next_col = 0
        slot.committed = 0
        slot.aborted = False
        slot.blocks = {}
        self._free.append(s)

    def close(self) -> None:
        """Wake every blocked acquirer (QueueClosed) and consumer (None)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # -- start-up validation ----------------------------------------------

    def validate_env_spec(self, example_obs: np.ndarray, num_actions: int) -> List[str]:
        """Mismatches between the slot buffers and an env spec (empty when
        they agree), so a shape or dtype drift fails at start-up and not as
        garbled batches."""
        obs = np.asarray(example_obs)
        buf = self._slots[0].arrays
        T, B = self.unroll_length, self.batch_size
        problems: List[str] = []
        if buf.obs.shape != (T + 1, B) + obs.shape:
            problems.append(
                f"obs slot shape {buf.obs.shape} != expected {(T + 1, B) + obs.shape}"
            )
        if buf.obs.dtype != obs.dtype:
            problems.append(f"obs slot dtype {buf.obs.dtype} != env {obs.dtype}")
        if buf.behaviour_logits.shape != (T, B, num_actions):
            problems.append(
                f"logits slot shape {buf.behaviour_logits.shape} != expected "
                f"{(T, B, num_actions)}"
            )
        for name, arr, dtype in (
            ("first", buf.first, np.bool_),
            ("actions", buf.actions, np.int32),
            ("behaviour_logits", buf.behaviour_logits, np.float32),
            ("rewards", buf.rewards, np.float32),
            ("cont", buf.cont, np.float32),
        ):
            if arr.dtype != np.dtype(dtype):
                problems.append(f"{name} slot dtype {arr.dtype} != {np.dtype(dtype)}")
        return problems
