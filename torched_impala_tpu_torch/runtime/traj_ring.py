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
  completed (`release_after_transfer`), or with the learner's
  `donate_batch` only after the step that consumed it, and a stale block
  (its slot recycled under a writer that outlived it) fails loudly at
  commit.

Backpressure falls out of the free list: with every slot filling, ready
or in flight, `acquire` blocks, where a full trajectory queue blocked
`enqueue`.

On the card the slot buffers are pinned host memory (`torch.empty(...,
pin_memory=True)`, with numpy views for the writers), so the batcher's
copies are asynchronous DMA on a side stream; on the CPU device they are
ordinary memory.

Superbatch slots (`superbatch_k = K > 1`, the learner's
`steps_per_dispatch`): every slot has a leading `[K]` axis (`obs` is
`[K, T+1, B, ...]`) and holds K*B columns. A writer still acquires a
plain `[T+1, E, ...]` view: a block never straddles a B boundary (E
divides B), so it lies inside one of the K sub-batches. A slot completes
when all K*B columns have committed, and a delivered slot is the K-step
dispatch's superbatch as it is: one host-to-device copy for K SGD steps.
With K = 1 the shapes have no leading axis.

Replay (`max_reuse > 1`, IMPACT-style, torched_impala_tpu_torch/replay/):
a released slot with reuse budget left goes on a retained list instead
of the free list, its generation unchanged and its contents live. When
no fresh slot is ready, `pop_ready` draws a retained slot with a seeded
sampler weighted 1 / (1 + staleness) (staleness: the learner's frame
watermark from `note_version` minus the slot's acting param version),
under the `replay_mix` cap on the share of replays; `staleness_frames`
expires retained slots past the bound. Fresh slots always come first.
Under free-list pressure `acquire` evicts the stalest retained slot
rather than block an actor. A delivered slot is never on the retained
list, so eviction never recycles buffers that a copy may still read.
Superbatch slots cannot be replayed (JAX's refusal). With `max_reuse ==
1` nothing of this runs and no `replay/*` series is registered.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from torched_impala_tpu_torch.runtime.types import QueueClosed, Trajectory, map_state
from torched_impala_tpu_torch.telemetry.registry import Registry, get_registry


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
    committed blocks' param versions in column order. Replay's provenance
    (JAX's fields): `gen` is the slot's generation at delivery,
    `reuse_count` which delivery of the slot's contents this is (1 =
    fresh), `staleness` the learner's frame watermark minus the slot's
    param version."""

    slot: int
    tensors: tuple
    param_version: int
    versions: tuple = ()
    gen: int = 0
    reuse_count: int = 1
    staleness: int = 0


class _Slot:
    __slots__ = ("tensors", "arrays", "gen", "next_col", "committed",
                 "aborted", "blocks", "reuse_count", "delivered")

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
        self.reuse_count = 0  # deliveries of the current contents
        self.delivered = False  # being consumed by the batcher

    def version(self) -> int:
        """The least param version of the committed columns."""
        return min(self.blocks.values())


class TrajectoryRing:
    """Preallocated pool of `[T+1, B, ...]` unroll slots (`[K, T+1, B,
    ...]` superbatch slots with `superbatch_k=K`) shared between
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
        replay_mix: float = 1.0,
        staleness_frames: int = 0,
        sampler_seed: int = 0,
        superbatch_k: int = 1,
        telemetry: Optional[Registry] = None,
    ) -> None:
        """`max_reuse`, `replay_mix`, `staleness_frames` and
        `sampler_seed` set replay (module docstring; ReplayConfig says
        what each does); `telemetry` takes the `replay/*` series, the
        global registry by default."""
        if num_slots < 2:
            # One slot can never overlap filling with a transfer in flight.
            raise ValueError(f"need >= 2 slots, got {num_slots}")
        if unroll_length < 1 or batch_size < 1:
            raise ValueError("unroll_length and batch_size must be >= 1")
        if superbatch_k < 1:
            raise ValueError(f"superbatch_k must be >= 1, got {superbatch_k}")
        if superbatch_k > 1 and max_reuse > 1:
            raise ValueError(
                "superbatch slots cannot be replayed (max_reuse > 1): "
                "the surrogate path consumes [T, B] batches"
            )
        if max_reuse < 1:
            raise ValueError(f"max_reuse must be >= 1, got {max_reuse}")
        if not (0.0 < replay_mix <= 1.0):
            raise ValueError(f"replay_mix must be in (0, 1], got {replay_mix}")
        if staleness_frames < 0:
            raise ValueError(f"staleness_frames must be >= 0, got {staleness_frames}")
        obs = np.asarray(example_obs)
        T, B, K = unroll_length, batch_size, int(superbatch_k)
        self.unroll_length = T
        self.batch_size = B
        self.superbatch_k = K
        self.total_cols = K * B
        self.num_slots = num_slots
        self.obs_shape = obs.shape
        self.obs_dtype = obs.dtype
        self.num_actions = int(num_actions)
        self.pin_memory = pin_memory

        obs_dtype = torch.from_numpy(np.zeros((), obs.dtype)).dtype

        def empty(shape, dtype) -> torch.Tensor:
            return torch.empty(shape, dtype=dtype, pin_memory=pin_memory)

        # Per-env agent-state template (leaves [1, ...], as each
        # Trajectory carries); slot leaves hold [B, ...]. Superbatch slots
        # carry a leading [K] axis on every leaf.
        lead = () if K == 1 else (K,)

        def slot_tensors() -> Trajectory:
            return Trajectory(
                obs=empty(lead + (T + 1, B) + obs.shape, obs_dtype),
                first=empty(lead + (T + 1, B), torch.bool),
                actions=empty(lead + (T, B), torch.int32),
                behaviour_logits=empty(lead + (T, B, self.num_actions), torch.float32),
                rewards=empty(lead + (T, B), torch.float32),
                cont=empty(lead + (T, B), torch.float32),
                agent_state=map_state(
                    lambda x: empty(lead + (B * x.shape[0],) + tuple(x.shape[1:]), x.dtype),
                    agent_state_example,
                ),
            )

        self._slots: List[_Slot] = [_Slot(slot_tensors()) for _ in range(num_slots)]
        self._free: collections.deque = collections.deque(range(num_slots))
        self._ready: collections.deque = collections.deque()
        self._filling: Optional[int] = None
        self._closed = False
        self._cond = threading.Condition()

        # Replay's state (untouched while max_reuse == 1).
        self.max_reuse = int(max_reuse)
        self.replay_mix = float(replay_mix)
        self.staleness_frames = int(staleness_frames)
        self._retained: List[int] = []  # released with reuse budget left
        self._current_version = 0  # the learner's frame watermark
        self._fresh_delivered = 0
        self._replay_delivered = 0
        self._sampler = np.random.default_rng(sampler_seed)
        if self.max_reuse > 1:
            # Only in replay mode: a ring without it registers nothing.
            reg = telemetry if telemetry is not None else get_registry()
            self._m_reuse_delivered = reg.counter("replay/reuse_delivered")
            self._m_reuse_count = reg.histogram("replay/reuse_count")
            self._m_evict = reg.counter("replay/evict_pressure")
            self._m_stale_expired = reg.counter("replay/staleness_expired")
            self._m_staleness = reg.gauge("replay/staleness_frames")

    # -- writer (actor) side ----------------------------------------------

    def acquire(self, num_cols: int) -> RingBlock:
        """Reserve `num_cols` columns of the filling slot; blocks while
        every slot is busy (the ring's backpressure). Raises QueueClosed
        after `close()`. `num_cols` must divide `batch_size`, so a block
        never straddles two slots, nor two sub-batches of a superbatch
        slot. With no free slot but a retained one, the stalest retained
        slot is recycled for it: actors never wait on replayed data."""
        if num_cols < 1 or self.batch_size % num_cols:
            raise ValueError(
                f"block of {num_cols} columns must divide batch_size "
                f"{self.batch_size} (one batch = whole blocks only)"
            )
        with self._cond:
            while True:
                if self._closed:
                    raise QueueClosed()
                if self._filling is None and not self._free and self._retained:
                    self._evict_locked()
                if self._filling is None and self._free:
                    self._filling = self._free.popleft()
                if self._filling is not None:
                    s = self._filling
                    slot = self._slots[s]
                    c0 = slot.next_col
                    slot.next_col += num_cols
                    if slot.next_col >= self.total_cols:
                        self._filling = None  # fully handed out
                    return self._block(s, slice(c0, c0 + num_cols))
                self._cond.wait(timeout=0.5)

    def _block(self, s: int, cols: slice) -> RingBlock:
        """The writer's views of the slot's global columns `cols`: with
        superbatch slots, columns k*B ... (k+1)*B - 1 are sub-batch k's
        local columns 0 ... B - 1 (JAX's mapping)."""
        slot = self._slots[s]
        buf = slot.arrays
        if self.superbatch_k > 1:
            k, B = cols.start // self.batch_size, self.batch_size
            buf = Trajectory(
                *(x[k] for x in buf[:6]),
                agent_state=map_state(lambda x: x[k], buf.agent_state),
            )
            local = slice(cols.start - k * B, cols.stop - k * B)
        else:
            local = cols
        return RingBlock(
            slot=s,
            cols=cols,
            gen=slot.gen,
            obs=buf.obs[:, local],
            first=buf.first[:, local],
            actions=buf.actions[:, local],
            behaviour_logits=buf.behaviour_logits[:, local],
            rewards=buf.rewards[:, local],
            cont=buf.cont[:, local],
            agent_state=map_state(lambda x: x[local], buf.agent_state),
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
        if slot.committed < self.total_cols:
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
        of its columns', as `stack_trajectories` takes it. In replay mode
        a fresh slot always comes first; with none ready the sampler may
        deliver a retained slot again (under the `replay_mix` cap)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                if self._ready:
                    return self._deliver_locked(self._ready.popleft(), fresh=True)
                if self._closed:
                    return None
                s = self._sample_replay_locked()
                if s is not None:
                    return self._deliver_locked(s, fresh=False)
                budget = None if deadline is None else deadline - time.monotonic()
                if budget is not None and budget <= 0:
                    return None
                self._cond.wait(timeout=budget)

    def _deliver_locked(self, s: int, fresh: bool) -> ReadySlot:
        slot = self._slots[s]
        slot.delivered = True
        staleness = self._staleness_locked(slot)
        if fresh:
            slot.reuse_count = 1
            self._fresh_delivered += 1
        else:
            slot.reuse_count += 1
            self._replay_delivered += 1
            self._m_reuse_delivered.inc()
            self._m_staleness.set(float(staleness))
        buf = slot.tensors
        return ReadySlot(
            slot=s,
            tensors=(buf.obs, buf.first, buf.actions, buf.behaviour_logits, buf.rewards,
                     buf.cont, buf.agent_state),
            param_version=slot.version(),
            versions=tuple(slot.blocks[c] for c in sorted(slot.blocks)),
            gen=slot.gen,
            reuse_count=slot.reuse_count,
            staleness=staleness,
        )

    def release(self, s: int) -> None:
        """Return slot `s` to the free list (the generation bump makes any
        block still held for it stale). Call only once nothing reads its
        buffers: after its device copy completed, or after an owning host
        copy was taken. In replay mode a slot with reuse budget left and
        inside the staleness bound is retained instead, its generation and
        contents kept for another delivery."""
        with self._cond:
            slot = self._slots[s]
            slot.delivered = False
            if (
                self.max_reuse > 1
                and not self._closed
                and slot.reuse_count < self.max_reuse
                and not self._is_stale_locked(slot)
            ):
                self._retained.append(s)
            else:
                if self.max_reuse > 1:
                    self._m_reuse_count.observe(float(slot.reuse_count))
                    if slot.reuse_count < self.max_reuse:
                        # Budget was left: the staleness bound ended it.
                        self._m_stale_expired.inc()
                self._recycle_locked(s)
            self._cond.notify_all()

    # -- replay (retain after release) --------------------------------------

    def note_version(self, version: int) -> None:
        """Advance the learner's frame watermark (its num_frames after each
        step). Staleness is measured against it, and retained slots past
        the staleness bound are expired at once, so the sampler never
        draws them."""
        with self._cond:
            if version > self._current_version:
                self._current_version = int(version)
            self._expire_stale_locked()

    def _staleness_locked(self, slot: _Slot) -> int:
        return max(0, self._current_version - slot.version())

    def _is_stale_locked(self, slot: _Slot) -> bool:
        if self.staleness_frames <= 0:
            return False
        return self._current_version - slot.version() > self.staleness_frames

    def _expire_stale_locked(self) -> None:
        if self.staleness_frames <= 0 or not self._retained:
            return
        keep: List[int] = []
        for s in self._retained:
            if self._is_stale_locked(self._slots[s]):
                self._m_stale_expired.inc()
                self._m_reuse_count.observe(float(self._slots[s].reuse_count))
                self._recycle_locked(s)
            else:
                keep.append(s)
        if len(keep) < len(self._retained):
            self._retained = keep
            self._cond.notify_all()

    def _evict_locked(self) -> None:
        """Recycle the retained slot with the oldest acting params (on a
        tie the most reused) so that an acquirer can go on. Only retained
        slots are candidates: a delivered slot is never on the list."""
        s = min(
            self._retained,
            key=lambda i: (self._slots[i].version(), -self._slots[i].reuse_count),
        )
        self._retained.remove(s)
        self._m_evict.inc()
        self._m_reuse_count.observe(float(self._slots[s].reuse_count))
        self._recycle_locked(s)

    def _sample_replay_locked(self) -> Optional[int]:
        """A retained slot to deliver again, or None (replay off, nothing
        retained, or the `replay_mix` cap binds). The weights are 1 / (1 +
        staleness): fresher slots are preferred, never exclusively; the
        seeded generator makes the draw JAX's, draw for draw."""
        if self.max_reuse <= 1 or not self._retained:
            return None
        self._expire_stale_locked()
        if not self._retained:
            return None
        if self.replay_mix < 1.0:
            total = self._fresh_delivered + self._replay_delivered
            if self._replay_delivered + 1 > self.replay_mix * (total + 1):
                return None
        staleness = np.array(
            [self._staleness_locked(self._slots[s]) for s in self._retained], np.float64
        )
        w = 1.0 / (1.0 + staleness)
        idx = int(self._sampler.choice(len(self._retained), p=w / w.sum()))
        return self._retained.pop(idx)

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
        complete, ready, free, retained nor delivered: what a writer that
        died mid-unroll without aborting leaves behind). The generation bump
        makes a zombie writer's commit raise instead of poisoning a batch.
        Safe at any time: a quiescent ring discards nothing. Returns the
        number of slots discarded."""
        discarded = 0
        with self._cond:
            busy = set(self._ready) | set(self._free) | set(self._retained)
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
        lead = () if self.superbatch_k == 1 else (self.superbatch_k,)
        problems: List[str] = []
        if buf.obs.shape != lead + (T + 1, B) + obs.shape:
            problems.append(
                f"obs slot shape {buf.obs.shape} != expected "
                f"{lead + (T + 1, B) + obs.shape}"
            )
        if buf.obs.dtype != obs.dtype:
            problems.append(f"obs slot dtype {buf.obs.dtype} != env {obs.dtype}")
        if buf.behaviour_logits.shape != lead + (T, B, num_actions):
            problems.append(
                f"logits slot shape {buf.behaviour_logits.shape} != expected "
                f"{lead + (T, B, num_actions)}"
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
