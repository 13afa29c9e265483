"""AsyncCheckpointer: the train loop never waits on checkpoint disk I/O
(counterpart of `torched_impala_tpu/resilience/checkpointer.py`).

The learner-thread half of a save is an interval check and, when a save
is due, `Learner.get_state_device()`: clones of the params and the
optimizer state queued on the stream that runs the train step, so they
are ordered before the next step's in-place RMSProp update, with no host
sync. `maybe_save` then records a CUDA event on that stream after the
clones and hands both, through a depth-1 slot, to a writer thread that:

1. makes its own copy stream wait on the event (a `.cpu()` on another
   thread's current stream is not ordered with the clones), marks each
   clone used on that stream (`record_stream`), copies the clones into
   one reusable pinned host buffer and waits for its stream only (one
   writer captures and writes each save in turn, and nothing is
   submitted while it is busy, so one buffer is never wanted twice);
2. writes the state file atomically (utils/checkpoint.save_state_file);
3. writes the run manifest (resilience/recovery.py) AFTER the state file,
   so a manifest always points at a complete checkpoint;
4. prunes retention beyond `keep`.

A save triggers every `interval_steps` learner steps or every
`interval_seconds` wall seconds, whichever comes first; a trigger that
finds the writer still busy is skipped, not queued, so the train loop
cannot back up behind a slow disk. A writer error is raised by the next
`maybe_save` or `wait`. The learner thread never waits on the disk, but
a save in flight slows the train step it overlaps: on an H100 the
writer's host work (zip members, CRCs, fsyncs) took the step from about
7 to 20 ms through the interpreter lock (PERF.md, "Open questions").

The counters are plain attributes (`saves`, `skipped`, and per save
`records`: step, whether `maybe_save` took it (its submit
seconds then include `state_fn`, the learner thread's whole share), the
submit seconds, the writer's copy and total seconds, bytes) until the port's telemetry
registry lands (ROADMAP.md queue 1: Observability, perf and control).
"""

from __future__ import annotations

import collections
import contextlib
import os
import sys
import threading
import time
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from torched_impala_tpu_torch.resilience import recovery
from torched_impala_tpu_torch.utils.checkpoint import flat_state, save_state_file


def _cuda_device(state: Mapping[str, Any]) -> Optional[torch.device]:
    for leaf in flat_state(state).values():
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            return leaf.device
    return None


class AsyncCheckpointer:
    """Background atomic checkpoint writer with manifests and retention.

    `state_fn` passed to `maybe_save` must return the state WITHOUT a
    host sync (clones on the device, queued on the caller's current
    stream); the writer thread does the only device-to-host copy.
    `wait()` before reading files or exiting; `close()` is idempotent."""

    def __init__(
        self,
        directory: str,
        *,
        keep: int = 3,
        interval_steps: int = 0,
        interval_seconds: float = 0.0,
        config_hash: Optional[str] = None,
        post_save: Optional[Callable[[str, int], None]] = None,
    ) -> None:
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._keep = keep
        self._interval_steps = interval_steps
        self._interval_seconds = interval_seconds
        self._config_hash = config_hash
        # Chaos seam: called (checkpoint_path, step) after each completed
        # save; `corrupt_checkpoint` rides it.
        self._post_save = post_save
        # Written by the writer thread, read by the learner thread.
        self.error: Optional[BaseException] = None

        self._last_step = -(10**18)  # the first maybe_save fires
        self._last_time = time.monotonic()
        self._pending: Optional[tuple] = None
        self._pending_lock = threading.Lock()
        self._kick = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._stop = threading.Event()
        # The host buffer, {flat name: tensor}, reused save after save.
        self._buffer: dict = {}
        self._copy_stream: Optional[torch.cuda.Stream] = None
        self.saves = 0
        self.skipped = 0
        self.records: collections.deque = collections.deque(maxlen=1000)
        self._thread = threading.Thread(
            target=self._writer_loop, name="async-checkpointer", daemon=True
        )
        self._thread.start()

    # ---- learner-thread surface ----------------------------------------

    def anchor(self, step: int) -> None:
        """Count both cadences from `step` and now: the loop calls it with
        the step a run starts or resumes at, so interval saves land on
        multiples of the interval past it (without it the first
        `maybe_save` fires)."""
        self._last_step = step
        self._last_time = time.monotonic()

    def due(self, step: int) -> bool:
        """True when `interval_steps` steps or `interval_seconds` seconds
        passed since the last trigger; False with neither configured."""
        if self._interval_steps > 0 and step - self._last_step >= self._interval_steps:
            return True
        return self._interval_seconds > 0 and (
            time.monotonic() - self._last_time >= self._interval_seconds
        )

    def _raise_error(self) -> None:
        if self.error is not None:
            raise RuntimeError("async checkpointer writer thread failed") from self.error

    def maybe_save(
        self,
        step: int,
        state_fn: Callable[[], Mapping[str, Any]],
        *,
        param_version: Optional[int] = None,
    ) -> bool:
        """Interval-triggered async save; call after every learner step.
        True when a save went to the writer. A due trigger that finds the
        writer busy is skipped and counted; the next step retries."""
        self._raise_error()
        if not self.due(step):
            return False
        if not self._idle.is_set():
            self.skipped += 1
            return False
        t0 = time.perf_counter()
        self._submit(step, state_fn(), param_version, t0, interval=True)
        return True

    def save_now(
        self,
        step: int,
        state: Mapping[str, Any],
        *,
        param_version: Optional[int] = None,
    ) -> None:
        """Unconditional save (the final checkpoint); still async, `wait()`
        blocks until it is on disk."""
        self._idle.wait()
        self._submit(step, state, param_version, time.perf_counter(), interval=False)

    def _submit(self, step, state, param_version, t0, interval) -> None:
        # The event follows the clones on the caller's current stream: the
        # writer's copies wait for it, not for the whole device.
        ready = None
        device = _cuda_device(state)
        if device is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
        submit_s = time.perf_counter() - t0
        self._last_step = step
        self._last_time = time.monotonic()
        with self._pending_lock:
            self._pending = (step, state, param_version, ready, submit_s, interval)
            self._idle.clear()
        self._kick.set()

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until the writer drains (the last submitted save is on
        disk, manifest included); raises a writer error."""
        self._idle.wait(timeout=timeout)
        self._raise_error()

    def latest_step(self) -> Optional[int]:
        steps = recovery.list_manifest_steps(self.directory)
        return steps[-1] if steps else None

    def all_steps(self) -> list:
        return recovery.list_manifest_steps(self.directory)

    def close(self) -> None:
        if self._stop.is_set():
            return
        self._idle.wait(timeout=60.0)
        self._stop.set()
        self._kick.set()
        self._thread.join(timeout=60.0)

    # ---- writer thread --------------------------------------------------

    def _capture(self, state, ready) -> dict:
        """The state's leaves copied into the host buffer ({flat name:
        leaf}); tensors of the right shape are reused, ints pass through."""
        old = self._buffer
        flat = flat_state(state)
        stream = None
        if ready is not None:
            device = _cuda_device(state)
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(device)
            stream = self._copy_stream
            stream.wait_event(ready)
        out = {}
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            for key, leaf in flat.items():
                if not isinstance(leaf, torch.Tensor):
                    out[key] = leaf
                    continue
                dst = old.get(key)
                if not (
                    isinstance(dst, torch.Tensor)
                    and dst.shape == leaf.shape
                    and dst.dtype == leaf.dtype
                ):
                    dst = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=leaf.is_cuda)
                if leaf.is_cuda:
                    # The clone was allocated on the learner's stream and
                    # is read on this one.
                    leaf.record_stream(stream)
                dst.copy_(leaf, non_blocking=leaf.is_cuda)
                out[key] = dst
        if stream is not None:
            stream.synchronize()
        self._buffer = out
        return out

    def _writer_loop(self) -> None:
        while True:
            self._kick.wait()
            self._kick.clear()
            if self._stop.is_set():
                return
            with self._pending_lock:
                item = self._pending
                self._pending = None
            if item is None:
                continue
            step = item[0]
            try:
                self._write_one(*item)
            except BaseException as e:  # noqa: BLE001 - raised by the next call
                self.error = e
                print(
                    f"[async-checkpointer] save @ step {step} failed: {e!r}",
                    file=sys.stderr,
                    flush=True,
                )
            finally:
                item = None  # drop the clones before the next wait
                self._idle.set()

    def _write_one(self, step, state, param_version, ready, submit_s, interval) -> None:
        t0 = time.perf_counter()
        host_state = self._capture(state, ready)
        del state  # the clones go back to the allocator
        copy_s = time.perf_counter() - t0
        ckpt = recovery.checkpoint_path(self.directory, step)
        nbytes = save_state_file(ckpt, host_state)
        if param_version is None:
            v = host_state.get("num_frames")
            param_version = int(np.asarray(v)) if v is not None else step
        recovery.write_manifest(
            self.directory,
            recovery.RunManifest(
                step=int(step),
                param_version=int(param_version),
                checkpoint=os.path.basename(ckpt),
                config_hash=self._config_hash,
                saved_at=time.time(),
                host_count=1,  # the port runs one host
            ),
        )
        recovery.prune(self.directory, self._keep)
        self.saves += 1
        self.records.append(
            dict(step=int(step), interval=interval, submit_s=submit_s, copy_s=copy_s,
                 write_s=time.perf_counter() - t0, bytes=nbytes)
        )
        if self._post_save is not None:
            self._post_save(ckpt, int(step))
