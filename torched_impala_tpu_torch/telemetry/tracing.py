"""Flight recorder: an always-on, fixed-size ring buffer of structured
trace events (the part of `torched_impala_tpu/telemetry/tracing.py` that
the alert engine and the postmortem bundles use; the learner's spans and
the SIGUSR2 dump come with the rest of the observability plane).

- ALWAYS ON at negligible cost: one record is a tuple build + a short
  lock for the ring index + a slot store — no allocation beyond the
  record itself, no I/O, no formatting. A disabled recorder
  short-circuits to one attribute load + branch.
- FIXED memory: `capacity` records (power of two), oldest overwritten.
- STANDARD output: `export()` writes Chrome-trace JSON (open in
  Perfetto / chrome://tracing). Each pipeline component becomes a trace
  "process" row; threads nest under it; lineage dicts ride the event
  `args`.

Event names follow the same `<component>/<name>` slug grammar as metric
names (registry.NAME_RE). Phases mirror Chrome's: `begin`/`end`
("B"/"E") bracket a named region, `instant` ("i") marks a point,
`complete` ("X") is a pre-timed span — the `span()` context manager
records ONE complete event at exit.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from torched_impala_tpu_torch.telemetry.registry import NAME_RE

# Chrome trace event phases (the subset the recorder emits).
PH_BEGIN = "B"
PH_END = "E"
PH_INSTANT = "i"
PH_COMPLETE = "X"

DEFAULT_CAPACITY = 1 << 14  # ~16k records, ~2 MB — minutes of pipeline


def _check_trace_name(name: str, _seen=set()) -> None:  # noqa: B006
    """Validate `<component>/<name>` once per distinct name (the cache
    keeps the hot path at one set lookup)."""
    if name in _seen:
        return
    if not NAME_RE.match(name):
        raise ValueError(
            f"trace event name {name!r} must match <component>/<name> "
            f"({NAME_RE.pattern})"
        )
    _seen.add(name)


class _TraceSpan:
    """`with recorder.span("learner/train_step", {...}):` — one complete
    ("X") record at exit."""

    __slots__ = ("_rec", "_name", "_lineage", "_t0")

    def __init__(self, rec: "FlightRecorder", name: str, lineage):
        self._rec = rec
        self._name = name
        self._lineage = lineage
        self._t0 = 0

    def __enter__(self) -> "_TraceSpan":
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> None:
        self._rec.complete(
            self._name,
            self._t0,
            time.monotonic_ns() - self._t0,
            self._lineage,
        )


class FlightRecorder:
    """Fixed-size ring of `(ts_ns, dur_ns, phase, name, tid, lineage)`
    records. Thread-safe; writers take one short lock per record (the
    ring index + slot store), readers copy under the same lock."""

    def __init__(
        self, capacity: int = DEFAULT_CAPACITY, process_label: str = ""
    ):
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        # A worker process's recorder carries its pool label; the
        # parent's global recorder keeps the default empty label.
        self.process_label = process_label
        self.pid = os.getpid()
        # Round up to a power of two so the ring index is one AND.
        cap = 1
        while cap < capacity:
            cap <<= 1
        self.capacity = cap
        self._mask = cap - 1
        self._buf: List[Optional[tuple]] = [None] * cap
        self._n = 0  # total records ever written
        self._lock = threading.Lock()
        self.enabled = True
        # tid -> thread name, filled lazily on first record per thread
        # (export emits them as Chrome thread_name metadata).
        self._thread_names: Dict[int, str] = {}

    # -- recording (the hot path) -----------------------------------------

    def _record(
        self,
        phase: str,
        name: str,
        lineage: Optional[dict],
        ts_ns: int,
        dur_ns: int = 0,
    ) -> None:
        if not self.enabled:
            return
        _check_trace_name(name)
        tid = threading.get_ident()
        if tid not in self._thread_names:
            self._thread_names[tid] = threading.current_thread().name
        rec = (ts_ns, dur_ns, phase, name, tid, lineage)
        with self._lock:
            self._buf[self._n & self._mask] = rec
            self._n += 1

    def instant(self, name: str, lineage: Optional[dict] = None) -> None:
        """A point event (e.g. an alert's firing transition)."""
        self._record(PH_INSTANT, name, lineage, time.monotonic_ns())

    def begin(self, name: str, lineage: Optional[dict] = None) -> None:
        self._record(PH_BEGIN, name, lineage, time.monotonic_ns())

    def end(self, name: str, lineage: Optional[dict] = None) -> None:
        self._record(PH_END, name, lineage, time.monotonic_ns())

    def complete(
        self,
        name: str,
        t0_ns: int,
        dur_ns: int,
        lineage: Optional[dict] = None,
    ) -> None:
        """A pre-timed span (phase "X"): the caller measured
        `t0_ns`/`dur_ns` itself on the `time.monotonic_ns()` clock."""
        self._record(PH_COMPLETE, name, lineage, t0_ns, dur_ns)

    def span(
        self, name: str, lineage: Optional[dict] = None
    ) -> _TraceSpan:
        return _TraceSpan(self, name, lineage)

    # -- reading -----------------------------------------------------------

    def __len__(self) -> int:
        return min(self._n, self.capacity)

    @property
    def total_recorded(self) -> int:
        """Records ever written (>= len() once the ring has wrapped)."""
        return self._n

    def tail(self, n: Optional[int] = None) -> List[tuple]:
        """The last `n` records (default: everything retained), oldest
        first. Safe against concurrent writers."""
        with self._lock:
            count = min(self._n, self.capacity)
            if n is not None:
                count = min(n, count)
            start = self._n - count
            return [
                self._buf[i & self._mask]
                for i in range(start, self._n)
            ]

    def clear(self) -> None:
        with self._lock:
            self._n = 0
            self._buf = [None] * self.capacity

    # -- export ------------------------------------------------------------

    def to_chrome_events(
        self, records: Optional[List[tuple]] = None
    ) -> List[dict]:
        """Chrome-trace event dicts: components map to trace 'processes'
        (one row per pipeline stage in Perfetto), threads nest under
        them, lineage rides `args`."""
        records = self.tail() if records is None else records
        pids: Dict[str, int] = {}
        events: List[dict] = []
        thread_names = dict(self._thread_names)
        seen_tids = set()
        for ts_ns, dur_ns, phase, name, tid, lineage in records:
            component = name.split("/", 1)[0]
            pid = pids.setdefault(component, len(pids) + 1)
            ev: Dict[str, Any] = {
                "name": name,
                "cat": component,
                "ph": phase,
                "ts": ts_ns / 1e3,  # Chrome trace wants microseconds
                "pid": pid,
                "tid": tid,
            }
            if phase == PH_COMPLETE:
                ev["dur"] = dur_ns / 1e3
            elif phase == PH_INSTANT:
                ev["s"] = "t"  # thread-scoped instant
            if lineage:
                ev["args"] = dict(lineage)
            events.append(ev)
            seen_tids.add((pid, tid))
        meta: List[dict] = []
        label = self.process_label
        for component, pid in pids.items():
            meta.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": 0,
                    "args": {
                        "name": (
                            f"{label}/{component}" if label else component
                        )
                    },
                }
            )
        for pid, tid in sorted(seen_tids):
            tname = thread_names.get(tid)
            if tname:
                meta.append(
                    {
                        "name": "thread_name",
                        "ph": "M",
                        "pid": pid,
                        "tid": tid,
                        "args": {"name": tname},
                    }
                )
        return meta + events

    def export(self, path: str) -> int:
        """Write the retained records as Chrome-trace JSON (`{"traceEvents":
        [...]}`); returns the number of non-metadata events written."""
        events = self.to_chrome_events()
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(
                {"traceEvents": events, "displayTimeUnit": "ms"}, f
            )
        return sum(1 for e in events if e["ph"] != "M")


def validate_chrome_trace(obj: Any) -> List[str]:
    """Schema problems of a loaded Chrome-trace JSON object (empty =
    valid): a `traceEvents` list whose entries carry name/ph/ts/pid/tid,
    with `dur` on complete ("X") events."""
    problems: List[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be a dict with a 'traceEvents' list"]
    events = obj["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' must be a list"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i} is not a dict")
            continue
        missing = [
            k for k in ("name", "ph", "pid", "tid") if k not in ev
        ]
        if ev.get("ph") != "M" and "ts" not in ev:
            missing.append("ts")
        if missing:
            problems.append(f"event {i} missing {missing}")
        if ev.get("ph") == PH_COMPLETE and "dur" not in ev:
            problems.append(f"event {i}: complete event without 'dur'")
    return problems


_GLOBAL = FlightRecorder()


def get_recorder() -> FlightRecorder:
    """The process-global flight recorder (mirrors
    `registry.get_registry`)."""
    return _GLOBAL


def set_trace_enabled(enabled: bool) -> None:
    """Enable/disable the global recorder's hot path (records become one
    attribute load + branch). Retained records stay readable."""
    _GLOBAL.enabled = enabled


def mint_lineage_id(actor_id: int, seq: int) -> str:
    """The unroll lineage ID format — `a<actor>u<seq>` — one per unroll
    cycle of an actor."""
    return f"a{actor_id}u{seq}"
