"""In-process metrics registry: counters, gauges, EWMA timers, histograms
(a copy of `torched_impala_tpu/telemetry/registry.py`, which imports no
JAX; the port keeps its own so that it never imports the JAX package).

Every pipeline stage records into ONE process-global registry;
`snapshot()` flattens everything into namespaced scalar keys
(`telemetry/<component>/<name>`). Hot-path cost discipline:
- one metric object per call site, resolved ONCE at component
  construction — the hot path never does a dict lookup or name parse;
- each metric has its own small lock (a counter increment never contends
  with a histogram observe in another thread);
- no allocation on record: counters/gauges/timers mutate scalars,
  histograms mutate a preallocated bucket-count list;
- a disabled registry short-circuits every record with one attribute
  load + branch.

Snapshot-while-writing is safe: readers take each metric's lock just long
enough to copy its scalars, so a snapshot taken mid-increment sees either
the old or the new value, never a torn one.

Metric names are `<component>/<name>` slugs (lowercase, digits,
underscores); the emitted key is `telemetry/<component>/<name>[_suffix]`.
The registry enforces the pattern and refuses to re-register a name with
a different type.
"""

from __future__ import annotations

import bisect
import math
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

PREFIX = "telemetry"

# <component>/<name>: lowercase slugs only, exactly one slash. Suffixes the
# metrics append (_ms, _p95, _count, ...) keep the emitted key inside the
# same grammar.
NAME_RE = re.compile(r"^[a-z][a-z0-9_]*/[a-z][a-z0-9_]*$")

# Default histogram bucket upper edges, in milliseconds: log-ish spacing
# covering sub-ms jit dispatch up to multi-second stalls. Observations
# above the last edge land in the implicit +inf bucket.
DEFAULT_MS_BUCKETS: Tuple[float, ...] = (
    0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
    100.0, 200.0, 500.0, 1000.0, 2000.0, 5000.0,
)


def _check_name(name: str) -> None:
    if not NAME_RE.match(name):
        raise ValueError(
            f"metric name {name!r} must match <component>/<name> "
            f"({NAME_RE.pattern})"
        )


class _Metric:
    """Base: every metric knows its registry (for the enabled check) and
    emits (key, value) pairs into a snapshot dict."""

    kind = "metric"

    def __init__(self, registry: "Registry", name: str):
        self._registry = registry
        self.name = name
        self._lock = threading.Lock()

    def snapshot_into(self, out: Dict[str, float]) -> None:
        raise NotImplementedError


class Counter(_Metric):
    """Monotonic count (restarts, waves, stalls)."""

    kind = "counter"

    def __init__(self, registry: "Registry", name: str):
        super().__init__(registry, name)
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def snapshot_into(self, out: Dict[str, float]) -> None:
        out[f"{PREFIX}/{self.name}"] = self.value


class Gauge(_Metric):
    """Last-value metric (queue depth, wave size). `fn` makes it lazy: the
    callable is evaluated at snapshot time (e.g. a live `qsize()`), so the
    hot path never pays for it."""

    kind = "gauge"

    def __init__(
        self,
        registry: "Registry",
        name: str,
        fn: Optional[Callable[[], float]] = None,
    ):
        super().__init__(registry, name)
        self._value = float("nan")
        self._fn = fn

    def set(self, value: float) -> None:
        if not self._registry.enabled:
            return
        # Single attribute store: GIL-atomic, so no lock on the hot path
        # (a snapshot sees either the old or the new float, never torn).
        self._value = float(value)

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                return float("nan")
        return self._value

    def snapshot_into(self, out: Dict[str, float]) -> None:
        out[f"{PREFIX}/{self.name}"] = self.value


class EwmaTimer(_Metric):
    """EWMA of observed durations, emitted in milliseconds as
    `<name>_ms` plus a lifetime `<name>_calls` count. The `span()` context
    manager records into one of these."""

    kind = "timer"

    def __init__(
        self, registry: "Registry", name: str, alpha: float = 0.2
    ):
        super().__init__(registry, name)
        self._alpha = alpha
        self._ewma_s: Optional[float] = None
        self._calls = 0

    def observe(self, seconds: float) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self._calls += 1
            if self._ewma_s is None:
                self._ewma_s = seconds
            else:
                a = self._alpha
                self._ewma_s = (1.0 - a) * self._ewma_s + a * seconds

    def time(self) -> "_SpanContext":
        return _SpanContext(self)

    @property
    def ewma_ms(self) -> float:
        with self._lock:
            return (
                float("nan") if self._ewma_s is None
                else self._ewma_s * 1e3
            )

    @property
    def calls(self) -> int:
        with self._lock:
            return self._calls

    def snapshot_into(self, out: Dict[str, float]) -> None:
        with self._lock:
            ewma = self._ewma_s
            calls = self._calls
        out[f"{PREFIX}/{self.name}_ms"] = (
            float("nan") if ewma is None else ewma * 1e3
        )
        out[f"{PREFIX}/{self.name}_calls"] = calls


class _SpanContext:
    """`with registry.span("learner/train_step"): ...` — time the block
    into the underlying EwmaTimer. Reusable and re-entrant-free by design
    (allocate one per `with`, the only per-span allocation)."""

    __slots__ = ("_timer", "_t0")

    def __init__(self, timer: EwmaTimer):
        self._timer = timer
        self._t0 = 0.0

    def __enter__(self) -> "_SpanContext":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self._timer.observe(time.monotonic() - self._t0)


class Histogram(_Metric):
    """Fixed-bucket latency histogram. Bucket edges are UPPER bounds
    (inclusive); one implicit +inf bucket catches the tail. Snapshot emits
    `<name>_p50` / `<name>_p95` / `<name>_p99` (linear interpolation
    inside the winning bucket; the +inf bucket reports the observed max),
    `<name>_mean`, `<name>_max`, and `<name>_count`."""

    kind = "histogram"

    def __init__(
        self,
        registry: "Registry",
        name: str,
        buckets: Sequence[float] = DEFAULT_MS_BUCKETS,
    ):
        super().__init__(registry, name)
        edges = tuple(float(e) for e in buckets)
        if not edges or any(
            b <= a for a, b in zip(edges, edges[1:])
        ):
            raise ValueError(
                f"histogram buckets must be non-empty and strictly "
                f"increasing, got {buckets!r}"
            )
        self.edges = edges
        self._counts = [0] * (len(edges) + 1)  # +1: the +inf bucket
        self._count = 0
        self._sum = 0.0
        self._max = float("-inf")

    def observe(self, value: float) -> None:
        if not self._registry.enabled:
            return
        i = bisect.bisect_left(self.edges, value)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += value
            if value > self._max:
                self._max = value

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def _state(self):
        with self._lock:
            return list(self._counts), self._count, self._sum, self._max

    def percentile(self, q: float) -> float:
        """Estimate the q-quantile (0 < q <= 1) from bucket counts: find
        the bucket holding the q*count-th observation and interpolate
        linearly inside it, clamped to the observed max (interpolation
        toward a bucket's upper edge can otherwise exceed every actual
        observation — no real quantile can). The +inf bucket reports the
        max observed."""
        counts, total, _, mx = self._state()
        if total == 0:
            return float("nan")
        rank = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            prev_cum = cum
            cum += c
            if cum >= rank:
                if i == len(self.edges):  # +inf bucket
                    return mx
                lo = 0.0 if i == 0 else self.edges[i - 1]
                hi = self.edges[i]
                frac = (rank - prev_cum) / c if c else 1.0
                return min(lo + frac * (hi - lo), mx)
        return mx

    def snapshot_into(self, out: Dict[str, float]) -> None:
        counts, total, sm, mx = self._state()
        base = f"{PREFIX}/{self.name}"
        out[f"{base}_count"] = total
        if total == 0:
            out[f"{base}_mean"] = float("nan")
            out[f"{base}_max"] = float("nan")
            out[f"{base}_p50"] = float("nan")
            out[f"{base}_p95"] = float("nan")
            out[f"{base}_p99"] = float("nan")
            return
        out[f"{base}_mean"] = sm / total
        out[f"{base}_max"] = mx
        out[f"{base}_p50"] = self.percentile(0.50)
        out[f"{base}_p95"] = self.percentile(0.95)
        out[f"{base}_p99"] = self.percentile(0.99)


class Registry:
    """Thread-safe metric registry + heartbeat board.

    One process-global instance (`get_registry()`) is shared by every
    pipeline stage; fresh instances serve tests and benchmarks. Metric
    getters are create-or-return: N call sites asking for the same name
    share one metric object, and asking with a DIFFERENT metric type (or
    a malformed name) raises at the call site instead of silently forking
    the series.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._heartbeats: Dict[str, float] = {}

    # -- registration ----------------------------------------------------

    def _get(self, cls, name: str, *args, **kwargs):
        _check_name(name)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(self, name, *args, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"cannot re-register as {cls.kind}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get(Counter, name)

    def gauge(
        self, name: str, fn: Optional[Callable[[], float]] = None
    ) -> Gauge:
        g = self._get(Gauge, name)
        if fn is not None:
            g._fn = fn
        return g

    def timer(self, name: str, alpha: float = 0.2) -> EwmaTimer:
        return self._get(EwmaTimer, name, alpha)

    def histogram(
        self, name: str, buckets: Sequence[float] = DEFAULT_MS_BUCKETS
    ) -> Histogram:
        return self._get(Histogram, name, buckets)

    def span(self, name: str) -> _SpanContext:
        """Context manager timing a block into `timer(name)` (emitted as
        `telemetry/<name>_ms` EWMA + `_calls`)."""
        return self.timer(name).time()

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    # -- heartbeats (stall watchdog feed) --------------------------------

    def heartbeat(self, component: str) -> None:
        """Record liveness for `component` (learner step done, actor wave
        done). The stall watchdog fires when NO component heartbeats
        within its deadline. Lock-free: a single dict store is GIL-atomic
        and this runs once per wave/step on every hot thread."""
        if not self.enabled:
            return
        self._heartbeats[component] = time.monotonic()

    def heartbeats(self) -> Dict[str, float]:
        return dict(self._heartbeats)

    def last_heartbeat(self) -> Optional[float]:
        """monotonic() time of the most recent heartbeat from ANY
        component; None before the first."""
        # dict() is a single C-level copy under the GIL — safe against a
        # concurrent heartbeat insert (bare .values() iteration is not).
        beats = dict(self._heartbeats)
        if not beats:
            return None
        return max(beats.values())

    # -- snapshot --------------------------------------------------------

    def snapshot(self, drop_nan: bool = False) -> Dict[str, float]:
        """Flatten every registered metric into `telemetry/...` keys.
        Safe to call while writers record (per-metric locks; a metric
        registered mid-snapshot simply lands in the next one).

        `drop_nan=True` removes not-yet-observed series (empty histograms
        / unset gauges) — useful for print logging; schema-sensitive
        backends (CSV) prefer the stable full key set."""
        out: Dict[str, float] = {}
        for m in self.metrics():
            m.snapshot_into(out)
        if drop_nan:
            out = {
                k: v
                for k, v in out.items()
                if not (isinstance(v, float) and math.isnan(v))
            }
        return out


_GLOBAL = Registry()


def get_registry() -> Registry:
    """The process-global registry every pipeline stage records into."""
    return _GLOBAL


def set_enabled(enabled: bool) -> None:
    """Enable/disable the global registry's hot-path recording (records
    become one attribute load + branch). Snapshot still works; existing
    values freeze."""
    _GLOBAL.enabled = enabled
