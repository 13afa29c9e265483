"""Training-health diagnostics plane, host side (a copy of
`torched_impala_tpu/telemetry/health.py`).

The loss and the learner emit `health_*` log keys on the train step's
tensors (ops/losses.py:health_diagnostics_logs: V-trace rho/c clip
fractions and the pre-clip IS-weight log-histogram, policy entropy,
behaviour->learner KL, value explained variance;
runtime/learner.py:_health_step_logs: per-group gradient norms and
update-to-weight ratios). They reach the host with the learner's
log-interval floats, and :class:`HealthMonitor`

- republishes them as ``health/*`` gauges in the telemetry registry,
- derives the two host-side series that need cross-step state: the
  grad-norm spike ratio (current unclipped norm over its EWMA) and the
  staleness-vs-clip-fraction Pearson correlation,
- feeds :func:`health_slo_specs` rows (entropy collapse, rho
  saturation, explained-variance collapse, grad-norm spike, shadow
  mismatch) through its own burn-rate :class:`AlertEngine`,
- and on each 0->1 alert transition (or a learner crash, via
  :meth:`HealthMonitor.on_crash`) writes an anomaly postmortem bundle
  through :class:`PostmortemWriter`: flight-recorder tail, last-N
  health snapshots, the offending batch's lineage, config fingerprint,
  in one atomically-renamed ``postmortems/<ts>_<reason>/`` directory.

The bundle's file names, schema version and manifest keys are the JAX
package's, so its `tools/postmortem.py` renders a bundle the port wrote.
The port's learner keeps no PRNG key, so its bundles carry ``"rng":
null``, as its run manifests do.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import sys
import time
import traceback
from collections import deque
from typing import (
    Any,
    Callable,
    Deque,
    Dict,
    List,
    Mapping,
    Optional,
    Sequence,
)

from torched_impala_tpu_torch.telemetry.alerts import AlertEngine, SloSpec
from torched_impala_tpu_torch.telemetry.registry import (
    PREFIX,
    Registry,
    get_registry,
)
from torched_impala_tpu_torch.telemetry.tracing import get_recorder

# Log keys carrying this prefix (emitted inside the jitted train step)
# are republished as `health/<rest>` gauges by HealthMonitor.observe.
HEALTH_LOG_PREFIX = "health_"

BUNDLE_SCHEMA_VERSION = 1
BUNDLE_MANIFEST = "postmortem.json"
BUNDLE_TRACE = "flight_tail.json"
BUNDLE_SNAPSHOTS = "snapshots.jsonl"

_REASON_RE = re.compile(r"[^a-z0-9_]+")


def health_slo_specs(
    *,
    entropy_floor: float = 0.05,
    rho_saturation_frac: float = 0.5,
    ev_floor: float = 0.0,
    grad_spike_ratio: float = 10.0,
    shadow_mismatch_rate: float = 0.05,
    fast_window_s: float = 30.0,
    slow_window_s: float = 300.0,
) -> List[SloSpec]:
    """The stock learning-health objective table.
    Rows only sample when their key is present in the snapshot, so the
    one table serves every run shape — a run without shadow scoring
    simply never samples the shadow row."""
    return [
        # Policy entropy under the floor = premature determinism
        # (IMPALA arXiv:1802.01561 uses an entropy bonus precisely to
        # keep this from collapsing early).
        SloSpec(
            name="entropy_collapse",
            key="health/entropy_mean",
            objective=entropy_floor,
            kind="lower",
            budget=0.25,
            fast_window_s=fast_window_s,
            slow_window_s=slow_window_s,
        ),
        # Most rho weights clipping = the learner is too far off-policy
        # for V-trace to correct (the IMPACT arXiv:1912.00167 regime
        # where more reuse stops paying).
        SloSpec(
            name="rho_saturation",
            key="health/clip_rho_frac",
            objective=rho_saturation_frac,
            budget=0.25,
            fast_window_s=fast_window_s,
            slow_window_s=slow_window_s,
        ),
        # Baseline explaining none of the target variance = the critic
        # is not tracking, pg advantages are noise.
        SloSpec(
            name="ev_collapse",
            key="health/ev_value",
            objective=ev_floor,
            kind="lower",
            budget=0.25,
            fast_window_s=fast_window_s,
            slow_window_s=slow_window_s,
        ),
        # Unclipped grad norm >> its own EWMA = loss-surface spike
        # (the global-norm clip hides these from the update, not from
        # the diagnosis).
        SloSpec(
            name="grad_norm_spike",
            key="health/grad_spike_ratio",
            objective=grad_spike_ratio,
            budget=0.1,
            fast_window_s=fast_window_s,
            slow_window_s=slow_window_s,
        ),
        # Shadow-scored candidate diverging from the primary on live
        # traffic (the serving plane's windowed rate; the promotion
        # gate's paging signal).
        SloSpec(
            name="shadow_mismatch",
            key="serving/shadow_mismatch_rate",
            objective=shadow_mismatch_rate,
            budget=0.2,
            fast_window_s=fast_window_s,
            slow_window_s=slow_window_s,
        ),
    ]


def _pearson(pairs: Sequence[tuple]) -> float:
    """Pearson r over (x, y) pairs; 0.0 when either side is constant
    (an all-fresh window has staleness variance 0 — "no
    correlation evidence", not NaN)."""
    n = len(pairs)
    if n < 2:
        return 0.0
    mx = sum(p[0] for p in pairs) / n
    my = sum(p[1] for p in pairs) / n
    sxx = sum((p[0] - mx) ** 2 for p in pairs)
    syy = sum((p[1] - my) ** 2 for p in pairs)
    if sxx <= 0.0 or syy <= 0.0:
        return 0.0
    sxy = sum((p[0] - mx) * (p[1] - my) for p in pairs)
    return sxy / math.sqrt(sxx * syy)


def _jsonable(x: Any) -> Any:
    """Best-effort JSON projection for bundle payloads (configs carry
    nested dataclasses and enums; lineage carries tuples)."""
    import dataclasses

    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {
            f.name: _jsonable(getattr(x, f.name))
            for f in dataclasses.fields(x)
        }
    if hasattr(x, "_asdict"):  # NamedTuple
        return {k: _jsonable(v) for k, v in x._asdict().items()}
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, (str, bool)) or x is None:
        return x
    if isinstance(x, (int, float)):
        return x if not isinstance(x, float) or math.isfinite(x) else repr(x)
    try:
        return float(x)  # numpy / torch scalars
    except (TypeError, ValueError):
        return repr(x)


class PostmortemWriter:
    """Writes one anomaly bundle per trigger into
    ``<root>/<ts>_<reason>/`` — staged in a dot-tmp sibling directory
    and published with a single ``os.replace``, so a reader (or a crash
    mid-write) never observes a partial bundle (the directory-level
    sibling of utils/checkpoint.atomic_write_bytes).

    Bundle layout:
      postmortem.json  — manifest: reason, wall/monotonic timestamps,
                         firing alerts + burn rates, first-breach table,
                         offending BatchLineage, config fingerprint +
                         JSON projection, RNG key data (null from the
                         port's learner), counters, error
                         traceback (crash bundles).
      flight_tail.json — Chrome-trace export of the flight recorder's
                         last `trace_tail` records (Perfetto-loadable).
      snapshots.jsonl  — the monitor's last-N health snapshot rows,
                         oldest first.
    """

    def __init__(
        self,
        root: str = "postmortems",
        *,
        recorder=None,
        trace_tail: int = 512,
        max_bundles: int = 16,
    ) -> None:
        self.root = root
        self._recorder = recorder
        self.trace_tail = int(trace_tail)
        self.max_bundles = int(max_bundles)

    def write(
        self,
        reason: str,
        *,
        error: Optional[BaseException] = None,
        firing: Sequence[str] = (),
        burn_rates: Optional[Mapping[str, float]] = None,
        first_breach: Optional[Mapping[str, Mapping]] = None,
        snapshots: Sequence[Mapping] = (),
        lineage=None,
        config=None,
        rng=None,
        counters: Optional[Mapping[str, Any]] = None,
    ) -> str:
        """Assemble and atomically publish one bundle; returns its
        final directory path."""
        reason = _REASON_RE.sub("_", str(reason).lower()).strip("_") or "anomaly"
        os.makedirs(self.root, exist_ok=True)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        base = f"{stamp}_{reason}"
        final = os.path.join(self.root, base)
        seq = 1
        while os.path.exists(final):
            seq += 1
            final = os.path.join(self.root, f"{base}_{seq}")
        tmp = os.path.join(
            self.root, f".tmp_{os.path.basename(final)}_{os.getpid()}"
        )
        os.makedirs(tmp)
        try:
            fingerprint = None
            if config is not None:
                from torched_impala_tpu_torch.resilience.recovery import (
                    config_fingerprint,
                )

                fingerprint = config_fingerprint(config)
            manifest = {
                "schema_version": BUNDLE_SCHEMA_VERSION,
                "reason": reason,
                "wall_time": time.time(),
                "wall_time_iso": time.strftime(
                    "%Y-%m-%dT%H:%M:%S%z", time.localtime()
                ),
                "monotonic": time.monotonic(),
                "firing": list(firing),
                "burn_rates": _jsonable(dict(burn_rates or {})),
                "first_breach": _jsonable(dict(first_breach or {})),
                "lineage": _jsonable(lineage),
                "config_fingerprint": fingerprint,
                "config": _jsonable(config) if config is not None else None,
                "rng": None if rng is None else [int(w) for w in rng],
                "counters": _jsonable(dict(counters or {})),
                "error": (
                    "".join(
                        traceback.format_exception(
                            type(error), error, error.__traceback__
                        )
                    )
                    if error is not None
                    else None
                ),
            }
            with open(os.path.join(tmp, BUNDLE_MANIFEST), "w") as f:
                json.dump(manifest, f, indent=2, sort_keys=True)
            rec = self._recorder if self._recorder is not None else get_recorder()
            tail = rec.tail(self.trace_tail)
            doc = {
                "traceEvents": rec.to_chrome_events(tail),
                "displayTimeUnit": "ms",
            }
            with open(os.path.join(tmp, BUNDLE_TRACE), "w") as f:
                json.dump(doc, f)
            with open(os.path.join(tmp, BUNDLE_SNAPSHOTS), "w") as f:
                for row in snapshots:
                    f.write(json.dumps(_jsonable(row)) + "\n")
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._prune()
        return final

    def _prune(self) -> None:
        """Keep the newest `max_bundles` bundles (a flapping alert must
        not fill the disk); stale dot-tmp stagings from crashed writers
        are swept too."""
        try:
            entries = sorted(
                e
                for e in os.listdir(self.root)
                if os.path.isdir(os.path.join(self.root, e))
            )
        except OSError:
            return
        for e in entries:
            if e.startswith(".tmp_"):
                shutil.rmtree(os.path.join(self.root, e), ignore_errors=True)
        bundles = [e for e in entries if not e.startswith(".tmp_")]
        for e in bundles[: max(0, len(bundles) - self.max_bundles)]:
            shutil.rmtree(os.path.join(self.root, e), ignore_errors=True)


class HealthMonitor:
    """Host-side half of the training-health plane. The learner calls
    :meth:`observe` with each log-interval's already-materialized float
    dict (runtime/learner.py:Learner.step_once — the health plane adds
    no device sync of its own) plus the batch's lineage; the monitor owns
    the ``health/*`` gauges, the derived spike/correlation series, the
    burn-rate engine over :func:`health_slo_specs`, the last-N snapshot
    ring, and postmortem triggering."""

    def __init__(
        self,
        *,
        specs: Optional[Sequence[SloSpec]] = None,
        registry: Optional[Registry] = None,
        recorder=None,
        postmortem: Optional[PostmortemWriter] = None,
        history: int = 256,
        grad_ewma_alpha: float = 0.1,
        corr_window: int = 64,
        corr_min_samples: int = 8,
    ) -> None:
        self._registry = registry if registry is not None else get_registry()
        self.engine = AlertEngine(
            list(specs) if specs is not None else health_slo_specs(),
            registry=self._registry,
            recorder=recorder,
        )
        self.postmortem = postmortem
        self.snapshots: Deque[Dict[str, Any]] = deque(maxlen=history)
        self.first_breach: Dict[str, Dict[str, Any]] = {}
        self.last_lineage = None
        self.bundles: List[str] = []
        self._gauges: Dict[str, Any] = {}
        self._grad_ewma: Optional[float] = None
        self._grad_alpha = float(grad_ewma_alpha)
        self._corr: Deque[tuple] = deque(maxlen=corr_window)
        self._corr_min = int(corr_min_samples)
        self._crash_written = False
        self._config = None
        self._get_rng: Optional[Callable[[], Any]] = None
        self._get_counters: Optional[Callable[[], Mapping]] = None

    # -- context the postmortem needs (bound by Learner.attach_health) --

    def bind_context(
        self,
        *,
        config=None,
        get_rng: Optional[Callable[[], Any]] = None,
        get_counters: Optional[Callable[[], Mapping]] = None,
    ) -> None:
        self._config = config
        self._get_rng = get_rng
        self._get_counters = get_counters

    def _gauge(self, name: str):
        g = self._gauges.get(name)
        if g is None:
            g = self._registry.gauge(name)
            self._gauges[name] = g
        return g

    # -- the per-log-interval entry point -------------------------------

    def observe(
        self,
        logs: Mapping[str, Any],
        *,
        lineage=None,
        now: Optional[float] = None,
    ) -> List[str]:
        """Publish one log-interval's health series, evaluate the alert
        table, and write a postmortem per 0->1 firing transition.
        Returns the names that fired on this pass."""
        t = time.monotonic() if now is None else now
        for k, v in logs.items():
            if not k.startswith(HEALTH_LOG_PREFIX):
                continue
            try:
                fv = float(v)
            except (TypeError, ValueError):
                continue
            if math.isfinite(fv):
                self._gauge("health/" + k[len(HEALTH_LOG_PREFIX):]).set(fv)
        g = logs.get("grad_norm_unclipped")
        if g is not None:
            try:
                g = float(g)
            except (TypeError, ValueError):
                g = None
        if g is not None and math.isfinite(g):
            base = self._grad_ewma if self._grad_ewma is not None else g
            self._gauge("health/grad_spike_ratio").set(g / max(base, 1e-12))
            self._grad_ewma = (
                (1.0 - self._grad_alpha) * base + self._grad_alpha * g
            )
        clip = logs.get("health_clip_rho_frac")
        staleness = getattr(lineage, "staleness", -1) if lineage is not None else -1
        if clip is not None and staleness is not None and staleness >= 0:
            self._corr.append((float(staleness), float(clip)))
            if len(self._corr) >= self._corr_min:
                self._gauge("health/staleness_clip_corr").set(
                    _pearson(list(self._corr))
                )
        if lineage is not None:
            self.last_lineage = lineage

        snap = self._registry.snapshot()
        row: Dict[str, Any] = {"t": t}
        for counter_key in ("num_steps", "num_frames"):
            if counter_key in logs:
                row[counter_key] = logs[counter_key]
        for key, value in snap.items():
            head = key[len(PREFIX) + 1:] if key.startswith(PREFIX + "/") else ""
            if head.startswith(("health/", "alerts/")):
                row[key] = value
        for spec in self.engine.specs:
            skey = f"{PREFIX}/{spec.key}"
            if skey in snap:
                row[skey] = snap[skey]
        self.snapshots.append(row)

        for spec in self.engine.specs:
            if spec.name in self.first_breach:
                continue
            value = snap.get(f"{PREFIX}/{spec.key}")
            if value is None or (
                isinstance(value, float) and math.isnan(value)
            ):
                continue
            if spec.is_bad(float(value)):
                self.first_breach[spec.name] = {
                    "t": t,
                    "key": spec.key,
                    "value": float(value),
                    "step": logs.get("num_steps"),
                }
        fired = self.engine.evaluate(snap, t)
        for name in fired:
            self._write_bundle(f"alert_{name}")
        return fired

    # -- crash / bundle plumbing ----------------------------------------

    def on_crash(self, error: BaseException) -> Optional[str]:
        """Learner crash hook (runtime/learner.py:Learner.run): one bundle per
        monitor lifetime — a crash storm during teardown must not spam
        bundles for the same root cause."""
        if self._crash_written:
            return None
        self._crash_written = True
        return self._write_bundle("crash", error=error)

    def _write_bundle(
        self, reason: str, *, error: Optional[BaseException] = None
    ) -> Optional[str]:
        if self.postmortem is None:
            return None
        try:
            path = self.postmortem.write(
                reason,
                error=error,
                firing=self.engine.firing(),
                burn_rates=self.engine.burn_rates(),
                first_breach=self.first_breach,
                snapshots=list(self.snapshots),
                lineage=self.last_lineage,
                config=self._config,
                rng=self._get_rng() if self._get_rng is not None else None,
                counters=(
                    self._get_counters()
                    if self._get_counters is not None
                    else None
                ),
            )
        except Exception:
            # The health plane is strictly optional: a full disk or a
            # torn recorder must never take down the learner it watches.
            print(
                "health: postmortem write failed:\n"
                + traceback.format_exc(),
                file=sys.stderr,
                flush=True,
            )
            return None
        self.bundles.append(path)
        return path
