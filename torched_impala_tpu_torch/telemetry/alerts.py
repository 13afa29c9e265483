"""SLO burn-rate alerting over a telemetry snapshot (a copy of
`SloSpec` and `AlertEngine` from `torched_impala_tpu/telemetry/alerts.py`).

Each evaluation classifies the current sample of a spec's key good or
bad, and the *burn rate* over a window is

    burn(window) = bad_fraction(window) / budget

i.e. how many times faster than allowed the error budget is being spent
(budget 0.1 -> up to 10% bad samples is within SLO). An alert fires only
when BOTH the fast and the slow window burn above the threshold: the fast
window makes a sustained breach fire quickly, while the slow window keeps
a brief spike from paging. A coverage gate (history must span one fast
window) keeps a just-started engine from firing on its first sample.

The engine emits, per spec `name`, gauges `alerts/firing_<name>` (0/1)
and `alerts/burn_rate_<name>` (the slow-window burn) into the registry,
and a `telemetry/alert` flight-recorder instant on each firing
transition.
"""

from __future__ import annotations

import math
import re
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Mapping, Optional, Tuple

from torched_impala_tpu_torch.telemetry.registry import (
    PREFIX,
    Registry,
    get_registry,
)
from torched_impala_tpu_torch.telemetry.tracing import get_recorder

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")


@dataclass(frozen=True)
class SloSpec:
    """One objective. `key` is the snapshot key WITHOUT the telemetry/
    prefix, e.g. health/entropy_mean.

    kind="upper": samples with value > objective are bad (latency,
    occupancy, lag). kind="lower": value < objective is bad (overlap
    fractions, throughput floors). Missing/NaN samples are skipped —
    no data is neither good nor bad."""

    name: str
    key: str
    objective: float
    kind: str = "upper"
    budget: float = 0.1
    fast_window_s: float = 30.0
    slow_window_s: float = 300.0
    burn_threshold: float = 1.0

    def __post_init__(self):
        if not _NAME_RE.match(self.name):
            raise ValueError(f"bad SloSpec name {self.name!r}")
        if self.kind not in ("upper", "lower"):
            raise ValueError(f"bad SloSpec kind {self.kind!r}")
        if not 0.0 < self.budget <= 1.0:
            raise ValueError(f"budget must be in (0, 1]: {self.budget}")
        if self.fast_window_s <= 0 or self.slow_window_s < self.fast_window_s:
            raise ValueError(
                "need 0 < fast_window_s <= slow_window_s, got "
                f"{self.fast_window_s}/{self.slow_window_s}"
            )

    def is_bad(self, value: float) -> bool:
        if self.kind == "upper":
            return value > self.objective
        return value < self.objective


@dataclass
class _SpecState:
    samples: Deque[Tuple[float, bool]] = field(default_factory=deque)
    firing: bool = False
    fast_burn: float = 0.0
    slow_burn: float = 0.0


class AlertEngine:
    """Evaluates a SloSpec table against successive snapshots and owns
    the alerts/* gauges. Call `evaluate(snap)` on the log interval
    (or any steady cadence); read `firing()` for the active set."""

    def __init__(
        self,
        specs: List[SloSpec],
        registry: Optional[Registry] = None,
        recorder=None,
    ):
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SloSpec names: {names}")
        self.specs = list(specs)
        self._registry = registry if registry is not None else get_registry()
        self._recorder = recorder
        self._state: Dict[str, _SpecState] = {
            s.name: _SpecState() for s in self.specs
        }
        # Gauge metric names are built from validated spec names, so
        # they always satisfy the registry's NAME_RE.
        self._g_firing = {
            s.name: self._registry.gauge(f"alerts/firing_{s.name}")
            for s in self.specs
        }
        self._g_burn = {
            s.name: self._registry.gauge(f"alerts/burn_rate_{s.name}")
            for s in self.specs
        }
        for g in self._g_firing.values():
            g.set(0.0)
        for g in self._g_burn.values():
            g.set(0.0)

    def _burn(
        self, spec: SloSpec, state: _SpecState, now: float, window_s: float
    ) -> float:
        lo = now - window_s
        n = bad = 0
        for t, is_bad in state.samples:
            if t >= lo:
                n += 1
                bad += is_bad
        if n == 0:
            return 0.0
        return (bad / n) / spec.budget

    def evaluate(
        self, snap: Mapping[str, float], now: Optional[float] = None
    ) -> List[str]:
        """One evaluation pass; returns the names that fired on THIS
        pass (0->1 transitions)."""
        t = time.monotonic() if now is None else now
        transitions: List[str] = []
        for spec in self.specs:
            state = self._state[spec.name]
            value = snap.get(f"{PREFIX}/{spec.key}")
            if value is not None and not (
                isinstance(value, float) and math.isnan(value)
            ):
                state.samples.append((t, spec.is_bad(float(value))))
            lo = t - spec.slow_window_s
            while state.samples and state.samples[0][0] < lo:
                state.samples.popleft()
            state.fast_burn = self._burn(spec, state, t, spec.fast_window_s)
            state.slow_burn = self._burn(spec, state, t, spec.slow_window_s)
            # Coverage gate: with a near-empty history a single bad
            # sample saturates both windows (n=1 -> burn 1/budget), so
            # a fresh engine would page on its first evaluation. Only
            # fire once the retained history spans at least one fast
            # window — a sustained breach therefore fires after
            # ~fast_window_s, never instantly.
            span = (
                state.samples[-1][0] - state.samples[0][0]
                if state.samples
                else 0.0
            )
            firing = (
                span >= spec.fast_window_s
                and state.fast_burn > spec.burn_threshold
                and state.slow_burn > spec.burn_threshold
            )
            if firing != state.firing:
                state.firing = firing
                if firing:
                    transitions.append(spec.name)
                rec = (
                    self._recorder
                    if self._recorder is not None
                    else get_recorder()
                )
                mark = {
                    "alert": spec.name,
                    "firing": int(firing),
                    "burn_rate": round(state.slow_burn, 3),
                }
                rec.instant("telemetry/alert", mark)
            self._g_firing[spec.name].set(float(state.firing))
            self._g_burn[spec.name].set(state.slow_burn)
        return transitions

    def firing(self) -> List[str]:
        return [n for n, s in self._state.items() if s.firing]

    def burn_rates(self) -> Dict[str, float]:
        return {n: s.slow_burn for n, s in self._state.items()}

    def format_status(self) -> str:
        """One line for watchdog dumps: the firing set with burns."""
        firing = [
            f"{n}(burn={self._state[n].slow_burn:.2f})"
            for n in sorted(self.firing())
        ]
        return "alerts firing: " + (", ".join(firing) if firing else "none")
