"""The target network's params for IMPACT replay (counterpart of
`torched_impala_tpu/replay/target_store.py`).

`TargetParamStore` pins a copy of the learner params on the learner's
device every `update_interval` learner steps. It must be a copy: the
optimizer updates the master params in place (`optim.py`, multi-tensor
ops), so a held reference would move with the learner, the
learner/target ratio would stay 1 and the clip would never act. It stays
on the device: the surrogate reads it every step.

Telemetry: `replay/target_lag` (frames between the newest version the
learner reported and the pinned target) and `replay/target_updates` (the
refresh count). With `max_lag_frames > 0`, `current()` raises rather than
serve a target past the bound.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Mapping, Optional, Tuple

import torch

from torched_impala_tpu_torch.telemetry.registry import Registry, get_registry

if TYPE_CHECKING:
    from torched_impala_tpu_torch.runtime.param_store import ParamStore


class TargetParamStore:
    """Pins pi_target for the clipped surrogate.

    One writer: `update` and `maybe_update` run on the learner thread,
    which owns the live params, so the pinned dict is rebound at once and
    readers on that thread never see a torn (version, params) pair.
    """

    def __init__(
        self,
        store: "ParamStore",
        *,
        update_interval: int,
        max_lag_frames: int = 0,
        telemetry: Optional[Registry] = None,
    ) -> None:
        if update_interval < 1:
            raise ValueError(
                f"update_interval must be >= 1, got {update_interval}"
            )
        if max_lag_frames < 0:
            raise ValueError(
                f"max_lag_frames must be >= 0, got {max_lag_frames}"
            )
        self._store = store
        self.update_interval = int(update_interval)
        self.max_lag_frames = int(max_lag_frames)
        self._target: Optional[dict[str, torch.Tensor]] = None
        self._target_version = -1
        self._last_update_step: Optional[int] = None
        # The newest version the learner has reported; the store's
        # published version can trail it under publish_interval > 1, so
        # the lag is measured against the larger of the two.
        self._latest_version = -1
        reg = telemetry if telemetry is not None else get_registry()
        self._m_lag = reg.gauge("replay/target_lag")
        self._m_updates = reg.counter("replay/target_updates")

    def update(self, params: Mapping[str, torch.Tensor], *, version: int, step: int) -> None:
        """Pin `params` as the target: clones on their device, queued on
        the current stream (the train step's), so nothing waits for the
        device and the next in-place update cannot reach them."""
        with torch.no_grad():
            self._target = {k: p.detach().clone() for k, p in params.items()}
        self._target_version = int(version)
        self._latest_version = max(self._latest_version, int(version))
        self._last_update_step = int(step)
        self._m_updates.inc()
        self._m_lag.set(self.lag())

    def maybe_update(self, step: int, params: Mapping[str, torch.Tensor], version: int) -> bool:
        """Refresh when `update_interval` steps have passed since the last
        pin (the learner thread, once a step). Always advances the newest
        version, so the lag gauge and the refusal track the learner
        between refreshes."""
        self._latest_version = max(self._latest_version, int(version))
        if (
            self._last_update_step is None
            or step - self._last_update_step >= self.update_interval
        ):
            self.update(params, version=version, step=step)
            return True
        self._m_lag.set(self.lag())
        return False

    def lag(self) -> int:
        """Frames between the newest known version and the pinned target."""
        newest = max(self._latest_version, self._store.version)
        return max(0, newest - self._target_version)

    @property
    def version(self) -> int:
        return self._target_version

    def current(self) -> Tuple[int, dict[str, torch.Tensor]]:
        """(version, params on the device) of the pinned target.

        Raises RuntimeError before the first `update`, or, with
        `max_lag_frames` set, once the target is past the bound (a
        refresh cadence wired wrong must fail, not train against an old
        policy)."""
        if self._target is None:
            raise RuntimeError(
                "TargetParamStore.current() before the first update(); "
                "pin the initial params at learner construction"
            )
        lag = self.lag()
        self._m_lag.set(lag)
        if self.max_lag_frames > 0 and lag > self.max_lag_frames:
            raise RuntimeError(
                f"target params are {lag} frames stale (version "
                f"{self._target_version} vs newest "
                f"{max(self._latest_version, self._store.version)}), "
                f"beyond max_lag_frames={self.max_lag_frames}; the "
                f"update cadence is mis-wired"
            )
        return self._target_version, self._target
