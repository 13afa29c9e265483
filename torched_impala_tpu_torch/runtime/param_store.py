"""Versioned parameter publication from learner to actors (counterpart of
`torched_impala_tpu/runtime/param_store.py`, latest-version cell only).

The learner publishes `(version, params)` under a lock, with the frame
count as the version; actors poll. `publish` stores a detached CLONE of
every tensor, so actor threads never read a tensor that the optimizer is
updating in place. A published dict is never mutated afterwards: `get`
hands out the shared reference.
"""

from __future__ import annotations

import threading
from typing import Mapping, Optional

import torch


class ParamStore:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._published = threading.Event()
        self._version = -1
        self._params: dict[str, torch.Tensor] = {}

    def publish(self, version: int, params: Mapping[str, torch.Tensor]) -> None:
        snapshot = {k: v.detach().clone() for k, v in params.items()}
        with self._lock:
            self._version = version
            self._params = snapshot
        self._published.set()

    @property
    def version(self) -> int:
        """The latest published version (-1 before the first publish)."""
        with self._lock:
            return self._version

    def get(
        self, timeout: Optional[float] = None
    ) -> tuple[int, dict[str, torch.Tensor]]:
        """Latest (version, params); blocks until the first publish."""
        if not self._published.wait(timeout=timeout):
            raise TimeoutError("no params published yet")
        with self._lock:
            return self._version, self._params
