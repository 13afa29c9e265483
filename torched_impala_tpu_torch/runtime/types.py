"""Trajectory container shared by actors, the batcher and the learner
(counterpart of `torched_impala_tpu/runtime/types.py`).

Time-major, one env's unroll, numpy on the host side. It carries T+1
observations and first-flags so the learner can bootstrap from the last
step, and the recurrent state the unroll started from.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np


class QueueClosed(Exception):
    """Raised by enqueue once the learner has shut down; actors exit on it."""


class Trajectory(NamedTuple):
    """One unroll of length T.

    Attributes:
      obs: `[T+1, ...]`; obs[T] is the bootstrap observation.
      first: bool `[T+1]`, set where obs[t] starts an episode.
      actions: int32 `[T]` actions taken at obs[:T].
      behaviour_logits: float32 `[T, A]` actor-policy logits at act time.
      rewards: float32 `[T]` rewards following each action.
      cont: float32 `[T]` continuation flags (1 - done); the learner
        multiplies by gamma to get the discounts.
      agent_state: recurrent state at obs[0]: `(c [1, H], h [1, H])`
        float32 for the LSTM core, () for feedforward nets. A stacked
        batch holds `(c [B, H], h [B, H])`.
      actor_id: which actor produced this unroll.
      param_version: frame-count stamp of the params used to act.
    """

    obs: np.ndarray
    first: np.ndarray
    actions: np.ndarray
    behaviour_logits: np.ndarray
    rewards: np.ndarray
    cont: np.ndarray
    agent_state: Any
    actor_id: int = 0
    param_version: int = 0
