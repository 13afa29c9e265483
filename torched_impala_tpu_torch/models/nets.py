"""ImpalaNet: torso + policy/value heads (counterpart of
`torched_impala_tpu/models/nets.py:ImpalaNet` with `core="none"`).

Two modes share the params:
- step:   obs `[B, ...]` for actors;
- unroll: obs `[T, B, ...]`, time-major, for the learner; the torso runs
  once over the flattened `[T*B, ...]` batch.

The heads always run in float32 (the torso's bf16 output is cast back);
the value head is one wide (PopArt's per-task width is not ported yet).
The recurrent cores (LSTM, transformer) are not ported yet and raise.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch import nn

from torched_impala_tpu_torch.models.torsos import init_dense_

NetState = Any  # () for feedforward nets.


class NetOutput(NamedTuple):
    """Policy logits `[..., A]` and values `[..., 1]`, float32."""

    policy_logits: torch.Tensor
    values: torch.Tensor


class ImpalaNet(nn.Module):
    def __init__(
        self,
        num_actions: int,
        torso: nn.Module,
        core: str = "none",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if core != "none":
            raise NotImplementedError(
                f"core={core!r} is not ported yet (ROADMAP.md queue 1, item 6 "
                "and queue 2: the LSTM and transformer cores)"
            )
        self.num_actions = num_actions
        self.torso = torso
        features = torso.feature_size
        self.policy_head = nn.Linear(features, num_actions)
        self.value_head = nn.Linear(features, 1)
        init_dense_(self.policy_head, generator)
        init_dense_(self.value_head, generator)

    def initial_state(self, batch_size: int) -> NetState:
        return ()

    def forward(
        self,
        obs: torch.Tensor,
        first: torch.Tensor,
        state: NetState,
        unroll: bool = False,
    ) -> tuple[NetOutput, NetState]:
        """`first` (episode starts) only drives recurrent cores, which
        this slice does not have; it is accepted for the common API."""
        if unroll:
            t, b = obs.shape[:2]
            features = self.torso(obs.reshape(t * b, *obs.shape[2:]))
            features = features.reshape(t, b, -1)
        else:
            features = self.torso(obs)
        core_out = features.float()
        out = NetOutput(
            policy_logits=self.policy_head(core_out),
            values=self.value_head(core_out),
        )
        return out, state
