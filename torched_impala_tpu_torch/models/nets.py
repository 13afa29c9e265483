"""ImpalaNet: torso + optional temporal core + policy/value heads
(counterpart of `torched_impala_tpu/models/nets.py:ImpalaNet` with
`core="none"`, `core="lstm"` (`lstm_impl="fused"`) or
`core="transformer"`).

Two modes share the params:
- step:   obs `[B, ...]`, first `[B]` for actors;
- unroll: obs `[T, B, ...]`, first `[T, B]`, time-major, for the learner;
  the torso runs once over the flattened `[T*B, ...]` batch, the LSTM
  core once per step in a Python loop, the transformer core once over
  the whole unroll (step mode is its T = 1 unroll).

With `remat_torso`, an unroll that builds a graph runs the torso with
`remat=True` (models/torsos.py: each stage through a non-reentrant
`torch.utils.checkpoint`): its activations are not kept for the
backward, which runs the torso's forward again (the JAX `nn.remat`). The
torso stays the same submodule, so the param names are unchanged; a step
under no grad (the actors) runs the torso once, as without remat.

The LSTM core runs in float32 (a bf16 torso's features are cast up) and
zeroes the carry rows where `first` is set before each cell step: the
`hk.ResetCore` semantics of the JAX `_core_step`. The transformer core
(models/transformer.py) resets by segment ids instead and carries a KV
cache. The heads always run in float32, also on bf16 params (the
params are cast up, as flax's Dense promotes them). The value head is
`num_values` wide: 1, or one normalized value a task under PopArt
(`ops/popart.py`, whose `rescale_params` reads `value_head.weight` `[K, F]`
and `value_head.bias` `[K]` by these names).

`bound_params` runs the net on other tensors than its own params: the
learner's bf16 train step binds the params that `ops/precision.py:
cast_to_compute` lowered from the f32 masters, for the forward and the
backward both (a rematerialized torso runs its forward again in the
backward)."""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, Mapping, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from torched_impala_tpu_torch.models.lstm import LSTMCell
from torched_impala_tpu_torch.models.torsos import init_dense_
from torched_impala_tpu_torch.models.transformer import TransformerCore

# (c, h) for the LSTM core, a TransformerCoreState for the transformer
# core, () for feedforward nets.
NetState = Any


class NetOutput(NamedTuple):
    """Policy logits `[..., A]` and values `[..., num_values]`, float32."""

    policy_logits: torch.Tensor
    values: torch.Tensor


@contextlib.contextmanager
def bound_params(net: nn.Module, tensors: Mapping[str, torch.Tensor]) -> Iterator[None]:
    """Within the block, `net`'s parameter `name` reads as `tensors[name]`
    (any tensor, in the graph of whatever made it); the params come back
    on exit. The net must not be shared with another thread meanwhile."""
    saved = []
    try:
        for name, tensor in tensors.items():
            owner, _, leaf = name.rpartition(".")
            module = net.get_submodule(owner)
            saved.append((module, leaf, module._parameters[leaf]))
            module._parameters[leaf] = tensor
        yield
    finally:
        for module, leaf, param in reversed(saved):
            module._parameters[leaf] = param


def _linear_f32(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A head in float32 whatever its params' dtype."""
    return F.linear(x, layer.weight.float(), layer.bias.float())


def _reset_carry(carry, first: torch.Tensor):
    """Zero the carry rows where `first` `[B]` is set."""
    keep = ~first[:, None]
    return tuple(torch.where(keep, x, 0.0) for x in carry)


class ImpalaNet(nn.Module):
    def __init__(
        self,
        num_actions: int,
        torso: nn.Module,
        core: str = "none",
        lstm_size: int = 256,
        generator: Optional[torch.Generator] = None,
        transformer: Optional[dict] = None,
        remat_torso: bool = False,
        num_values: int = 1,
    ) -> None:
        """`transformer`: `TransformerCore` keyword arguments, used when
        core="transformer"; `remat_torso`: rematerialize the torso in the
        learner's backward (module docstring); `num_values`: the value
        head's width (1, or num_tasks under PopArt)."""
        super().__init__()
        self.remat_torso = remat_torso
        self.num_values = num_values
        if core not in ("none", "lstm", "transformer"):
            raise ValueError(f"unknown core {core!r}")
        self.num_actions = num_actions
        self.core = core
        self.torso = torso
        features = torso.feature_size
        if core == "lstm":
            self.lstm = LSTMCell(features, lstm_size, generator)
            features = lstm_size
        elif core == "transformer":
            self.transformer = TransformerCore(
                features, **(transformer or {}), generator=generator
            )
            features = self.transformer.d_model
        self.policy_head = nn.Linear(features, num_actions)
        self.value_head = nn.Linear(features, num_values)
        init_dense_(self.policy_head, generator)
        init_dense_(self.value_head, generator)

    def straight_through_params(self) -> tuple[str, ...]:
        """The params whose bf16 train-step gradients reach the f32 masters
        unrounded: the LSTM cell's, whose fused backward (JAX's custom
        VJP) returns float32 grads for bf16 primals."""
        if self.core != "lstm":
            return ()
        return tuple(f"lstm.{name}" for name, _ in self.lstm.named_parameters())

    def initial_state(self, batch_size: int) -> NetState:
        """Zero carry `(c, h)`, each f32 `[B, lstm_size]`, or a fresh
        `TransformerCoreState`, on the net's device; () without a core."""
        device = self.policy_head.weight.device
        if self.core == "none":
            return ()
        if self.core == "transformer":
            return self.transformer.initial_state(batch_size, device)
        shape = (batch_size, self.lstm.hidden_size)
        return tuple(torch.zeros(shape, device=device) for _ in range(2))

    def forward(
        self,
        obs: torch.Tensor,
        first: torch.Tensor,
        state: NetState,
        unroll: bool = False,
    ) -> tuple[NetOutput, NetState]:
        """Apply the net: obs `[B, ...]` / `[T, B, ...]`, first bool `[B]` /
        `[T, B]` (episode starts, which reset the core), state from
        `initial_state` or a previous call. Returns (NetOutput, state)."""
        if unroll:
            t, b = obs.shape[:2]
            flat = obs.reshape(t * b, *obs.shape[2:])
            remat = self.remat_torso and torch.is_grad_enabled()
            features = self.torso(flat, remat=remat).reshape(t, b, -1)
        else:
            features = self.torso(obs)
        core_out = features.float()
        if self.core == "lstm":
            if unroll:
                outs = []
                for step in range(core_out.shape[0]):
                    state, out = self.lstm(
                        _reset_carry(state, first[step]), core_out[step]
                    )
                    outs.append(out)
                core_out = torch.stack(outs)
            else:
                state, core_out = self.lstm(_reset_carry(state, first), core_out)
        elif self.core == "transformer":
            if unroll:
                core_out, state = self.transformer(features, first, state)
            else:
                core_out, state = self.transformer(features[None], first[None], state)
                core_out = core_out[0]
        out = NetOutput(
            policy_logits=_linear_f32(self.policy_head, core_out),
            values=_linear_f32(self.value_head, core_out),
        )
        return out, state
