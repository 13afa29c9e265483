"""Agent: the two-mode policy API over an ImpalaNet (counterpart of
`torched_impala_tpu/models/agent.py`).

The JAX agent is a pure function of explicit params; here the params live
in the net (`nn.Module`), so each actor thread holds its own `clone()`
and loads published params into it, while the learner owns the master
copy. Sampling draws from an explicit `torch.Generator` on the net's
device; it does not reproduce `jax.random.categorical`'s samples, so the
tests feed actions made with numpy instead.
"""

from __future__ import annotations

import copy
from typing import Mapping, NamedTuple

import torch

from torched_impala_tpu_torch.models.nets import ImpalaNet, NetOutput, NetState


class AgentOutput(NamedTuple):
    """One acting step: sampled actions `[B]` (int64), the behaviour logits
    `[B, A]` to store, and the next recurrent state."""

    action: torch.Tensor
    policy_logits: torch.Tensor
    state: NetState


class Agent:
    def __init__(self, net: ImpalaNet) -> None:
        self.net = net

    def clone(self) -> "Agent":
        """An agent over a private copy of the net (for an actor thread)."""
        return Agent(copy.deepcopy(self.net))

    def load_params(self, params: Mapping[str, torch.Tensor]) -> None:
        self.net.load_state_dict(params)

    def initial_state(self, batch_size: int) -> NetState:
        return self.net.initial_state(batch_size)

    @torch.no_grad()
    def step(
        self,
        obs: torch.Tensor,
        first: torch.Tensor,
        state: NetState,
        generator: torch.Generator,
    ) -> AgentOutput:
        """Sample one action per row: obs `[B, ...]`, first `[B]`."""
        out, state = self.net(obs, first, state)
        probs = torch.softmax(out.policy_logits, dim=-1)
        action = torch.multinomial(probs, 1, generator=generator)[:, 0]
        return AgentOutput(
            action=action, policy_logits=out.policy_logits, state=state
        )

    def unroll(
        self, obs: torch.Tensor, first: torch.Tensor, state: NetState
    ) -> tuple[NetOutput, NetState]:
        """Learner re-forward: obs `[T, B, ...]`, first `[T, B]`."""
        return self.net(obs, first, state, unroll=True)
