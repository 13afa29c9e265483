"""RMSProp with optax semantics and the learning-rate schedule (counterpart
of `torched_impala_tpu/configs.py:make_lr_schedule, make_optimizer`,
which build `optax.rmsprop`).

optax's rmsprop (no centering, no momentum):

    nu     = decay * nu + (1 - decay) * g**2        (nu starts at 0)
    update = g * rsqrt(nu + eps)                    (eps INSIDE the sqrt)
    p      = p - lr(count) * update,  count = 0, 1, ...

`torch.optim.RMSprop` computes `g / (sqrt(nu) + eps)`, eps outside the
sqrt, which differs markedly while nu is small; it must not stand in.
The moments are float32 whatever the compute dtype (ops/precision.py).
"""

from __future__ import annotations

from typing import Callable, Mapping, Union

import torch

from torched_impala_tpu_torch.ops import precision
from torched_impala_tpu_torch.utils.checkpoint import validate_restored_shapes

Schedule = Union[float, Callable[[int], float]]


def linear_schedule(init_value: float, end_value: float, transition_steps: int):
    """optax.linear_schedule: init -> end over `transition_steps`, then flat."""

    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


class RMSProp:
    def __init__(self, lr: Schedule, decay: float = 0.9, eps: float = 1e-8) -> None:
        self.lr = lr
        self.decay = decay
        self.eps = eps
        self.count = 0
        self.nu: dict[str, torch.Tensor] = {}

    def init(self, params: Mapping[str, torch.Tensor]) -> None:
        self.count = 0
        self.nu = {
            k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()
        }

    @torch.no_grad()
    def step(
        self,
        params: Mapping[str, torch.Tensor],
        grads: Mapping[str, torch.Tensor],
    ) -> None:
        """Update `params` in place from `grads`; advances the count."""
        lr = self.lr(self.count) if callable(self.lr) else float(self.lr)
        for k, p in params.items():
            g = grads[k]
            nu = self.nu[k]
            nu.mul_(self.decay).add_((1.0 - self.decay) * torch.square(g))
            p.sub_(lr * (g * torch.rsqrt(nu + self.eps)))
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "nu": {k: v.clone() for k, v in self.nu.items()}}

    def load_state_dict(self, state: Mapping) -> None:
        """Copy a `state_dict()` in; its `nu` must have the live names and
        shapes (`copy_` would broadcast a wrong shape) and be float32, both
        checked before any tensor is written."""
        validate_restored_shapes(state["nu"], self.nu, what="optimizer nu")
        precision.assert_f32_accumulators(
            {"optimizer_state": state["nu"].values()}, context="RMSProp.load_state_dict"
        )
        for k, v in state["nu"].items():
            self.nu[k].copy_(v)
        self.count = int(state["count"])
