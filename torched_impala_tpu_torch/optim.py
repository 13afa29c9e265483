"""RMSProp with optax semantics and the learning-rate schedules
(counterpart of `optax.rmsprop` and of the optax schedules that
`torched_impala_tpu/configs.py:make_lr_schedule, make_optimizer` build).

optax's rmsprop (no centering, no momentum):

    nu     = (1 - decay) * g**2 + decay * nu        (nu starts at 0)
    update = g * rsqrt(nu + eps)                    (eps INSIDE the sqrt)
    p      = p + (-lr(count)) * update,  count = 0, 1, ...

`torch.optim.RMSprop` computes `g / (sqrt(nu) + eps)`, eps outside the
sqrt, which differs markedly while nu is small; it must not stand in.
The moments are float32 whatever the compute dtype (ops/precision.py).

The step is multi-tensor: params, grads and `nu` are lists in one fixed
order (the names' order at `init`), and each line of the formula is one
`torch._foreach_*` op over all of them, a few launches a step whatever
the number of tensors, in place of a few a tensor. Each op rounds as
optax's elementwise line does, in the same order.
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence, Union

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


def constant_schedule(value: float):
    """optax.constant_schedule."""
    return lambda count: value


def join_schedules(schedules: Sequence[Callable[[int], float]], boundaries: Sequence[int]):
    """optax.join_schedules: `schedules[i + 1]` takes over at
    `boundaries[i]`, indexed from that boundary."""

    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = fn(count - boundary)
        return out

    return schedule


class RMSProp:
    def __init__(self, lr: Schedule, decay: float = 0.9, eps: float = 1e-8) -> None:
        self.lr = lr
        self.decay = decay
        self.eps = eps
        self.count = 0
        self.nu: dict[str, torch.Tensor] = {}
        # The learning rate of the last step taken.
        self.last_lr: float | None = None

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
    ) -> list[torch.Tensor]:
        """Update `params` in place from `grads`; advances the count.
        Returns the updates added, `-lr * g * rsqrt(nu + eps)` in the
        params' order (optax's `updates`)."""
        ps = [params[k] for k in self.nu]
        gs = [grads[k] for k in self.nu]
        nus = list(self.nu.values())
        lr = self.lr(self.count) if callable(self.lr) else float(self.lr)
        sq = torch._foreach_mul(gs, gs)
        torch._foreach_mul_(sq, 1.0 - self.decay)
        torch._foreach_mul_(nus, self.decay)
        torch._foreach_add_(nus, sq)
        update = torch._foreach_add(nus, self.eps)
        torch._foreach_rsqrt_(update)
        torch._foreach_mul_(update, gs)
        torch._foreach_mul_(update, -lr)
        torch._foreach_add_(ps, update)
        self.last_lr = lr
        self.count += 1
        return update

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
