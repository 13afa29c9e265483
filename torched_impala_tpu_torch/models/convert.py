"""Carry the JAX package's flax params across to the port.

`params_from_jax` takes the flax param tree of an `ImpalaNet` as numpy
arrays (`jax.tree.map(np.asarray, params)`, with or without the outer
`{"params": ...}`) and returns a `state_dict` for the port's `ImpalaNet`
of the same configuration. The port's submodules keep the flax names, so
the mapping is by path: `torso/Conv_0/kernel` -> `torso.Conv_0.weight`.

- conv kernels are HWIO in flax and OIHW in torch;
- Dense kernels are `[in, out]` in flax and `[out, in]` in torch; the
  rows of the Dense after the conv flatten stay in flax's (h, w, c)
  order because the port's forward flattens NHWC (models/torsos.py);
- the deep torso's nested names map as they are
  (`torso/ResidualBlock_3/Conv_1/kernel` -> `torso.ResidualBlock_3.Conv_1.weight`);
- the LSTM's eight flax `DenseParams` (`lstm/{ii,if,ig,io}/kernel`,
  `lstm/{hi,hf,hg,ho}/{kernel,bias}`) are concatenated along the last
  axis in gate order (i, f, g, o) into `lstm.wi`, `lstm.wh`, `lstm.b`,
  as the JAX `PallasLSTMCell` concatenates them (models/lstm.py);
- the transformer core's tree maps by path as it is
  (`transformer/block_0/q_proj/kernel` -> `transformer.block_0.q_proj.weight`,
  `transformer/ln_kv_1/scale` -> `transformer.ln_kv_1.weight`): a flax
  LayerNorm's `scale` is torch's `weight`.

`state_from_jax` carries a whole JAX learner state across
(`Learner.get_state()` as numpy arrays) into the port's `get_state()`
shape: the params as above, optax's RMSProp `nu` mapped exactly as the
params are (it has their tree), the schedule's step count (optax keeps
none under a constant lr, where it equals `num_steps`), `num_frames` and
`num_steps`. The JAX `rng` has no counterpart (utils/checkpoint.py).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()) -> dict:
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


_GATES = ("i", "f", "g", "o")


def _tensor(value: np.ndarray) -> torch.Tensor:
    # np.array copies: the port owns (and may write) its tensors.
    return torch.from_numpy(np.array(value, dtype=np.float32, order="C"))


def _lstm_params(lstm: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    def cat(kind, leaf):
        return _tensor(
            np.concatenate([np.asarray(lstm[f"{kind}{g}"][leaf]) for g in _GATES], -1)
        )

    return {
        "lstm.wi": cat("i", "kernel"),
        "lstm.wh": cat("h", "kernel"),
        "lstm.b": cat("h", "bias"),
    }


def params_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    tree = dict(tree)
    state = _lstm_params(tree.pop("lstm")) if "lstm" in tree else {}
    for path, leaf in _flatten(tree).items():
        module, kind = ".".join(path[:-1]), path[-1]
        if kind in ("bias", "scale"):
            value = leaf
        elif kind == "kernel" and leaf.ndim == 4:
            value = leaf.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif kind == "kernel" and leaf.ndim == 2:
            value = leaf.T  # [in, out] -> [out, in]
        else:
            raise ValueError(
                f"params_from_jax: no mapping for {'/'.join(path)} "
                f"with shape {leaf.shape}"
            )
        name = "bias" if kind == "bias" else "weight"
        state[f"{module}.{name}"] = _tensor(value)
    return state


def _opt_field(opt_state: tuple, field: str):
    """`field` of the first state of an optax chain that has one."""
    for sub in opt_state:
        if field in getattr(sub, "_fields", ()):
            return getattr(sub, field)
    return None


def state_from_jax(state: Mapping[str, Any]) -> dict:
    """A JAX `Learner.get_state()` (numpy leaves) as the port's
    `Learner.get_state()` dict (module docstring)."""
    nu = _opt_field(state["opt_state"], "nu")
    if nu is None:
        raise ValueError("state_from_jax: the JAX opt_state holds no RMSProp nu")
    count = _opt_field(state["opt_state"], "count")
    num_steps = int(np.asarray(state["num_steps"]))
    return {
        "params": params_from_jax(state["params"]),
        "opt_state": {
            "count": num_steps if count is None else int(np.asarray(count)),
            "nu": params_from_jax(nu),
        },
        "num_frames": int(np.asarray(state["num_frames"])),
        "num_steps": num_steps,
    }
