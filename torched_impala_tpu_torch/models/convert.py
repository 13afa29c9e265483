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
  as the JAX `PallasLSTMCell` concatenates them (models/lstm.py).
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
        if kind == "bias":
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
        name = "weight" if kind == "kernel" else "bias"
        state[f"{module}.{name}"] = _tensor(value)
    return state
