"""Checkpoint files of the port: atomic, CRC-checked `.npz` (counterpart of
`torched_impala_tpu/utils/checkpoint.py`).

A port state is a nested dict whose leaves are tensors, numpy arrays or
ints. The learner's (`Learner.get_state`) is

    {"params": {name: tensor}, "opt_state": {"count": int, "nu": {name: tensor}},
     "num_frames": int, "num_steps": int}

with `name` the net's flat parameter name (`torso.Conv_0.weight`). A file
holds one `.npz` entry a leaf, named by the leaf's dict keys joined with
"/": `params/torso.Conv_0.weight`, `opt_state/nu/torso.Conv_0.weight`,
`opt_state/count`, `num_frames`, `num_steps`. Ints are stored as int64
0-d arrays.

Every file goes through `atomic_write_bytes` (tmp in the same directory,
flush, fsync, `os.replace`, fsync of the directory), so a crash mid-save
leaves at most an ignorable `.tmp.*` file, never a half-written
checkpoint; `load_state_file` reads every entry it needs, which checks
the zip CRCs, and raises `CheckpointCorruptError` on damage
(`allow_pickle=False`).

The synchronous `Checkpointer` keeps the JAX class's API. JAX builds it on
orbax's `CheckpointManager`; orbax is JAX's, so the port writes the same
`.npz` files as the async checkpointer, one a step, named
`step-<step>.npz` so that they never collide with the async
checkpointer's `ckpt-<step>.npz` in a shared directory.

The JAX state also carries the learner's PRNG key, `rng`, whose only
consumer is init (JAX `utils/checkpoint.py:14-27`). The port's learner
holds no generator, so `rng` is not in the port's state; actors re-derive
their generators from their seeds at every (re)start, as JAX's do.
"""

from __future__ import annotations

import io
import os
import re
from typing import Any, Mapping, Optional

import numpy as np
import torch


class CheckpointCorruptError(ValueError):
    """A checkpoint file failed to load because its bytes are damaged
    (truncated write, bit rot, or a writer that skipped the atomic
    protocol). The message names the file; the recovery scan falls back
    to the previous retained checkpoint (resilience/recovery.py)."""


def fsync_directory(directory: str) -> None:
    """fsync a directory so a just-renamed file's entry is durable."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds; the rename stays atomic
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write `data` to `path` atomically: tmp file in the same directory,
    flush + fsync, then os.replace. Readers never see a partial file; a
    failed write removes its tmp file and raises."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    fsync_directory(directory)


def flat_state(state: Mapping[str, Any], prefix: str = "") -> dict:
    """{"a/b/c": leaf} of a nested dict (module docstring)."""
    out = {}
    for key, value in state.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(flat_state(value, name + "/"))
        else:
            out[name] = value
    return out


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, (bool, int)):
        return np.asarray(leaf, np.int64)
    return np.asarray(leaf)


def save_state_file(path: str, state: Mapping[str, Any]) -> int:
    """Serialize a state dict to ONE `.npz` file, written atomically;
    returns the bytes written."""
    buf = io.BytesIO()
    np.savez(buf, **{k: _to_numpy(v) for k, v in flat_state(state).items()})
    data = buf.getvalue()
    atomic_write_bytes(path, data)
    return len(data)


def _like(array: np.ndarray, target: Any) -> Any:
    """A loaded entry in the form of the target's leaf."""
    if isinstance(target, torch.Tensor):
        return torch.from_numpy(array)
    if isinstance(target, (bool, int)) and array.ndim == 0:
        return int(array)
    return array


def _unflatten(flat: Mapping[str, Any], target: Mapping[str, Any], prefix: str = "") -> dict:
    return {
        k: _unflatten(flat, v, f"{prefix}{k}/") if isinstance(v, Mapping) else flat[f"{prefix}{k}"]
        for k, v in target.items()
    }


def load_state_file(path: str, target: Mapping[str, Any]) -> dict:
    """Load a `save_state_file` checkpoint into `target`'s structure.

    `target` gives the nested keys and the shapes the restored leaves are
    held to; tensor leaves come back as CPU tensors, int leaves as ints.
    Raises `CheckpointCorruptError` naming the file when it is truncated,
    fails its zip CRCs or lacks an entry the target needs, and
    `ValueError` when a leaf's shape differs from the target's."""
    wanted = flat_state(target)
    try:
        with np.load(path, allow_pickle=False) as data:
            available = set(data.files)
            loaded = {}
            for key, leaf in wanted.items():
                if key not in available:
                    raise CheckpointCorruptError(
                        f"checkpoint {path} is missing entry {key!r} "
                        f"(has {sorted(available)[:6]}...); the file is "
                        "corrupt or was written by an incompatible "
                        "config — resume from an earlier checkpoint"
                    )
                # Reading the entry checks its zip CRC: damage surfaces
                # here, not as garbage params.
                loaded[key] = _like(data[key], leaf)
    except CheckpointCorruptError:
        raise
    except Exception as e:
        raise CheckpointCorruptError(
            f"checkpoint {path} is corrupt or truncated "
            f"({type(e).__name__}: {e}); delete it and resume from an "
            "earlier retained checkpoint"
        ) from e
    restored = _unflatten(loaded, target)
    validate_restored_shapes(restored, target, what="checkpoint")
    return restored


# The known param-shape break of the JAX package, kept in every
# shape-mismatch message as JAX keeps it: round 5 changed
# AtariShallowTorso's conv padding SAME -> VALID, so the Dense after the
# flatten went from 7744 inputs to 3136 (the port's
# `torso.Dense_0.weight` is [512, 3136]).
_SHAPE_MISMATCH_HINT = (
    "Known cause: checkpoints written before round 5 used SAME-padded "
    "AtariShallowTorso convs (Dense_0 kernel 7744 rows; r5 switched to "
    "VALID padding, 3136 rows) — retrain or restore with the matching "
    "model revision."
)


def _shape(leaf: Any) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def validate_restored_shapes(
    restored: Mapping[str, Any], live: Mapping[str, Any], *, what: str = "state"
) -> None:
    """Raise a ValueError that lists every entry missing from `restored`,
    every entry `live` lacks and every shape that differs (the first 8,
    then a count), keyed by flat name, before anything is replaced.
    `Tensor.copy_` broadcasts, so a wrong shape must be refused here."""
    restored_shapes = {k: _shape(v) for k, v in flat_state(restored).items()}
    live_shapes = {k: _shape(v) for k, v in flat_state(live).items()}
    problems = []
    for key in sorted(set(restored_shapes) | set(live_shapes)):
        r, l = restored_shapes.get(key), live_shapes.get(key)
        if r is None:
            problems.append(f"{key}: missing from the restored tree")
        elif l is None:
            problems.append(f"{key}: not present in the live tree")
        elif r != l:
            problems.append(f"{key}: restored {r} vs live {l}")
    if problems:
        detail = "; ".join(problems[:8])
        if len(problems) > 8:
            detail += f"; ... ({len(problems) - 8} more)"
        raise ValueError(
            f"restored {what} tree does not match the live {what} "
            f"({detail}). {_SHAPE_MISMATCH_HINT}"
        )


_STEP_FILE_RE = re.compile(r"^step-(\d{12})\.npz$")


class Checkpointer:
    """Synchronous learner-state checkpoints, one `.npz` a step, with
    retention (the JAX class's API over its orbax manager).

    `save` writes before it returns; `wait` and `close` are there for the
    JAX API and have nothing to wait for."""

    def __init__(self, directory: str, *, max_to_keep: int = 3) -> None:
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step-{step:012d}.npz")

    def save(self, step: int, state: Mapping[str, Any]) -> bool:
        """Save unless `step` is at or below the newest saved step (orbax's
        policy at its default interval); returns whether it saved."""
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        save_state_file(self.path(step), state)
        steps = self.all_steps()
        if self.max_to_keep and len(steps) > self.max_to_keep:
            for old in steps[: -self.max_to_keep]:
                os.unlink(self.path(old))
        return True

    def restore(
        self, target: Mapping[str, Any], step: Optional[int] = None
    ) -> Optional[dict]:
        """Restore `step` (default: the newest) into `target`'s structure;
        None when no checkpoint exists."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        return load_state_file(self.path(step), target)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list:
        return sorted(
            int(m.group(1))
            for m in map(_STEP_FILE_RE.match, os.listdir(self.directory))
            if m
        )

    def wait(self) -> None:
        pass

    def close(self) -> None:
        pass
