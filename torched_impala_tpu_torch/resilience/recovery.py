"""Crash-consistent resume: run manifests and the recovery scan
(counterpart of `torched_impala_tpu/resilience/recovery.py`).

Every async checkpoint save writes a JSON run manifest next to its state
file, through the same atomic tmp + fsync + rename write
(utils/checkpoint.py), so after a crash the directory holds a consistent
(manifest, checkpoint) pair for every retained step:

    ckpt-000000000020.npz        # save_state_file (atomic, CRC-checked)
    manifest-000000000020.json   # RunManifest     (atomic)
    MANIFEST.json                # copy of the newest manifest

The manifest keeps JAX's field names, so either package reads a manifest
the other wrote; the port writes `rng` as null (its state has no PRNG
key, utils/checkpoint.py).

`restore_latest` walks the manifests newest first, refuses a mismatched
`config_hash` (restoring the optimizer state and step counters into
another experiment desynchronizes the lr schedule and the frame budget),
and falls back, with a line on stderr, to the previous retained
checkpoint when the newest state file fails its CRCs
(`CheckpointCorruptError`). `Learner.set_state` then republishes the
params at the restored version. The host-count check is ported as
logic; the port runs one host until its multi-process training lands
(ROADMAP.md queue 1: DP and multi-process training).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import sys
from typing import Any, List, Optional, Tuple

from torched_impala_tpu_torch.utils.checkpoint import (
    CheckpointCorruptError,
    atomic_write_bytes,
    load_state_file,
)

MANIFEST_RE = re.compile(r"^manifest-(\d{12})\.json$")
CHECKPOINT_FMT = "ckpt-{step:012d}.npz"
MANIFEST_FMT = "manifest-{step:012d}.json"
LATEST_MANIFEST = "MANIFEST.json"

_FORMAT_VERSION = 1


class HostCountMismatch(RuntimeError):
    """A resume into a host count over which the checkpointed run's global
    batch does not divide: its batch semantics cannot be kept. A host
    count that still divides the batch is restored, with a line on
    stderr."""


class ResumeConfigMismatch(RuntimeError):
    """A resume pointed at checkpoints written under a different config
    (hash mismatch). Restoring the optimizer state and step counters into
    a changed experiment desynchronizes the lr schedule and frame budget;
    pick the matching config or a fresh checkpoint directory."""


def config_fingerprint(config: Any) -> str:
    """Stable hash of a config: dataclasses flatten to sorted-key JSON
    (nested dataclasses included, other leaves by repr), so equal configs
    hash equal across processes."""

    def jsonable(x):
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return {f.name: jsonable(getattr(x, f.name)) for f in dataclasses.fields(x)}
        if isinstance(x, dict):
            return {str(k): jsonable(v) for k, v in sorted(x.items())}
        if isinstance(x, (list, tuple)):
            return [jsonable(v) for v in x]
        if isinstance(x, (str, int, float, bool)) or x is None:
            return x
        return repr(x)

    blob = json.dumps(jsonable(config), sort_keys=True)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class RunManifest:
    """One checkpoint's resume metadata (JSON round-trippable)."""

    step: int
    param_version: int
    checkpoint: str  # state filename, relative to the manifest's directory
    config_hash: Optional[str] = None
    rng: Optional[List[int]] = None  # JAX's key data; None from the port
    saved_at: float = 0.0  # unix seconds
    format: int = _FORMAT_VERSION
    # Processes in the run that wrote this checkpoint.
    host_count: int = 1

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, blob: str) -> "RunManifest":
        obj = json.loads(blob)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in obj.items() if k in known})


def manifest_path(directory: str, step: int) -> str:
    return os.path.join(directory, MANIFEST_FMT.format(step=step))


def checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(directory, CHECKPOINT_FMT.format(step=step))


def write_manifest(directory: str, manifest: RunManifest) -> str:
    """Atomically write the step's manifest and refresh `MANIFEST.json`;
    returns the step's path. The state file must already be on disk: a
    manifest never points at a checkpoint that does not exist."""
    blob = manifest.to_json().encode("utf-8")
    path = manifest_path(directory, manifest.step)
    atomic_write_bytes(path, blob)
    atomic_write_bytes(os.path.join(directory, LATEST_MANIFEST), blob)
    return path


def load_manifest(path: str) -> RunManifest:
    try:
        with open(path, encoding="utf-8") as f:
            return RunManifest.from_json(f.read())
    except (OSError, ValueError, TypeError) as e:
        raise CheckpointCorruptError(
            f"run manifest {path} is unreadable "
            f"({type(e).__name__}: {e}); resume will fall back to an "
            "earlier retained checkpoint"
        ) from e


def list_manifest_steps(directory: str) -> List[int]:
    """Retained steps with a manifest on disk, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(m.group(1)) for m in map(MANIFEST_RE.match, os.listdir(directory)) if m
    )


def restore_latest(
    directory: str,
    target: Any,
    *,
    config_hash: Optional[str] = None,
    host_count: Optional[int] = None,
    global_batch_size: Optional[int] = None,
) -> Optional[Tuple[RunManifest, Any]]:
    """The newest loadable (manifest, state) pair of `directory`, or None
    when it holds no manifest (a fresh run).

    Raises `ResumeConfigMismatch` when the first readable manifest's
    config hash differs from `config_hash` (both present); skips, with a
    line on stderr, manifests and checkpoints that fail to load; raises
    `CheckpointCorruptError` when every retained checkpoint is damaged.
    With `host_count` and `global_batch_size`, a checkpoint of another
    host count restores while the global batch divides over this run's
    hosts, else raises `HostCountMismatch`."""
    steps = list_manifest_steps(directory)
    if not steps:
        return None
    last_error: Optional[BaseException] = None
    hash_checked = False
    for step in reversed(steps):
        try:
            manifest = load_manifest(manifest_path(directory, step))
        except CheckpointCorruptError as e:
            last_error = e
            print(f"[resume] {e}", file=sys.stderr, flush=True)
            continue
        # The hash is checked on the first READABLE manifest: a corrupt
        # checkpoint is recoverable, a wrong config is not.
        if (
            not hash_checked
            and config_hash is not None
            and manifest.config_hash is not None
            and manifest.config_hash != config_hash
        ):
            raise ResumeConfigMismatch(
                f"checkpoints in {directory} were written under config "
                f"hash {manifest.config_hash} but this run's config "
                f"hashes to {config_hash}. Refusing to resume: restoring "
                "opt state/step counters across configs desynchronizes "
                "the lr schedule and frame budget. Use the original "
                "config, or point --checkpoint-dir at a fresh directory."
            )
        if not hash_checked and host_count is not None and manifest.host_count != host_count:
            if global_batch_size is not None and global_batch_size % host_count:
                raise HostCountMismatch(
                    f"checkpoints in {directory} were written by a "
                    f"{manifest.host_count}-host run; this run has "
                    f"{host_count} hosts and the global batch "
                    f"{global_batch_size} does not divide over them, so "
                    "the restored run's batch semantics cannot be "
                    "preserved. Resume with a host count that divides "
                    "the global batch, or start fresh."
                )
            print(
                f"[resume] checkpoint written by a {manifest.host_count}-host "
                f"run restoring into a {host_count}-host run; the params are "
                "replicated, so they restore on every host",
                file=sys.stderr,
                flush=True,
            )
        hash_checked = True
        ckpt = os.path.join(directory, manifest.checkpoint)
        try:
            state = load_state_file(ckpt, target)
        except CheckpointCorruptError as e:
            last_error = e
            print(
                f"[resume] step {step} checkpoint unusable, falling back "
                f"to the previous retained step: {e}",
                file=sys.stderr,
                flush=True,
            )
            continue
        return manifest, state
    raise CheckpointCorruptError(
        f"every retained checkpoint in {directory} is unreadable "
        f"(steps {steps}); last error: {last_error}"
    )


def prune(directory: str, keep: int) -> List[int]:
    """Delete (manifest, checkpoint) pairs beyond the newest `keep`;
    returns the pruned steps. `MANIFEST.json` is never touched."""
    steps = list_manifest_steps(directory)
    doomed = steps[:-keep] if keep > 0 else []
    for step in doomed:
        for path in (manifest_path(directory, step), checkpoint_path(directory, step)):
            try:
                os.unlink(path)
            except OSError:
                pass
    return doomed
