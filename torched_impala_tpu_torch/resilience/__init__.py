"""Resilience of the port (counterpart of `torched_impala_tpu/resilience/`):
the async checkpointer (`checkpointer.AsyncCheckpointer`), run manifests
and the recovery scan (`recovery`), and the chaos fault plans (`chaos`).
"""

from torched_impala_tpu_torch.resilience.chaos import (
    ChaosError,
    ChaosInjector,
    ChaosPlan,
    Fault,
    corrupt_file,
)
from torched_impala_tpu_torch.resilience.checkpointer import AsyncCheckpointer
from torched_impala_tpu_torch.resilience.recovery import (
    HostCountMismatch,
    ResumeConfigMismatch,
    RunManifest,
    config_fingerprint,
    list_manifest_steps,
    load_manifest,
    restore_latest,
    write_manifest,
)

__all__ = [
    "AsyncCheckpointer",
    "ChaosError",
    "ChaosInjector",
    "ChaosPlan",
    "Fault",
    "corrupt_file",
    "HostCountMismatch",
    "RunManifest",
    "ResumeConfigMismatch",
    "config_fingerprint",
    "list_manifest_steps",
    "load_manifest",
    "restore_latest",
    "write_manifest",
]
