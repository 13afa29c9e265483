"""Calling an env factory (counterpart of `call_env_factory` in
`torched_impala_tpu/envs/factory.py`; the port keeps its own copy).

The env pool's worker processes unpickle a factory and build their envs
through this function, so it imports nothing beyond the standard library.
"""

from __future__ import annotations

import inspect
from typing import Callable


def call_env_factory(factory: Callable, seed: int, env_index=None):
    """Invoke a `(seed)` or `(seed, env_index)` env factory uniformly.

    The runtime passes the global env index so that multi-task presets
    cover every task whatever the seed strides; single-argument factories
    are still accepted."""
    try:
        takes_index = len(inspect.signature(factory).parameters) >= 2
    except (TypeError, ValueError):
        takes_index = False
    if takes_index:
        return factory(seed, env_index)
    return factory(seed)
