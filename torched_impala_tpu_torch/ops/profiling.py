"""Read kernel device times and launch grids from torch.profiler.

Shared by `chip_smoke.py`, `ops/compare_builds.py` and the `gpu` tests.
Every function needs a CUDA card; nothing here runs at import.
"""

from __future__ import annotations

import json
import os
import tempfile
import warnings

import torch


def _cuda_rows(fn, calls):
    """The profiler's CUDA-kernel rows over `calls` calls of `fn`. Only
    rows of device type CUDA count: a CPU op's row repeats the time of the
    kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return [
            avg
            for avg in prof.key_averages()
            if avg.device_type == DeviceType.CUDA
            and not getattr(avg, "is_user_annotation", False)
        ]


def device_us(fn, calls=50, name=None):
    """(device µs, kernel launches) per call of `fn` from torch.profiler,
    over the CUDA kernels whose name contains `name` (every kernel when
    `name` is None); (None, None) when the profiler saw no device time."""
    rows = [avg for avg in _cuda_rows(fn, calls) if name is None or name in avg.key]
    total = sum(avg.self_device_time_total for avg in rows)
    if not total:
        return None, None
    return total / calls, sum(avg.count for avg in rows) / calls


def device_us_by_kernel(fn, calls=50):
    """{kernel name: device µs a call} of every CUDA kernel `fn` runs."""
    return {avg.key: avg.self_device_time_total / calls for avg in _cuda_rows(fn, calls)}


def launched_grids(fn, name):
    """The grid of every kernel whose name contains `name` that one call of
    `fn` launched, from the profiler's trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [
        e["args"]["grid"]
        for e in events
        if e.get("cat") == "kernel" and name in e.get("name", "")
    ]
