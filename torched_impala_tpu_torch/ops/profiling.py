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

# Warm-up launches at the start of each profiled window. The trace of a
# window lacks the kernels of its first launches, the more of them the
# older the process (PERF.md §6: none in a fresh process, one or two after
# the ~20 s of a cold build, six at 75 s, all of 1000 in a process whose
# first window came ≈ 15 min in). So each window first launches a burst
# of WARMUP_LAUNCHES tiny kernels (WARMUP_KERNEL), which the counts leave
# out; a window whose trace kept none of them may have lost the measured
# launches too. Such a window is taken again, up to WINDOW_ATTEMPTS windows
# in all, then raises: the loss of all 1000 also comes and goes, once in a
# window ~430 s into a process whose older siblings' windows had kept them
# (PERF.md §7).
WARMUP_LAUNCHES = 1000
WARMUP_KERNEL = "spin_kernel"  # torch.cuda._sleep's
WINDOW_ATTEMPTS = 3


def _windows(fn):
    """A profiler window over the CUDA and CPU activity of `fn()`, opened by
    WARMUP_LAUNCHES launches of WARMUP_KERNEL and closed after the device
    is synchronized. A window whose trace kept none of the warm-up kernels
    is taken again (`fn()` runs again), up to WINDOW_ATTEMPTS windows; then
    it raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(WINDOW_ATTEMPTS):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(WARMUP_LAUNCHES):
                    torch.cuda._sleep(1)
                fn()
                torch.cuda.synchronize()
        if any(
            avg.device_type == DeviceType.CUDA and WARMUP_KERNEL in avg.key
            for avg in prof.key_averages()
        ):
            return prof
    raise RuntimeError(
        f"the profiler's trace lost all {WARMUP_LAUNCHES} warm-up launches in "
        f"{WINDOW_ATTEMPTS} windows: the measured launches may be short too"
    )


def _cuda_rows(fn, calls):
    """The profiler's CUDA-kernel rows over `calls` calls of `fn`, the
    warm-up launches left out. Only rows of device type CUDA count: a CPU
    op's row repeats the time of the kernels it launched."""
    from torch.autograd import DeviceType

    def run():
        for _ in range(calls):
            fn()

    return [
        avg
        for avg in _windows(run).key_averages()
        if avg.device_type == DeviceType.CUDA
        and not getattr(avg, "is_user_annotation", False)
        and WARMUP_KERNEL not in avg.key
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


def launched_grids(fn, name):
    """The grid of every kernel whose name contains `name` that one call of
    `fn` launched, from the profiler's trace."""
    prof = _windows(fn)
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


def kernels_by_name(fn, calls=10):
    """{kernel name: [launches a call, device µs a call]} of every CUDA
    kernel `fn` runs."""
    return {
        avg.key: [avg.count / calls, avg.self_device_time_total / calls]
        for avg in _cuda_rows(fn, calls)
    }


def peak_live_blocks(fn, top=8):
    """Where one call of `fn` reaches its peak of device memory allocated
    during the call: {"peak_mb": that peak above what was allocated
    before, "at": the source line (this package's innermost frame) of the
    allocation that reached it, "live": the `top` largest sums of the
    blocks alive then, MB by allocating line}. From the caching
    allocator's history (`torch.cuda.memory._record_memory_history`)."""
    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(stacks="python", max_entries=1_000_000)
    try:
        fn()
        torch.cuda.synchronize()
        snapshot = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)

    def where(frames):
        for f in frames:
            if "torched_impala_tpu_torch" in f["filename"] or "chip_smoke" in f["filename"]:
                return f"{f['filename'].rsplit('/', 1)[-1]}:{f['line']} {f['name']}"
        return "other"

    live, total, peak, peak_at, peak_live = {}, 0, 0, None, {}
    for event in snapshot["device_traces"][torch.cuda.current_device()]:
        if event["action"] == "alloc":
            live[event["addr"]] = (event["size"], where(event.get("frames", [])))
            total += event["size"]
            if total > peak:
                peak, peak_at, peak_live = total, live[event["addr"]][1], dict(live)
        elif event["action"] == "free_completed" and event["addr"] in live:
            total -= live.pop(event["addr"])[0]
    by_line: dict = {}
    for size, line in peak_live.values():
        by_line[line] = by_line.get(line, 0) + size / 2**20
    return {
        "peak_mb": peak / 2**20,
        "at": peak_at,
        "live": sorted(by_line.items(), key=lambda kv: -kv[1])[:top],
    }

