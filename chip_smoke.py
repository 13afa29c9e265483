#!/usr/bin/env python3
"""Drive the PyTorch port (torched_impala_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits
non-zero (no phase's failure is caught):

1. env: the card, torch/CUDA versions, the TF32 settings in force.
2. build: nvcc builds every kernel from csrc/ (one process per source,
   all at once); the seconds it took.
3. vtrace: the CUDA kernel against its plain PyTorch version on the card
   over shapes x clip thresholds x lambda (max abs error <= 1e-5) and
   with a NaN log-ratio (the same NaN pattern as the plain version), its
   time beside the plain version's and its bound at the Pong shape, and
   `impala_loss` through the kernel against `impala_loss` through the
   plain V-trace (total and grads, rtol 1e-5).
4. lstm: the LSTM-cell kernel against its plain version at the learner's
   (B=32, F=H=256) and the actor's (B=8) shapes and two ragged ones
   (max abs error <= 5e-5: f32 sums of up to 512 products in another
   order), gradients through the autograd.Function with the kernel's
   forward against the plain forward's (rtol 1e-4, atol 1e-5); times,
   bound and the `torch.lstm_cell` time at the learner's shape.
5. resblock: the residual-block kernel against its plain version at the
   three Breakout block shapes with N = 672 (the learner's 21 x 32
   images) and N = 8 (one actor) in bf16 (one bf16 rounding apart,
   rtol = atol = 2^-7, 99% of elements equal), and ragged f32 shapes
   (1e-5); gradients through the autograd.Function (rtol 1e-4, atol
   1e-5 x the gradient's largest magnitude); times, bound and the cuDNN
   baseline (two F.conv2d calls with the relus and the add).
6. model: the Pong net and the Breakout net (deep torso + LSTM, fused
   blocks off and on) on the card against the same nets on the CPU, f32
   (TF32 off) and bf16 torso, on a small input; the Breakout unroll has a
   `first` reset in the middle and a non-zero start state.
7. pong: `loop.train` with the PONG preset at full width (84x84x4 uint8,
   Nature-CNN, bf16 torso, T=20, B=32 as 4 thread actors x 8 fake envs)
   for 20 learner steps on the card, with every kernel's launch count
   zeroed just before and read just after; then the learner's train step
   alone, timed on a fixed batch, one actor alone, and a profiled short
   run for the device's idle share.
8. breakout: the same with the BREAKOUT preset (IMPALA deep ResNet,
   LSTM(256) core, bf16 torso, 4 actions) for 12 learner steps, once
   with the preset's unfused blocks and once with `fused_conv=True`.

Then the `kernels` line, the card's name and power limit, and the last
line `{"ok": true, "device": {...}}`. Without CUDA it exits 2 and prints
no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
PEAK_BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
KERNEL_SHAPES = [(20, 32), (100, 32), (20, 256), (1, 1), (7, 130)]
THRESHOLDS = [
    dict(),
    dict(clip_rho_threshold=None, clip_c_threshold=None, clip_pg_rho_threshold=None),
    dict(clip_rho_threshold=0.5, clip_c_threshold=2.0, clip_pg_rho_threshold=2.0),
]
PONG_STEPS = 20
BREAKOUT_STEPS = 12
PROFILED_STEPS = 8
LSTM_SHAPES = [(32, 256, 256), (8, 256, 256), (1, 7, 7), (33, 100, 130)]  # B, F, H
LSTM_ATOL = 5e-5
# (N, H, W, C): the learner's three block shapes (21 x 32 images), then
# one actor's largest (8 envs).
BLOCK_SHAPES = [(672, 42, 42, 16), (672, 21, 21, 32), (672, 11, 11, 32), (8, 42, 42, 16)]
BLOCK_F32_SHAPES = [(3, 13, 7, 24), (2, 42, 42, 16), (1, 1, 1, 1)]
BF16_ULP = 2.0**-7


START = time.monotonic()


def emit(obj) -> None:
    """Print one JSON line; a phase's line also gets the script's elapsed
    seconds when it ends."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=time.monotonic() - START)
    print(json.dumps(obj), flush=True)


def vtrace_inputs(T, B, seed, device):
    import torch

    rng = np.random.default_rng(seed)
    arrays = dict(
        log_rhos=rng.normal(size=(T, B)) * 0.5,
        discounts=0.99 * (rng.uniform(size=(T, B)) > 0.15),
        rewards=rng.normal(size=(T, B)),
        values=rng.normal(size=(T, B)),
        bootstrap_value=rng.normal(size=(B,)),
    )
    return {
        k: torch.from_numpy(v.astype(np.float32)).to(device) for k, v in arrays.items()
    }


def time_cuda(fn, iters=200, warmup=20) -> float:
    """Median milliseconds of `fn` over `iters` calls, each between two
    CUDA events, after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def profiled_device_us(fn, calls=50, name=None):
    """(device µs, kernel launches) per call of `fn` from torch.profiler,
    over the CUDA kernels whose name contains `name` (every kernel when
    `name` is None); (None, None) when the profiler saw no device time.
    Only rows of device type CUDA count: a CPU op's row repeats the time
    of the kernels it launched."""
    import warnings

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [
            avg
            for avg in prof.key_averages()
            if avg.device_type == DeviceType.CUDA
            and not getattr(avg, "is_user_annotation", False)
            and (name is None or name in avg.key)
        ]
    total = sum(avg.self_device_time_total for avg in rows)
    if not total:
        return None, None
    return total / calls, sum(avg.count for avg in rows) / calls


def bound(bytes_moved, ops, peak_ops):
    """(least ms, what binds it): bytes over the memory rate against
    operations over the peak rate of their type."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_env():
    import torch

    from torched_impala_tpu_torch.device import configure_precision

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    emit(
        {
            "phase": "env",
            "nvidia_smi": smi,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "python": sys.version.split()[0],
            "tf32": configure_precision(),
        }
    )
    return smi


def phase_build():
    from torched_impala_tpu_torch.ops import _build

    names = _build.kernel_names()
    t0 = time.monotonic()
    _build.build_all(names)
    for name in names:
        _build.load(name)
    emit(
        {
            "phase": "build",
            "kernels": names,
            "seconds": round(time.monotonic() - t0, 3),
            "dir": str(_build.build_dir()),
        }
    )
    return names


def phase_vtrace(device):
    import torch

    from torched_impala_tpu_torch.ops import losses, vtrace_cuda
    from torched_impala_tpu_torch.ops.vtrace import vtrace_reference

    worst = 0.0
    per_shape = {}
    for T, B in KERNEL_SHAPES:
        x = vtrace_inputs(T, B, seed=T * 1000 + B, device=device)
        err = 0.0
        for clips in THRESHOLDS:
            for lambda_ in (1.0, 0.9):
                out = vtrace_cuda.vtrace_cuda(**x, **clips, lambda_=lambda_)
                ref = vtrace_reference(**x, **clips, lambda_=lambda_)
                torch.cuda.synchronize()
                for a, b in zip(out, ref):
                    err = max(err, float((a - b).abs().max()))
        per_shape[f"{T}x{B}"] = err
        worst = max(worst, err)
    if not worst <= 1e-5:
        raise AssertionError(f"vtrace kernel vs plain: max abs err {per_shape}")
    # A NaN log-ratio must give NaN where the plain version does.
    x = vtrace_inputs(20, 32, seed=5, device=device)
    x["log_rhos"][7, 3] = float("nan")
    for clips in THRESHOLDS:
        out = vtrace_cuda.vtrace_cuda(**x, **clips)
        ref = vtrace_reference(**x, **clips)
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, equal_nan=True)

    T, B = 20, 32
    x = vtrace_inputs(T, B, seed=7, device=device)
    kernel_ms = time_cuda(lambda: vtrace_cuda.vtrace_cuda(**x))
    plain_ms = time_cuda(lambda: vtrace_reference(**x))
    # Where the kernel's time goes: the wrapper's host cost per call
    # (back-to-back calls, one synchronize at the end) and the kernel's
    # own device time from the profiler.
    calls = 1000
    t0 = time.perf_counter()
    for _ in range(calls):
        vtrace_cuda.vtrace_cuda(**x)
    torch.cuda.synchronize()
    wrapper_host_us = (time.perf_counter() - t0) / calls * 1e6
    device_us, _ = profiled_device_us(
        lambda: vtrace_cuda.vtrace_cuda(**x), name="vtrace_kernel"
    )
    bytes_moved = (4 * T * B + B) * 4 + 3 * T * B * 4
    # Per element: exp, three clips, and 12 multiplies/adds of the
    # recursion and the two output formulas.
    ops = 16 * T * B
    bound_s = max(bytes_moved / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S)
    bound_by = "bytes" if bytes_moved / PEAK_BYTES_PER_S >= ops / PEAK_F32_OPS_PER_S else "operations"

    # impala_loss through the kernel vs through the plain V-trace, all
    # else identical on the card.
    rng = np.random.default_rng(11)
    A = 6

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    inputs = dict(
        behaviour_logits=t(rng.normal(size=(T, B, A))),
        bootstrap_value=t(rng.normal(size=(B,))),
        actions=torch.from_numpy(rng.integers(0, A, size=(T, B))).to(device),
        rewards=t(rng.normal(size=(T, B))),
        discounts=t(0.99 * (rng.uniform(size=(T, B)) > 0.05)),
    )
    logits0 = rng.normal(size=(T, B, A))
    values0 = rng.normal(size=(T, B))

    def loss_and_grads():
        logits = t(logits0).requires_grad_()
        values = t(values0).requires_grad_()
        out = losses.impala_loss(target_logits=logits, values=values, **inputs)
        g = torch.autograd.grad(out.total, (logits, values))
        return out.total.detach(), g

    total_k, grads_k = loss_and_grads()
    real_vtrace = losses.vtrace
    losses.vtrace = vtrace_reference
    try:
        total_p, grads_p = loss_and_grads()
    finally:
        losses.vtrace = real_vtrace
    torch.testing.assert_close(total_k, total_p, rtol=1e-5, atol=1e-6)
    for gk, gp in zip(grads_k, grads_p):
        torch.testing.assert_close(gk, gp, rtol=1e-5, atol=1e-6)
    loss_err = max(float((gk - gp).abs().max()) for gk, gp in zip(grads_k, grads_p))
    emit(
        {
            "phase": "vtrace",
            "max_abs_err": worst,
            "max_abs_err_by_shape": per_shape,
            "pong_shape": [T, B],
            "kernel_us": kernel_ms * 1e3,
            "plain_us": plain_ms * 1e3,
            "wrapper_host_us": wrapper_host_us,
            "kernel_device_us_profiler": device_us,
            "bound_us": bound_s * 1e6,
            "bound_by": bound_by,
            "bytes": bytes_moved,
            "library_call": None,
            "impala_loss_total": [float(total_k), float(total_p)],
            "impala_loss_grad_max_abs_diff": loss_err,
        }
    )
    return dict(
        max_abs_err=worst,
        ms=kernel_ms,
        plain_ms=plain_ms,
        bound_ms=bound_s * 1e3,
        bound_by=bound_by,
    )


def phase_lstm(device):
    import torch

    from torched_impala_tpu_torch.ops import lstm, lstm_cuda

    def inputs(B, F, H, seed):
        rng = np.random.default_rng(seed)
        arrays = [
            rng.normal(size=(B, F)),
            rng.normal(size=(B, H)),
            rng.normal(size=(B, H)),
            rng.normal(size=(F, 4 * H)) / np.sqrt(F),
            rng.normal(size=(H, 4 * H)) / np.sqrt(H),
            rng.normal(size=(4 * H,)) * 0.1,
        ]
        return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]

    per_shape = {}
    for B, F, H in LSTM_SHAPES:
        args = inputs(B, F, H, seed=B + F + H)
        out = lstm_cuda.lstm_cell_cuda(*args)
        ref = lstm.lstm_reference(*args)
        torch.cuda.synchronize()
        per_shape[f"{B}x{F}x{H}"] = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    worst = max(per_shape.values())
    if not worst <= LSTM_ATOL:
        raise AssertionError(f"lstm kernel vs plain: max abs err {per_shape}")

    B, F, H = LSTM_SHAPES[0]
    args = inputs(B, F, H, seed=1)
    grad_args = [a.clone().requires_grad_() for a in args]
    c, h = lstm.lstm_cell_fused(*grad_args)
    g_kernel = torch.autograd.grad((c * 0.5 + h).sum(), grad_args)
    c, h, _ = lstm.lstm_reference(*grad_args)
    g_plain = torch.autograd.grad((c * 0.5 + h).sum(), grad_args)
    for a, b in zip(g_kernel, g_plain):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    grad_err = max(float((a - b).abs().max()) for a, b in zip(g_kernel, g_plain))

    x, h, c, wi, wh, b = args
    w_ih, w_hh, zeros = wi.t().contiguous(), wh.t().contiguous(), torch.zeros_like(b)
    lib_h, lib_c = torch.lstm_cell(x, (h, c), w_ih, w_hh, b, zeros)
    ref_c, ref_h, _ = lstm.lstm_reference(*args)
    library_err = max(float((lib_c - ref_c).abs().max()), float((lib_h - ref_h).abs().max()))
    kernel_ms = time_cuda(lambda: lstm_cuda.lstm_cell_cuda(*args))
    plain_ms = time_cuda(lambda: lstm.lstm_reference(*args))
    library_ms = time_cuda(lambda: torch.lstm_cell(x, (h, c), w_ih, w_hh, b, zeros))
    device_us, _ = profiled_device_us(
        lambda: lstm_cuda.lstm_cell_cuda(*args), name="lstm_cell_kernel"
    )
    bytes_moved = 4 * (B * F + 2 * B * H + (F + H) * 4 * H + 4 * H) + 4 * (2 * B * H + B * 4 * H)
    # The two gate products, the gate adds, and the cell's elementwise
    # work counting each activation as one operation.
    ops = 2 * B * (F + H) * 4 * H + 2 * B * 4 * H + 8 * B * H
    bound_ms, bound_by = bound(bytes_moved, ops, PEAK_F32_OPS_PER_S)
    emit(
        {
            "phase": "lstm",
            "max_abs_err": worst,
            "max_abs_err_by_shape": per_shape,
            "tolerance": LSTM_ATOL,
            "grad_max_abs_diff": grad_err,
            "learner_shape": [B, F, H],
            "kernel_us": kernel_ms * 1e3,
            "plain_us": plain_ms * 1e3,
            "library_us": library_ms * 1e3,
            "library_max_abs_err_vs_plain": library_err,
            "kernel_device_us_profiler": device_us,
            "bound_us": bound_ms * 1e3,
            "bound_by": bound_by,
            "bytes": bytes_moved,
            "ops": ops,
        }
    )
    return dict(
        max_abs_err=worst, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms,
    )


def phase_resblock(device):
    import torch
    import torch.nn.functional as F

    from torched_impala_tpu_torch.ops import conv_block, conv_block_cuda

    def inputs(N, H, W, C, dtype, seed):
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(rng.normal(size=(N, H, W, C)).astype(np.float32))
        params = [
            rng.normal(size=(3, 3, C, C)) / np.sqrt(9 * C),
            rng.normal(size=(C,)) * 0.1,
            rng.normal(size=(3, 3, C, C)) / np.sqrt(9 * C),
            rng.normal(size=(C,)) * 0.1,
        ]
        return [x.to(device=device, dtype=dtype)] + [
            torch.from_numpy(a.astype(np.float32)).to(device) for a in params
        ]

    per_shape, equal_share = {}, {}
    for shape in BLOCK_SHAPES:
        args = inputs(*shape, torch.bfloat16, seed=shape[1])
        out = conv_block_cuda.resblock_cuda(*args)
        ref = conv_block.block_reference(*args)
        torch.cuda.synchronize()
        key = "x".join(map(str, shape))
        per_shape[key] = float((out.float() - ref.float()).abs().max())
        equal_share[key] = float((out == ref).float().mean())
        torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_ULP, atol=BF16_ULP)
        if equal_share[key] < 0.99:
            raise AssertionError(f"resblock {key}: only {equal_share[key]} of elements equal")
    f32_err = {}
    for shape in BLOCK_F32_SHAPES:
        args = inputs(*shape, torch.float32, seed=3)
        out = conv_block_cuda.resblock_cuda(*args)
        ref = conv_block.block_reference(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        f32_err["x".join(map(str, shape))] = float((out - ref).abs().max())

    grad_args = [t.requires_grad_() for t in inputs(4, 11, 11, 32, torch.float32, seed=5)]
    g_kernel = torch.autograd.grad(
        conv_block.fused_residual_block(*grad_args).square().sum(), grad_args
    )
    g_plain = torch.autograd.grad(
        conv_block.block_reference(*grad_args).square().sum(), grad_args
    )
    # dout = 2 * out carries the forward's f32 rounding into each kernel
    # gradient, a sum over N*H*W positions: the bound scales with the
    # gradient's own magnitude.
    for a, b in zip(g_kernel, g_plain):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()))
    grad_err = max(float((a - b).abs().max()) for a, b in zip(g_kernel, g_plain))

    def library_block(x_nchw, w1, b1, w2, b2):
        out = F.conv2d(F.relu(x_nchw), w1, b1, padding=1)
        return x_nchw + F.conv2d(F.relu(out), w2, b2, padding=1)

    times = {}
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bytes=0, ops=0)
    for shape in BLOCK_SHAPES[:3]:
        N, H, W, C = shape
        args = inputs(*shape, torch.bfloat16, seed=7)
        x, k1, b1, k2, b2 = args
        # The unfused block's operands: bf16 NCHW views over channels-last
        # memory, OIHW bf16 kernels, bias inside the conv.
        oihw = [k.permute(3, 2, 0, 1).contiguous().bfloat16() for k in (k1, k2)]
        lib_args = (x.permute(0, 3, 1, 2), oihw[0], b1.bfloat16(), oihw[1], b2.bfloat16())
        kernel_ms = time_cuda(lambda: conv_block_cuda.resblock_cuda(*args), iters=50, warmup=5)
        plain_ms = time_cuda(lambda: conv_block.block_reference(*args), iters=50, warmup=5)
        library_ms = time_cuda(lambda: library_block(*lib_args), iters=50, warmup=5)
        device_us, _ = profiled_device_us(
            lambda: conv_block_cuda.resblock_cuda(*args), calls=20, name="resblock_kernel"
        )
        bytes_moved = 2 * N * H * W * C * 2 + 4 * (2 * 9 * C * C + 2 * C)
        # Two convs (2 x 9C multiply-adds per output), two bias adds, two
        # relus and the skip add per output element.
        ops = 2 * 2 * 9 * C * C * N * H * W + 5 * N * H * W * C
        bound_ms, bound_by = bound(bytes_moved, ops, PEAK_BF16_OPS_PER_S)
        key = "x".join(map(str, shape))
        times[key] = dict(
            kernel_us=kernel_ms * 1e3, kernel_device_us_profiler=device_us,
            plain_us=plain_ms * 1e3, library_us=library_ms * 1e3,
            bound_us=bound_ms * 1e3, bound_by=bound_by,
        )
        for k, v in (("ms", kernel_ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                     ("bound_ms", bound_ms), ("bytes", bytes_moved), ("ops", ops)):
            totals[k] += v
    total_bound_by = bound(totals["bytes"], totals["ops"], PEAK_BF16_OPS_PER_S)[1]
    worst = max(per_shape.values())
    emit(
        {
            "phase": "resblock",
            "max_abs_err_bf16": worst,
            "max_abs_err_bf16_by_shape": per_shape,
            "equal_share_bf16_by_shape": equal_share,
            "max_abs_err_f32_by_shape": f32_err,
            "grad_max_abs_diff": grad_err,
            "times_by_learner_shape": times,
            "sum_over_the_three_learner_shapes": dict(totals, bound_by=total_bound_by),
        }
    )
    return dict(
        max_abs_err=max(worst, *f32_err.values()), ms=totals["ms"],
        plain_ms=totals["plain_ms"], bound_ms=totals["bound_ms"],
        bound_by=total_bound_by, library_ms=totals["library_ms"],
    )


def phase_model(device):
    import torch

    from torched_impala_tpu_torch.models.nets import ImpalaNet
    from torched_impala_tpu_torch.models.torsos import AtariDeepTorso, AtariShallowTorso

    rng = np.random.default_rng(3)
    obs = torch.from_numpy(rng.integers(0, 256, size=(3, 4, 84, 84, 4), dtype=np.uint8))
    first = torch.zeros(3, 4, dtype=torch.bool)
    first[1, 2] = first[2, 0] = True
    state0 = tuple(torch.from_numpy(rng.normal(size=(4, 256)).astype(np.float32)) for _ in range(2))
    result = {"phase": "model"}
    tols = {"float32": dict(rtol=1e-4, atol=1e-5), "bfloat16": dict(rtol=0.0, atol=5e-2)}
    nets = [
        ("pong", lambda dt, g: ImpalaNet(6, AtariShallowTorso(4, dtype=dt, generator=g), generator=g), ()),
        *(
            (
                f"breakout_{'fused' if fused else 'unfused'}",
                lambda dt, g, fused=fused: ImpalaNet(
                    4, AtariDeepTorso(dtype=dt, fused_blocks=fused, generator=g),
                    core="lstm", generator=g,
                ),
                state0,
            )
            for fused in (False, True)
        ),
    ]
    for name, build, state in nets:
        for dtype, tol in tols.items():
            net = build(dtype, torch.Generator().manual_seed(0))
            with torch.no_grad():
                cpu_out, cpu_state = net(obs, first, state, unroll=True)
                net.to(device)
                dev_state_in = tuple(s.to(device) for s in state)
                dev_out, dev_state = net(obs.to(device), first.to(device), dev_state_in, unroll=True)
            logits = dev_out.policy_logits.cpu()
            if not torch.isfinite(logits).all() or logits.shape != cpu_out.policy_logits.shape:
                raise AssertionError(f"model {name} {dtype}: bad logits {logits.shape}")
            torch.testing.assert_close(logits, cpu_out.policy_logits, **tol)
            torch.testing.assert_close(dev_out.values.cpu(), cpu_out.values, **tol)
            for a, b in zip(dev_state, cpu_state):
                torch.testing.assert_close(a.cpu(), b, **tol)
            result[f"{name}_{dtype}"] = float((logits - cpu_out.policy_logits).abs().max())
    emit(result)


def fixed_batch(cfg, device, state):
    """A full-size device batch for timing the train step alone."""
    import torch

    rng = np.random.default_rng(5)
    T, B, A = cfg.unroll_length, cfg.batch_size, cfg.num_actions
    return (
        torch.from_numpy(rng.integers(0, 256, size=(T + 1, B, 84, 84, 4), dtype=np.uint8)).to(device),
        torch.zeros(T + 1, B, dtype=torch.bool, device=device),
        torch.from_numpy(rng.integers(0, A, size=(T, B))).to(device),
        torch.from_numpy(rng.normal(size=(T, B, A)).astype(np.float32)).to(device),
        torch.from_numpy((rng.uniform(size=(T, B)) < 0.05).astype(np.float32)).to(device),
        torch.ones(T, B, device=device),
        state,
    )


def drive(name, cfg, steps, device, counters):
    """`loop.train` with `cfg` for `steps` learner steps on the card, every
    kernel's launch count set to 0 just before and read just after; then
    the train step alone on a fixed batch, one actor alone, one fake env
    step, and a profiled short run for the device's idle share. Raises if
    the run did not train on the card."""
    import torch

    from torched_impala_tpu_torch import configs
    from torched_impala_tpu_torch.runtime import loop
    from torched_impala_tpu_torch.runtime.vector_actor import VectorActor

    agent = configs.make_agent(cfg, seed=0)
    before = {k: v.detach().clone() for k, v in agent.net.state_dict().items()}
    log_times = []

    def logger(logs):
        log_times.append((logs["num_steps"], time.monotonic(), logs["total_loss"]))

    torch.cuda.reset_peak_memory_stats()
    for module in counters.values():
        module.LAUNCHES = 0
    t0 = time.monotonic()
    result = loop.train(
        agent=agent,
        env_factory=configs.make_env_factory(cfg, fake=True),
        num_actors=cfg.num_actors,
        envs_per_actor=cfg.envs_per_actor,
        actor_mode=cfg.actor_mode,
        learner_config=configs.make_learner_config(cfg),
        optimizer=configs.make_optimizer(cfg),
        total_steps=steps,
        device=device,
        logger=logger,
        log_every=1,
    )
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {k: module.LAUNCHES for k, module in counters.items()}
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    learner = result.learner
    final_loss = float(result.final_logs["total_loss"])
    if learner.num_steps != steps or not math.isfinite(final_loss):
        raise AssertionError(f"{name}: steps {learner.num_steps}, loss {final_loss}")
    if not all(p.device == device for p in learner.params.values()):
        raise AssertionError(f"{name}: a param is not on {device}")
    if learner.last_batch_device != device:
        raise AssertionError(f"{name}: batch on {learner.last_batch_device}")
    if agent.net.torso.dtype != torch.bfloat16:
        raise AssertionError(f"{name}: torso is not bf16")
    moved = sum(
        not torch.equal(before[k], v.detach().cpu())
        for k, v in agent.net.state_dict().items()
    )
    if moved != len(before):
        raise AssertionError(f"{name}: only {moved}/{len(before)} params moved")

    # Steady window: from the 5th logged step to the last.
    (s0, t_0, _), (s1, t_1, _) = log_times[4], log_times[-1]
    steps_per_s = (s1 - s0) / (t_1 - t_0)
    T, B = cfg.unroll_length, cfg.batch_size
    batch = fixed_batch(cfg, device, agent.net.initial_state(B))
    step_ms = time_cuda(lambda: learner.train_step(batch), iters=20, warmup=3)
    step_device_us, step_kernels = profiled_device_us(
        lambda: learner.train_step(batch), calls=10
    )

    factory = configs.make_env_factory(cfg, fake=True)
    actor = VectorActor(
        actor_id=0,
        envs=[factory(j, j) for j in range(cfg.envs_per_actor)],
        agent=agent,
        param_store=learner.param_store,
        enqueue=[].append,
        unroll_length=T,
        device=device,
    )
    actor.unroll_and_push()
    t0 = time.perf_counter()
    for _ in range(3):
        actor.unroll_and_push()
    actor_unroll_ms = (time.perf_counter() - t0) / 3 * 1e3
    env = factory(0, 0)
    env.reset()
    t0 = time.perf_counter()
    for _ in range(640):
        env.step(0)
    env_step_us = (time.perf_counter() - t0) / 640 * 1e6

    # Device idle share of a short profiled run of the same loop (start-up
    # included): kernel time summed over all threads against wall time.
    def short_run():
        loop.train(
            agent=configs.make_agent(cfg, seed=1),
            env_factory=factory,
            num_actors=cfg.num_actors,
            envs_per_actor=cfg.envs_per_actor,
            learner_config=configs.make_learner_config(cfg),
            optimizer=configs.make_optimizer(cfg),
            total_steps=PROFILED_STEPS,
            device=device,
        )

    t0 = time.perf_counter()
    busy_us, _ = profiled_device_us(short_run, calls=1)
    profiled_wall_us = (time.perf_counter() - t0) * 1e6
    emit(
        {
            "phase": name,
            "learner_steps": learner.num_steps,
            "launches": launches,
            "launches_per_learner_step": {k: v / steps for k, v in launches.items()},
            "final_loss": final_loss,
            "train_wall_s": wall,
            "learner_steps_per_s": steps_per_s,
            "env_frames_per_s": steps_per_s * T * B,
            "train_step_alone_ms": step_ms,
            "train_step_device_busy_ms": (
                None if step_device_us is None else step_device_us / 1e3
            ),
            "train_step_kernels": step_kernels,
            "actor_unroll_alone_ms": actor_unroll_ms,
            "actor_alone_frames_per_s": T * cfg.envs_per_actor / actor_unroll_ms * 1e3,
            "fake_env_step_us": env_step_us,
            "profiled_run_wall_s": profiled_wall_us / 1e6,
            "profiled_run_device_idle_share": (
                None if busy_us is None else 1.0 - busy_us / profiled_wall_us
            ),
            "max_memory_allocated_mb": peak_mb,
        }
    )
    return launches


def kernel_counters():
    from torched_impala_tpu_torch.ops import conv_block_cuda, lstm_cuda, vtrace_cuda

    return {"vtrace": vtrace_cuda, "lstm_cell": lstm_cuda, "resblock": conv_block_cuda}


def phase_pong(device):
    from torched_impala_tpu_torch import configs

    cfg = dataclasses.replace(
        configs.PONG, actor_mode="thread", num_actors=4, envs_per_actor=8
    )
    assert cfg.num_actors * cfg.envs_per_actor == cfg.batch_size == 32
    launches = drive("pong", cfg, PONG_STEPS, device, kernel_counters())
    if launches["vtrace"] < PONG_STEPS:
        raise AssertionError(f"pong: {launches['vtrace']} vtrace launches < {PONG_STEPS} steps")
    return launches


def phase_breakout(device, fused):
    from torched_impala_tpu_torch import configs

    cfg = dataclasses.replace(
        configs.BREAKOUT,
        actor_mode="thread",
        num_actors=4,
        envs_per_actor=8,
        fused_conv=fused,
    )
    assert cfg.num_actors * cfg.envs_per_actor == cfg.batch_size == 32
    name = f"breakout_{'fused' if fused else 'unfused'}"
    launches = drive(name, cfg, BREAKOUT_STEPS, device, kernel_counters())
    steps = BREAKOUT_STEPS
    # The learner's unroll calls the cell T+1 = 21 times a step (the
    # actors add one call per acting step); each torso forward runs the
    # six residual blocks.
    if launches["vtrace"] < steps:
        raise AssertionError(f"{name}: {launches['vtrace']} vtrace launches < {steps}")
    if launches["lstm_cell"] < (cfg.unroll_length + 1) * steps:
        raise AssertionError(f"{name}: {launches['lstm_cell']} lstm launches < 21 a step")
    if fused and launches["resblock"] < 6 * steps:
        raise AssertionError(f"{name}: {launches['resblock']} resblock launches < 6 a step")
    if not fused and launches["resblock"] != 0:
        raise AssertionError(f"{name}: {launches['resblock']} resblock launches, unfused")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    from torched_impala_tpu_torch import resolve_device

    device = resolve_device()
    smi = phase_env()
    names = phase_build()
    if names != ["lstm_cell", "resblock", "vtrace"]:
        raise AssertionError(f"built {names}, but lstm_cell, resblock, vtrace are checked")
    checked = {
        "vtrace": dict(phase_vtrace(device), library_ms=None),
        "lstm_cell": phase_lstm(device),
        "resblock": phase_resblock(device),
    }
    phase_model(device)
    # Each kernel's launches come from the main path that runs it.
    launches = {
        "vtrace": phase_pong(device)["vtrace"],
        "lstm_cell": phase_breakout(device, fused=False)["lstm_cell"],
        "resblock": phase_breakout(device, fused=True)["resblock"],
    }
    replaces = {
        "vtrace": "torched_impala_tpu/ops/vtrace_pallas.py:92",
        "lstm_cell": "torched_impala_tpu/ops/lstm_pallas.py:78",
        "resblock": "torched_impala_tpu/ops/conv_pallas.py:76",
    }
    emit(
        {
            "kernels": [
                {
                    "name": name,
                    "route": "cuda",
                    "source": f"torched_impala_tpu_torch/csrc/{name}.cu",
                    "replaces": replaces[name],
                    "launches": launches[name],
                    **{
                        k: checked[name][k]
                        for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
                    },
                }
                for name in names
            ]
        }
    )
    print(smi, flush=True)
    emit(
        {
            "ok": True,
            "device": {
                "platform": "gpu",
                "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count(),
            },
        }
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
