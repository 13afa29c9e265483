#!/usr/bin/env python3
"""Drive the PyTorch port (torched_impala_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits
non-zero (no phase's failure is caught):

1. env: the card, torch/CUDA versions, the TF32 settings in force.
2. build: nvcc builds every kernel from csrc/; the seconds it took.
3. vtrace: the CUDA kernel against its plain PyTorch version on the card
   over shapes x clip thresholds x lambda (max abs error <= 1e-5) and
   with a NaN log-ratio (the same NaN pattern as the plain version), its
   time beside the plain version's and its bound at the Pong shape, and
   `impala_loss` through the kernel against `impala_loss` through the
   plain V-trace (total and grads, rtol 1e-5).
4. model: the Pong net on the card against the same net on the CPU, f32
   (TF32 off) and bf16 torso, on a small input.
5. pong: `loop.train` with the PONG preset at full width (84x84x4 uint8,
   Nature-CNN, bf16 torso, T=20, B=32 as 4 thread actors x 8 fake envs)
   for 20 learner steps on the card, with every kernel's launch count
   zeroed just before and read just after; then the learner's train step
   alone, timed on a fixed batch.

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
KERNEL_SHAPES = [(20, 32), (100, 32), (20, 256), (1, 1), (7, 130)]
THRESHOLDS = [
    dict(),
    dict(clip_rho_threshold=None, clip_c_threshold=None, clip_pg_rho_threshold=None),
    dict(clip_rho_threshold=0.5, clip_c_threshold=2.0, clip_pg_rho_threshold=2.0),
]
PONG_STEPS = 20


def emit(obj) -> None:
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

    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.monotonic()
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


def phase_model(device):
    import torch

    from torched_impala_tpu_torch.models.nets import ImpalaNet
    from torched_impala_tpu_torch.models.torsos import AtariShallowTorso

    obs = np.random.default_rng(3).integers(0, 256, size=(2, 4, 84, 84, 4), dtype=np.uint8)
    first = torch.zeros(2, 4, dtype=torch.bool)
    result = {"phase": "model"}
    for dtype, tol in (("float32", dict(rtol=1e-4, atol=1e-5)), ("bfloat16", dict(rtol=0.0, atol=5e-2))):
        g = torch.Generator().manual_seed(0)
        net = ImpalaNet(6, AtariShallowTorso(4, dtype=dtype, generator=g), generator=g)
        with torch.no_grad():
            cpu_out, _ = net(torch.from_numpy(obs), first, (), unroll=True)
            net.to(device)
            dev_out, _ = net(torch.from_numpy(obs).to(device), first.to(device), (), unroll=True)
        logits = dev_out.policy_logits.cpu()
        if not torch.isfinite(logits).all() or logits.shape != (2, 4, 6):
            raise AssertionError(f"model {dtype}: bad logits {logits.shape}")
        torch.testing.assert_close(logits, cpu_out.policy_logits, **tol)
        torch.testing.assert_close(dev_out.values.cpu(), cpu_out.values, **tol)
        result[dtype] = float((logits - cpu_out.policy_logits).abs().max())
    emit(result)


def phase_pong(device):
    import torch

    from torched_impala_tpu_torch import configs
    from torched_impala_tpu_torch.ops import vtrace_cuda
    from torched_impala_tpu_torch.runtime import loop

    cfg = dataclasses.replace(
        configs.PONG, actor_mode="thread", num_actors=4, envs_per_actor=8
    )
    assert cfg.num_actors * cfg.envs_per_actor == cfg.batch_size == 32
    agent = configs.make_agent(cfg, seed=0)
    before = {k: v.detach().clone() for k, v in agent.net.state_dict().items()}
    log_times = []

    def logger(logs):
        log_times.append((logs["num_steps"], time.monotonic(), logs["total_loss"]))

    vtrace_cuda.LAUNCHES = 0
    t0 = time.monotonic()
    result = loop.train(
        agent=agent,
        env_factory=configs.make_env_factory(cfg, fake=True),
        num_actors=cfg.num_actors,
        envs_per_actor=cfg.envs_per_actor,
        actor_mode=cfg.actor_mode,
        learner_config=configs.make_learner_config(cfg),
        optimizer=configs.make_optimizer(cfg),
        total_steps=PONG_STEPS,
        device=device,
        logger=logger,
        log_every=1,
    )
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = vtrace_cuda.LAUNCHES

    learner = result.learner
    final_loss = float(result.final_logs["total_loss"])
    if learner.num_steps != PONG_STEPS or not math.isfinite(final_loss):
        raise AssertionError(f"pong: steps {learner.num_steps}, loss {final_loss}")
    if not all(p.device == device for p in learner.params.values()):
        raise AssertionError(f"pong: a param is not on {device}")
    if learner.last_batch_device != device:
        raise AssertionError(f"pong: batch on {learner.last_batch_device}")
    if agent.net.torso.dtype != torch.bfloat16:
        raise AssertionError("pong: torso is not bf16")
    moved = sum(
        not torch.equal(before[k], v.detach().cpu())
        for k, v in agent.net.state_dict().items()
    )
    if moved != len(before):
        raise AssertionError(f"pong: only {moved}/{len(before)} params moved")
    if launches < learner.num_steps:
        raise AssertionError(f"pong: {launches} vtrace launches < {learner.num_steps} steps")

    # Steady window: from the 5th logged step to the last.
    (s0, t_0, _), (s1, t_1, _) = log_times[4], log_times[-1]
    steps_per_s = (s1 - s0) / (t_1 - t_0)
    frames_per_step = cfg.unroll_length * cfg.batch_size

    # The learner's train step alone on one fixed full-size batch.
    rng = np.random.default_rng(5)
    T, B = cfg.unroll_length, cfg.batch_size
    batch = (
        torch.from_numpy(rng.integers(0, 256, size=(T + 1, B, 84, 84, 4), dtype=np.uint8)).to(device),
        torch.zeros(T + 1, B, dtype=torch.bool, device=device),
        torch.from_numpy(rng.integers(0, 6, size=(T, B))).to(device),
        torch.from_numpy(rng.normal(size=(T, B, 6)).astype(np.float32)).to(device),
        torch.from_numpy((rng.uniform(size=(T, B)) < 0.05).astype(np.float32)).to(device),
        torch.ones(T, B, device=device),
    )
    step_ms = time_cuda(lambda: learner.train_step(batch), iters=20, warmup=3)
    step_device_us, step_kernels = profiled_device_us(
        lambda: learner.train_step(batch), calls=10
    )

    # One actor alone (8 envs, no other thread) and one fake env step.
    from torched_impala_tpu_torch.runtime.vector_actor import VectorActor

    factory = configs.make_env_factory(cfg, fake=True)
    sink = []
    actor = VectorActor(
        actor_id=0,
        envs=[factory(j, j) for j in range(cfg.envs_per_actor)],
        agent=agent,
        param_store=learner.param_store,
        enqueue=sink.append,
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
            total_steps=8,
            device=device,
        )

    t0 = time.perf_counter()
    busy_us, _ = profiled_device_us(short_run, calls=1)
    profiled_wall_us = (time.perf_counter() - t0) * 1e6
    emit(
        {
            "phase": "pong",
            "learner_steps": learner.num_steps,
            "vtrace_launches": launches,
            "final_loss": final_loss,
            "train_wall_s": wall,
            "learner_steps_per_s": steps_per_s,
            "env_frames_per_s": steps_per_s * frames_per_step,
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
            "max_memory_allocated_mb": torch.cuda.max_memory_allocated() / 2**20,
        }
    )
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
    if names != ["vtrace"]:
        raise AssertionError(f"built {names}, but only vtrace is checked")
    vt = phase_vtrace(device)
    phase_model(device)
    launches = phase_pong(device)
    emit(
        {
            "kernels": [
                {
                    "name": "vtrace",
                    "route": "cuda",
                    "source": "torched_impala_tpu_torch/csrc/vtrace.cu",
                    "replaces": "torched_impala_tpu/ops/vtrace_pallas.py:92",
                    "launches": launches,
                    "max_abs_err": vt["max_abs_err"],
                    "ms": vt["ms"],
                    "plain_ms": vt["plain_ms"],
                    "bound_ms": vt["bound_ms"],
                    "bound_by": vt["bound_by"],
                    "library_ms": None,
                }
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
