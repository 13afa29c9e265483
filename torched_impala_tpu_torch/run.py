"""Training CLI of the port (counterpart of `torched_impala_tpu/run.py`,
train mode with fake envs only).

    python -m torched_impala_tpu_torch.run --config pong --fake-envs \\
        --total-steps 100 [--traj-ring] [--device cpu]
    python -m torched_impala_tpu_torch.run --config pong --fake-envs \\
        --actor-mode thread --num-actors 4 --envs-per-actor 8 \\
        --total-steps 100 [--device cpu]
    python -m torched_impala_tpu_torch.run --config breakout --fake-envs \\
        --actor-mode thread --num-actors 4 --envs-per-actor 8 \\
        --total-steps 100 [--fused-conv] [--grad-accum G] [--remat-torso] \\
        [--train-dtype bfloat16] [--device cpu]
    python -m torched_impala_tpu_torch.run --config pong_transformer \\
        --fake-envs --actor-mode thread --num-actors 4 --envs-per-actor 8 \\
        --total-steps 100 [--fused-epilogue] [--device cpu]

    python -m torched_impala_tpu_torch.run --config procgen --fake-envs \\
        --total-steps 100 [--fused-conv] [--fused-epilogue] [--dp -1] \\
        [--device cpu]

    python -m torched_impala_tpu_torch.run --config pong --fake-envs \\
        --total-steps 100 --superbatch-k 4 [--device cpu]

    python -m torched_impala_tpu_torch.run --config pong --fake-envs \\
        --total-steps 1000 --checkpoint-dir DIR --async-checkpoint \\
        --checkpoint-interval 100 [--resume] [--chaos-plan PLAN.json]

    python -m torched_impala_tpu_torch.run --config pong --fake-envs \\
        --total-steps 100 --health [--postmortem-dir DIR] [--device cpu]

    python -m torched_impala_tpu_torch.run --config pong --fake-envs \\
        --total-steps 100 --traj-ring --max-reuse 2 \\
        --target-update-interval 8 [--device cpu]

`--train-dtype bfloat16` runs the whole train step in bf16 on params
lowered from the f32 masters (grads and optimizer state stay f32), after
a greedy-action gate against the f32 agent on the run's device; when the
gate fails the run warns and trains in float32.

`--grad-accum G` sums the grads of G microbatches of B/G before each
optimizer step and `--remat-torso` runs the torso's forward again in the
backward: the two memory levers, each the same update as without it.

`--steps-per-dispatch K` takes K SGD steps a dispatch on a [K, ...]
superbatch (the params publish every K steps at most; a step budget that
K does not divide runs its largest multiple of K and warns).
`--superbatch-k K` bundles it with the trajectory ring's superbatch slots
and `donate_batch` (a slot is released after the step that consumed it).

The default device is the CUDA card; without one the run fails unless
`--device cpu` is given. `--dp N` shards the learner batch over N devices
as JAX's flag does (0 one device, -1 every visible one): only one device
is ported, so a count above one raises before anything starts.

The last line, `done: ...`, gives the steps, frames, episodes and wall
seconds, the seconds to the first learner step (`first_step_s`: the
fleet's boot), the env frames/s from the first step on, and on the card
the peak device memory.

`--checkpoint-dir` saves the learner's state: with `--async-checkpoint`
a writer thread takes the interval saves with run manifests
(resilience/checkpointer.py), else they are synchronous
(utils/checkpoint.py); a clean finish adds a final save. `--resume`
restores the newest checkpoint of the directory first, and
`--total-steps` counts its steps. `--chaos-plan` injects the faults of a
JSON plan (resilience/chaos.py), `--chaos N` crashes every env after N
steps; the actor supervisor and the pools restart what they kill.

`--health` adds the training-health logs to the train step and publishes
them as `health/*` gauges of the telemetry registry at each log interval
(`--log-every`), with the burn-rate health alerts over them; an alert's
firing or a learner crash writes a postmortem bundle (`postmortem.json`,
`flight_tail.json`, `snapshots.jsonl`) under `--postmortem-dir`.

`--max-reuse N` (with `--traj-ring` and `--target-update-interval`)
turns on IMPACT-style replay: the ring delivers each unroll up to N
times, and every learner step takes the clipped surrogate against a
target network refreshed every `--target-update-interval` steps. The
done line's `steps` and `frames` count every delivery, replays too.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from torched_impala_tpu_torch import configs, resolve_device
from torched_impala_tpu_torch.envs.fake import CrashingFactory
from torched_impala_tpu_torch.resilience import AsyncCheckpointer, ChaosPlan, config_fingerprint
from torched_impala_tpu_torch.runtime.loop import train
from torched_impala_tpu_torch.utils.checkpoint import Checkpointer

# The CPU runs README.md documents; the tests run them as written.
PROCESS_CPU_EXAMPLE = (
    "--config pong --fake-envs --num-actors 2 --batch-size 4 --unroll-length 4 "
    "--total-steps 3 --traj-ring --device cpu"
)
CPU_EXAMPLE = (
    "--config pong --fake-envs --actor-mode thread --num-actors 2 "
    "--envs-per-actor 2 --batch-size 4 --unroll-length 4 --total-steps 3 "
    "--device cpu"
)
BREAKOUT_CPU_EXAMPLE = CPU_EXAMPLE.replace("--config pong", "--config breakout")
BREAKOUT_BF16_CPU_EXAMPLE = BREAKOUT_CPU_EXAMPLE + " --train-dtype bfloat16"
# Save with the async checkpointer, then resume to a later target; `{dir}`
# is the checkpoint directory.
RESUME_CPU_EXAMPLE = (
    CPU_EXAMPLE.replace("--total-steps 3", "--total-steps 4")
    + " --checkpoint-dir {dir} --async-checkpoint --checkpoint-interval 2",
    CPU_EXAMPLE.replace("--total-steps 3", "--total-steps 6")
    + " --checkpoint-dir {dir} --async-checkpoint --checkpoint-interval 2 --resume",
)
# Superbatch ring slots donated into the K-step dispatch, on the Pong
# preset's process actors.
SUPERBATCH_CPU_EXAMPLE = (
    "--config pong --fake-envs --num-actors 2 --batch-size 4 --unroll-length 4 "
    "--total-steps 4 --superbatch-k 2 --device cpu"
)
# The PROCGEN preset (64x64x3, 15 actions) on two async pools of one
# worker each.
PROCGEN_CPU_EXAMPLE = (
    "--config procgen --fake-envs --num-actors 2 --batch-size 4 --unroll-length 4 "
    "--total-steps 3 --device cpu"
)
# IMPACT replay on the ring: each slot delivered up to twice, the target
# refreshed every 2 steps.
REPLAY_CPU_EXAMPLE = (
    CPU_EXAMPLE.replace("--total-steps 3", "--total-steps 6")
    + " --traj-ring --max-reuse 2 --target-update-interval 2"
)
# The training-health plane, every step logged (so the staleness
# correlation has its 8 samples); `{dir}` is the postmortem directory.
HEALTH_CPU_EXAMPLE = (
    CPU_EXAMPLE.replace("--total-steps 3", "--total-steps 8")
    + " --health --log-every 1 --postmortem-dir {dir}"
)
PONG_TRANSFORMER_CPU_EXAMPLE = (
    CPU_EXAMPLE.replace("--config pong", "--config pong_transformer")
    + " --fused-epilogue"
)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True, choices=sorted(configs.PRESETS))
    p.add_argument("--fake-envs", action="store_true",
                   help="shape-faithful fake envs (the only envs ported)")
    p.add_argument("--actor-mode", choices=("thread", "process"), default=None)
    p.add_argument("--pool-mode", choices=("lockstep", "async"), default=None,
                   help="process actors: wait for every worker each step, or "
                   "run inference over the ready fraction")
    p.add_argument("--pool-ready-fraction", type=float, default=None,
                   help="async pools: the share of workers a wave waits for")
    p.add_argument("--traj-ring", action="store_true",
                   help="actors write unrolls straight into the learner's "
                   "batch slots (runtime/traj_ring.py)")
    p.add_argument("--max-reuse", type=int, default=None,
                   help="replay: deliver each committed unroll up to N "
                        "times from the trajectory ring before recycling "
                        "its slot (IMPACT-style circular replay; needs "
                        "--traj-ring and --target-update-interval; "
                        "torched_impala_tpu_torch/replay/)")
    p.add_argument("--replay-mix", type=float, default=None,
                   help="replay: cap on the replayed fraction of delivered "
                        "batches (0 < f <= 1; fresh batches always take "
                        "priority regardless)")
    p.add_argument("--replay-staleness-frames", type=int, default=None,
                   help="replay: expire retained unrolls once the learner "
                        "frame watermark moves more than N frames past "
                        "their oldest transition (0 = no bound)")
    p.add_argument("--target-update-interval", type=int, default=None,
                   help="replay: refresh the on-device target-policy "
                        "snapshot every N learner steps (the clipped "
                        "surrogate anchors to it; required when "
                        "--max-reuse > 1)")
    p.add_argument("--target-clip-epsilon", type=float, default=None,
                   help="replay: PPO-style clip radius for the "
                        "learner/target policy ratio in the surrogate "
                        "loss (default 0.2)")
    p.add_argument("--num-actors", type=int, default=None)
    p.add_argument("--envs-per-actor", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--unroll-length", type=int, default=None)
    p.add_argument("--total-steps", type=int, required=True,
                   help="learner updates to run")
    p.add_argument("--steps-per-dispatch", type=int, default=None, metavar="K",
                   help="K SGD steps a dispatch on a [K, ...] superbatch "
                   "(params publish every K steps at most)")
    p.add_argument("--superbatch-k", type=int, default=None, metavar="K",
                   help="the trajectory ring with [K, ...] superbatch slots, "
                   "released after the step that consumed them, into the "
                   "K-step dispatch (sets --traj-ring, --steps-per-dispatch "
                   "K and donate_batch)")
    p.add_argument("--fused-conv", action="store_true",
                   help="residual blocks through the fused block kernel "
                   "(deep_resnet only)")
    p.add_argument("--fused-epilogue", action="store_true",
                   help="V-trace and the loss sums in one kernel "
                   "(ops/fused_loss.py)")
    p.add_argument("--grad-accum", type=int, default=None,
                   help="accumulate gradients over G microbatches before "
                   "one optimizer update (the full batch's update, about "
                   "G-fold fewer activations alive)")
    p.add_argument("--remat-torso", action="store_true",
                   help="rematerialize the torso in the backward pass "
                   "(one more torso forward a step in place of keeping "
                   "its activations)")
    p.add_argument("--transformer-dtype", choices=("float32", "bfloat16"),
                   default=None,
                   help="the transformer core's matmul compute dtype")
    p.add_argument("--train-dtype", choices=("float32", "bfloat16"),
                   default=None,
                   help="the train step's compute dtype: bfloat16 lowers the "
                   "f32 master params to bf16 inside the differentiated step "
                   "(grads, optimizer state and master params stay f32), "
                   "gated by greedy-action parity with f32")
    p.add_argument("--dp", type=int, default=None,
                   help="shard the learner batch over N devices (-1 = all); "
                   "more than one raises (not ported)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-interval", type=int, default=None,
                   help="learner steps between checkpoint saves "
                   "(default: the preset's checkpoint_interval, 1000)")
    p.add_argument("--checkpoint-keep", type=int, default=None,
                   help="checkpoints kept, both backends (default: the "
                   "preset's checkpoint_keep, 3)")
    p.add_argument("--checkpoint-seconds", type=float, default=None,
                   help="async backend: also save when this much wall time "
                   "passed since the last save (0 = steps only)")
    p.add_argument("--async-checkpoint", action="store_true",
                   help="interval saves by a writer thread, with run "
                   "manifests: the learner never waits on the disk, but a "
                   "save in flight slows the step it overlaps")
    p.add_argument("--resume", nargs="?", const="auto", default=None,
                   choices=("auto",),
                   help="restore the newest checkpoint of --checkpoint-dir "
                   "first (manifests and synchronous files compared by step)")
    p.add_argument("--chaos", type=int, default=0, metavar="N",
                   help="crash each env after N env steps (the pools and "
                   "the actor supervisor restart them)")
    p.add_argument("--chaos-plan", default=None, metavar="PLAN.json",
                   help="fault plan: a JSON list of {kind, at, target, "
                   "duration_s} (resilience/chaos.py)")
    p.add_argument("--health", action="store_true",
                   help="training-health diagnostics (telemetry/health.py): "
                   "learning-health logs in the train step (V-trace rho/c "
                   "clip fractions and IS-weight histogram, entropy, "
                   "behaviour->learner KL, value explained variance, "
                   "per-group grad norms and update ratios) as health/* "
                   "gauges, the burn-rate health alerts (entropy collapse, "
                   "rho saturation, EV collapse, grad spike), and a "
                   "postmortem bundle on each alert firing or learner crash")
    p.add_argument("--postmortem-dir", default=None, metavar="DIR",
                   help="where --health bundles land (default: the preset's "
                   "postmortem_dir, 'postmortems')")
    return p.parse_args(argv)


def build_config(args: argparse.Namespace) -> configs.ExperimentConfig:
    overrides = {
        "actor_mode": args.actor_mode,
        "pool_mode": args.pool_mode,
        "pool_ready_fraction": args.pool_ready_fraction,
        "traj_ring": args.traj_ring or None,
        "max_reuse": args.max_reuse,
        "replay_mix": args.replay_mix,
        "replay_staleness_frames": args.replay_staleness_frames,
        "target_update_interval": args.target_update_interval,
        "target_clip_epsilon": args.target_clip_epsilon,
        "num_actors": args.num_actors,
        "envs_per_actor": args.envs_per_actor,
        "batch_size": args.batch_size,
        "unroll_length": args.unroll_length,
        "fused_conv": args.fused_conv or None,
        "fused_epilogue": args.fused_epilogue or None,
        "transformer_dtype": args.transformer_dtype,
        "train_dtype": args.train_dtype,
        "remat_torso": args.remat_torso or None,
        "steps_per_dispatch": args.steps_per_dispatch,
        "dp_devices": args.dp,
        "health_diagnostics": args.health or None,
        "postmortem_dir": args.postmortem_dir,
    }
    if args.superbatch_k is not None:
        overrides.update(traj_ring=True, steps_per_dispatch=args.superbatch_k, donate_batch=True)
    cfg = configs.PRESETS[args.config]
    return dataclasses.replace(
        cfg, **{k: v for k, v in overrides.items() if v is not None}
    )


def _print_logger(logs) -> None:
    keys = ("num_steps", "total_loss", "entropy", "frames_per_sec",
            "episode_return_mean")
    print(" ".join(f"{k}={logs[k]:.6g}" for k in keys if k in logs), flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = build_config(args)
    device = resolve_device(args.device)
    configs.resolve_dp_devices(cfg.dp_devices, device)
    if cfg.train_dtype != "float32":
        # JAX's train-side gate: a half dtype whose greedy actions differ
        # from f32 on the probe is refused, and the run trains in f32.
        ok, mismatches = configs.check_train_dtype_parity(cfg, device, seed=args.seed)
        if not ok:
            print(
                f"warning: --train-dtype {cfg.train_dtype} refused — greedy-action "
                f"parity gate failed ({mismatches} probe actions differ from f32); "
                "falling back to float32",
                file=sys.stderr,
            )
            cfg = dataclasses.replace(cfg, train_dtype="float32")
    interval = (
        args.checkpoint_interval
        if args.checkpoint_interval is not None
        else cfg.checkpoint_interval
    )
    keep = args.checkpoint_keep if args.checkpoint_keep is not None else cfg.checkpoint_keep
    seconds = (
        args.checkpoint_seconds
        if args.checkpoint_seconds is not None
        else cfg.checkpoint_seconds
    )
    if (args.async_checkpoint or args.resume) and args.checkpoint_dir is None:
        raise SystemExit("--async-checkpoint and --resume need --checkpoint-dir")
    checkpointer = None
    if args.checkpoint_dir is not None:
        checkpointer = Checkpointer(args.checkpoint_dir, max_to_keep=keep)
    async_checkpointer = config_hash = None
    if args.async_checkpoint:
        config_hash = config_fingerprint(cfg)
        async_checkpointer = AsyncCheckpointer(
            args.checkpoint_dir,
            keep=keep,
            interval_steps=interval,
            interval_seconds=seconds,
            config_hash=config_hash,
        )
    env_factory = configs.make_env_factory(cfg, fake=args.fake_envs)
    if args.chaos:
        env_factory = CrashingFactory(env_factory, crash_after=args.chaos)
    chaos_plan = ChaosPlan.from_json(args.chaos_plan) if args.chaos_plan else None
    learner_config = configs.make_learner_config(cfg)
    if args.grad_accum is not None:
        # No truthiness filter: 0 reaches the Learner's own >= 1 check.
        learner_config = dataclasses.replace(learner_config, grad_accum=args.grad_accum)
    # (step, host time) at the run's start step, after the first learner
    # dispatch (which ends the fleet's boot: pools, actors, the first
    # batch) and after the latest one.
    marks = []

    def mark(n):
        if len(marks) == 3:
            marks.pop()
        marks.append((n, time.monotonic()))

    t0 = time.monotonic()
    try:
        result = train(
            agent=configs.make_agent(cfg, seed=args.seed),
            env_factory=env_factory,
            num_actors=cfg.num_actors,
            envs_per_actor=cfg.envs_per_actor,
            actor_mode=cfg.actor_mode,
            pool_mode=cfg.pool_mode,
            pool_ready_fraction=cfg.pool_ready_fraction,
            learner_config=learner_config,
            optimizer=configs.make_optimizer(cfg),
            total_steps=args.total_steps,
            seed=args.seed,
            device=device,
            logger=_print_logger,
            log_every=args.log_every,
            checkpointer=checkpointer,
            checkpoint_interval=interval,
            resume=args.resume,
            async_checkpointer=async_checkpointer,
            config_hash=config_hash,
            chaos=chaos_plan,
            on_learner_step=mark,
            postmortem_dir=cfg.postmortem_dir,
        )
    finally:
        if async_checkpointer is not None:
            async_checkpointer.close()
    returns = [r for _, r, _ in result.episode_returns]
    timing = ""
    if len(marks) > 1:
        (n0, first), (n1, last) = marks[1], marks[-1]
        after_first = (n1 - n0) * cfg.frames_per_step / (last - first) if n1 > n0 else float("nan")
        timing = f" first_step_s={first - t0:.1f} frames_per_s_after_first_step={after_first:.1f}"
    if device.type == "cuda":
        timing += f" peak_device_mb={torch.cuda.max_memory_allocated(device) / 2**20:.1f}"
    print(
        f"done: steps={result.learner.num_steps} frames={result.num_frames} "
        f"episodes={len(returns)} "
        f"return_mean={np.mean(returns) if returns else float('nan'):.4g} "
        f"actor_restarts={result.actor_restarts} "
        f"seconds={time.monotonic() - t0:.1f}{timing}",
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
