"""Training CLI of the port (counterpart of `torched_impala_tpu/run.py`,
train mode with fake envs only).

    python -m torched_impala_tpu_torch.run --config pong --fake-envs \\
        --total-steps 100 [--traj-ring] [--device cpu]
    python -m torched_impala_tpu_torch.run --config pong --fake-envs \\
        --actor-mode thread --num-actors 4 --envs-per-actor 8 \\
        --total-steps 100 [--device cpu]
    python -m torched_impala_tpu_torch.run --config breakout --fake-envs \\
        --actor-mode thread --num-actors 4 --envs-per-actor 8 \\
        --total-steps 100 [--fused-conv] [--device cpu]
    python -m torched_impala_tpu_torch.run --config pong_transformer \\
        --fake-envs --actor-mode thread --num-actors 4 --envs-per-actor 8 \\
        --total-steps 100 [--fused-epilogue] [--device cpu]

The default device is the CUDA card; without one the run fails unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np

from torched_impala_tpu_torch import configs
from torched_impala_tpu_torch.runtime.loop import train

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
    p.add_argument("--num-actors", type=int, default=None)
    p.add_argument("--envs-per-actor", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--unroll-length", type=int, default=None)
    p.add_argument("--total-steps", type=int, required=True,
                   help="learner updates to run")
    p.add_argument("--fused-conv", action="store_true",
                   help="residual blocks through the fused block kernel "
                   "(deep_resnet only)")
    p.add_argument("--fused-epilogue", action="store_true",
                   help="V-trace and the loss sums in one kernel "
                   "(ops/fused_loss.py)")
    p.add_argument("--transformer-dtype", choices=("float32", "bfloat16"),
                   default=None,
                   help="the transformer core's matmul compute dtype")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--log-every", type=int, default=50)
    return p.parse_args(argv)


def build_config(args: argparse.Namespace) -> configs.ExperimentConfig:
    overrides = {
        "actor_mode": args.actor_mode,
        "pool_mode": args.pool_mode,
        "pool_ready_fraction": args.pool_ready_fraction,
        "traj_ring": args.traj_ring or None,
        "num_actors": args.num_actors,
        "envs_per_actor": args.envs_per_actor,
        "batch_size": args.batch_size,
        "unroll_length": args.unroll_length,
        "fused_conv": args.fused_conv or None,
        "fused_epilogue": args.fused_epilogue or None,
        "transformer_dtype": args.transformer_dtype,
    }
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
    t0 = time.monotonic()
    result = train(
        agent=configs.make_agent(cfg, seed=args.seed),
        env_factory=configs.make_env_factory(cfg, fake=args.fake_envs),
        num_actors=cfg.num_actors,
        envs_per_actor=cfg.envs_per_actor,
        actor_mode=cfg.actor_mode,
        pool_mode=cfg.pool_mode,
        pool_ready_fraction=cfg.pool_ready_fraction,
        learner_config=configs.make_learner_config(cfg),
        optimizer=configs.make_optimizer(cfg),
        total_steps=args.total_steps,
        seed=args.seed,
        device=args.device,
        logger=_print_logger,
        log_every=args.log_every,
    )
    returns = [r for _, r, _ in result.episode_returns]
    print(
        f"done: steps={result.learner.num_steps} frames={result.num_frames} "
        f"episodes={len(returns)} "
        f"return_mean={np.mean(returns) if returns else float('nan'):.4g} "
        f"seconds={time.monotonic() - t0:.1f}",
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
