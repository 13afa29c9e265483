"""Experiment configs and the builders that turn one into the port's
objects (counterpart of `torched_impala_tpu/configs.py`, cut to the
fields and presets of the ported slices; preset values are unchanged).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from torched_impala_tpu_torch.models.agent import Agent
from torched_impala_tpu_torch.models.nets import ImpalaNet, bound_params
from torched_impala_tpu_torch.models.torsos import (
    AtariDeepTorso,
    AtariShallowTorso,
    MLPTorso,
)
from torched_impala_tpu_torch.ops import precision
from torched_impala_tpu_torch.ops.losses import ImpalaLossConfig
from torched_impala_tpu_torch.optim import (
    RMSProp,
    constant_schedule,
    join_schedules,
    linear_schedule,
)
from torched_impala_tpu_torch.runtime.learner import LearnerConfig


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """The fields of the JAX `ExperimentConfig` that this slice reads."""

    name: str
    obs_shape: tuple = ()
    obs_dtype: str = "float32"
    num_actions: int = 2
    # > 1: a multi-task (PopArt) preset; not ported (__post_init__ raises).
    num_tasks: int = 1
    model: str = "mlp"  # mlp | shallow_cnn | deep_resnet
    use_lstm: bool = False  # LSTM(lstm_size) core between torso and heads
    lstm_size: int = 256
    # Temporal core: "auto" resolves to lstm/none via use_lstm;
    # "transformer" selects the sliding-window-KV causal core
    # (models/transformer.py).
    core: str = "auto"
    transformer_d_model: int = 256
    transformer_layers: int = 2
    transformer_heads: int = 4
    transformer_window: int = 128
    # The transformer core's matmul compute dtype (params, LayerNorm
    # statistics, softmax and the KV-cache state stay float32).
    transformer_dtype: str = "float32"
    # Learner-unroll attention: 'kernel' (ops/attention.py: the CUDA
    # kernels on the card, their plain versions on the CPU), 'einsum'
    # (plain products), or 'auto' (KERNEL_MIN_SCORE_ELEMS below).
    transformer_dense_kernel: str = "auto"
    # Residual blocks through the fused block (ops/conv_block.py: the CUDA
    # kernel on the card); deep_resnet only.
    fused_conv: bool = False
    # Torso compute dtype; params, heads and all loss math stay float32.
    compute_dtype: str = "float32"
    # The train step's compute dtype (`run.py --train-dtype`): "bfloat16"
    # lowers the f32 master params to bf16 inside the learner's
    # differentiated closure and runs the torso in bf16 whatever
    # compute_dtype says; grads, optimizer state and the master params
    # stay float32 (runtime/learner.py). run.py holds it to the f32 agent
    # by `check_train_dtype_parity` and falls back to float32 when that
    # fails.
    train_dtype: str = "float32"
    # Rematerialize the torso in the learner's backward pass
    # (torch.utils.checkpoint): one more torso forward a step in place of
    # keeping its activations between the passes; the lever when device
    # memory bounds the batch. The param names are unchanged.
    remat_torso: bool = False
    loss_reduction: str = "sum"
    # V-trace and the loss sums in one kernel (ops/fused_loss.py).
    fused_epilogue: bool = False
    num_actors: int = 4
    envs_per_actor: int = 1
    actor_mode: str = "thread"  # thread | process (runtime/env_pool.py)
    # Process-pool scheduling (actor_mode="process" only): "lockstep"
    # waits for every worker each step; "async" runs inference over
    # whichever `pool_ready_fraction` of the workers has answered.
    pool_mode: str = "lockstep"
    pool_ready_fraction: float = 0.5
    # Actors write unrolls straight into the learner's batch slots
    # (runtime/traj_ring.py); env counts must divide batch_size.
    traj_ring: bool = False
    unroll_length: int = 20
    batch_size: int = 8
    # K SGD steps a dispatch on a [K, T+1, B, ...] superbatch (the
    # learner's steps_per_dispatch): params publish every K steps at most.
    steps_per_dispatch: int = 1
    # Ring slots are released only after the step that consumed them
    # (LearnerConfig.donate_batch); `--superbatch-k` sets it with the ring.
    donate_batch: bool = False
    total_env_frames: int = 1_000_000
    lr: float = 6e-4
    lr_anneal: bool = True  # linear anneal to 0 over total_learner_steps
    # Large-batch operating point (arxiv 1803.02811's linear scaling):
    # with lr_scale_ref_batch > 0 the base lr is lr * (B * K /
    # lr_scale_ref_batch), B * K the effective batch (`scaled_base_lr`), and lr_warmup_steps learner steps ramp linearly
    # 0 -> base before the anneal begins. The schedule is indexed by the
    # optimizer's count, so a run restored mid-warmup resumes on the ramp.
    lr_scale_ref_batch: int = 0
    lr_warmup_steps: int = 0
    rmsprop_decay: float = 0.99
    rmsprop_eps: float = 1e-7
    max_grad_norm: float = 40.0
    discount: float = 0.99
    entropy_coef: float = 0.01
    vf_coef: float = 0.5
    # Checkpoint cadence and retention (`--checkpoint-interval`,
    # `--checkpoint-keep`, `--checkpoint-seconds`): learner steps between
    # saves; with the async checkpointer also a save when this many wall
    # seconds passed (0 = off), whichever comes first; checkpoints kept by
    # either backend.
    checkpoint_interval: int = 1000
    checkpoint_keep: int = 3
    checkpoint_seconds: float = 0.0
    # The training-health plane (`run.py --health`, `--postmortem-dir`):
    # `health_diagnostics` adds the health_* logs to the loss and the
    # learner step (ops/losses.py, runtime/learner.py) and stands up the
    # HealthMonitor -> burn-rate health alerts -> postmortem-bundle chain
    # (telemetry/health.py); bundles land under `postmortem_dir`.
    health_diagnostics: bool = False
    postmortem_dir: str = "postmortems"
    # Devices the learner batch is sharded over: 0 = one device, -1 = every
    # visible device, N = N devices; `resolve_dp_devices` refuses more
    # than one.
    dp_devices: int = 0

    def __post_init__(self) -> None:
        if self.num_tasks > 1:
            raise NotImplementedError(
                f"num_tasks={self.num_tasks}: multi-task presets (PopArt, task "
                "ids through actors, ring and learner) are not ported yet "
                "(ROADMAP.md queue 1: DMLab-30)"
            )

    @property
    def frames_per_step(self) -> int:
        return self.unroll_length * self.batch_size

    @property
    def total_learner_steps(self) -> int:
        return max(1, self.total_env_frames // self.frames_per_step)


CARTPOLE = ExperimentConfig(
    name="cartpole",
    obs_shape=(4,),
    num_actions=2,
    model="mlp",
    num_actors=4,
    unroll_length=20,
    batch_size=8,
    total_env_frames=200_000,
    lr=5e-3,
    lr_anneal=False,
)

PONG = ExperimentConfig(
    name="pong",
    obs_shape=(84, 84, 4),
    obs_dtype="uint8",
    num_actions=6,
    model="shallow_cnn",
    compute_dtype="bfloat16",
    actor_mode="process",
    num_actors=32,
    unroll_length=20,
    batch_size=32,
    total_env_frames=200_000_000,
)

BREAKOUT = ExperimentConfig(
    name="breakout",
    obs_shape=(84, 84, 4),
    obs_dtype="uint8",
    num_actions=4,
    model="deep_resnet",
    compute_dtype="bfloat16",
    use_lstm=True,
    actor_mode="process",
    num_actors=256,
    unroll_length=20,
    batch_size=32,
    total_env_frames=200_000_000,
)

# The transformer temporal core on Pong shapes (JAX configs.py:816-837).
PONG_TRANSFORMER = ExperimentConfig(
    name="pong_transformer",
    obs_shape=(84, 84, 4),
    obs_dtype="uint8",
    num_actions=6,
    model="shallow_cnn",
    compute_dtype="bfloat16",
    core="transformer",
    transformer_d_model=256,
    transformer_layers=2,
    transformer_heads=4,
    transformer_window=128,
    actor_mode="process",
    num_actors=32,
    unroll_length=20,
    batch_size=32,
    total_env_frames=200_000_000,
)

# Procgen (coinrun) shapes on the deep ResNet without a core (JAX
# configs.py:773-792): the largest fleet, on the async ready-set pool.
PROCGEN = ExperimentConfig(
    name="procgen",
    obs_shape=(64, 64, 3),
    obs_dtype="uint8",
    num_actions=15,
    model="deep_resnet",
    compute_dtype="bfloat16",
    actor_mode="process",
    pool_mode="async",
    num_actors=512,
    unroll_length=20,
    batch_size=64,
    total_env_frames=200_000_000,
    dp_devices=-1,
)

PRESETS = {c.name: c for c in (CARTPOLE, PONG, BREAKOUT, PONG_TRANSFORMER, PROCGEN)}


def resolve_dp_devices(dp_devices: int, device: torch.device) -> int:
    """The learner's device count for `dp_devices` (JAX run.py's rule): 0
    is one device, -1 every visible one of `device`'s type (one on the
    CPU), N is N. Raises for more than one: a run never trains on one
    device when it was asked for several."""
    if dp_devices == 0:
        count = 1
    elif dp_devices == -1:
        count = torch.cuda.device_count() if device.type == "cuda" else 1
    elif dp_devices > 0:
        count = dp_devices
    else:
        raise ValueError(f"dp_devices must be -1, 0 or a device count, got {dp_devices}")
    if count > 1:
        raise NotImplementedError(
            f"dp_devices={dp_devices} asks for {count} devices: data-parallel "
            "learners are not ported yet (ROADMAP.md queue 1: DP and "
            "multi-process training)"
        )
    return count

# 'auto' attention crossover: the learner's unroll takes the CUDA kernels
# when its score matrix (T+1) x (W+T+1) reaches this many elements.
# chip_smoke.py's attention phase times fwd + bwd of the kernels against
# the einsum branch on an NVIDIA H100 80GB HBM3 (700 W), f32, H = 4,
# dh = 64, W = 128, with both attention kernels on the tensor cores, in
# two runs: at B = 32, T = 21 (the pong_transformer learner, 3,129
# elements) 0.350-0.456 ms against 0.717-0.853 ms, at B = 2, T = 1024
# (1,179,648) 0.413-0.483 ms against 0.796-0.864 ms (CUDA events). The
# kernels won at both, so the threshold sits at the smaller; no smaller
# shape was measured.
KERNEL_MIN_SCORE_ELEMS = 21 * 149


def resolve_dense_kernel(cfg: ExperimentConfig) -> str:
    """'kernel' or 'einsum' for the transformer core's learner unroll;
    'pallas' (the JAX package's name for its kernel) means 'kernel';
    'auto' takes the kernel on a CUDA host when the learner's score
    matrix reaches KERNEL_MIN_SCORE_ELEMS (the JAX rule's form, with the
    card's own threshold)."""
    choice = cfg.transformer_dense_kernel
    if choice not in ("auto", "kernel", "pallas", "einsum"):
        raise ValueError(
            f"unknown transformer_dense_kernel {choice!r}; "
            "expected 'auto', 'kernel' (or 'pallas') or 'einsum'"
        )
    if choice == "pallas":
        return "kernel"
    if choice != "auto":
        return choice
    t_learner = cfg.unroll_length + 1
    score_elems = t_learner * (cfg.transformer_window + t_learner)
    if torch.cuda.is_available() and score_elems >= KERNEL_MIN_SCORE_ELEMS:
        return "kernel"
    return "einsum"


def make_agent(cfg: ExperimentConfig, seed: int = 0) -> Agent:
    """The policy agent for `cfg`, params initialised on the CPU from
    `seed` (move it with the learner)."""
    if cfg.fused_conv and cfg.model != "deep_resnet":
        raise ValueError(
            f"fused_conv requires model='deep_resnet' (got model={cfg.model!r})"
        )
    precision.validate_compute_dtype("train_step", cfg.train_dtype)
    # The bf16 train step runs the torso in bf16 (JAX's make_agent); the
    # heads and the LSTM core stay float32, the transformer core keeps
    # transformer_dtype.
    torso_dtype = "bfloat16" if cfg.train_dtype == "bfloat16" else cfg.compute_dtype
    g = torch.Generator().manual_seed(seed)
    if cfg.model == "mlp":
        torso = MLPTorso(cfg.obs_shape[-1], dtype=torso_dtype, generator=g)
    elif cfg.model == "shallow_cnn":
        torso = AtariShallowTorso(cfg.obs_shape[-1], dtype=torso_dtype, generator=g)
    elif cfg.model == "deep_resnet":
        torso = AtariDeepTorso(
            cfg.obs_shape[-1],
            in_hw=tuple(cfg.obs_shape[:2]),
            dtype=torso_dtype,
            fused_blocks=cfg.fused_conv,
            generator=g,
        )
    else:
        raise ValueError(f"unknown model {cfg.model!r}")
    core = cfg.core
    if core == "auto":
        core = "lstm" if cfg.use_lstm else "none"
    transformer = None
    if core == "transformer":
        transformer = dict(
            d_model=cfg.transformer_d_model,
            num_layers=cfg.transformer_layers,
            num_heads=cfg.transformer_heads,
            window=cfg.transformer_window,
            dense_kernel=resolve_dense_kernel(cfg),
            dtype=cfg.transformer_dtype,
        )
    net = ImpalaNet(
        cfg.num_actions,
        torso,
        core=core,
        lstm_size=cfg.lstm_size,
        generator=g,
        transformer=transformer,
        remat_torso=cfg.remat_torso,
    )
    return Agent(net)


def check_train_dtype_parity(
    cfg: ExperimentConfig,
    device,
    *,
    seed: int = 0,
    batch: int = 8,
    unroll: int = 4,
) -> tuple[bool, int]:
    """The greedy-action gate of `train_dtype` (JAX's
    `check_train_dtype_parity`): on a fixed `[unroll, batch]` probe made
    from `seed`, the argmax actions of the f32 agent and of the train
    dtype's agent on the params lowered as the learner's closure lowers
    them must agree. Returns (ok, mismatches over the unroll * batch
    actions); float32 is (True, 0) at once. Runs on `device`."""
    if cfg.train_dtype == "float32":
        return True, 0
    device = torch.device(device)
    ref = make_agent(dataclasses.replace(cfg, train_dtype="float32"), seed=seed).net.to(device)
    half = make_agent(cfg, seed=seed).net.to(device)
    half.load_state_dict(ref.state_dict())
    rng = np.random.default_rng(seed)
    shape = (unroll, batch, *cfg.obs_shape)
    if cfg.obs_dtype == "uint8":
        probe = rng.integers(0, 256, size=shape, dtype=np.uint8)
    else:
        probe = rng.normal(size=shape).astype(cfg.obs_dtype)
    obs = torch.from_numpy(probe).to(device)
    first = torch.zeros((unroll, batch), dtype=torch.bool, device=device)
    first[0] = True

    def greedy(net):
        out, _ = net(obs, first, net.initial_state(batch), unroll=True)
        return out.policy_logits.argmax(-1)

    with torch.no_grad():
        a_ref = greedy(ref)
        lowered = precision.cast_to_compute(
            dict(ref.named_parameters()),
            getattr(torch, cfg.train_dtype),
            half.straight_through_params(),
        )
        with bound_params(half, lowered):
            a_half = greedy(half)
    mismatches = int((a_ref != a_half).sum())
    return mismatches == 0, mismatches


def make_learner_config(cfg: ExperimentConfig) -> LearnerConfig:
    return LearnerConfig(
        batch_size=cfg.batch_size,
        unroll_length=cfg.unroll_length,
        loss=ImpalaLossConfig(
            discount=cfg.discount,
            vf_coef=cfg.vf_coef,
            entropy_coef=cfg.entropy_coef,
            reduction=cfg.loss_reduction,
            fused_epilogue=cfg.fused_epilogue,
            health_diagnostics=cfg.health_diagnostics,
            train_dtype=cfg.train_dtype,
        ),
        max_grad_norm=cfg.max_grad_norm,
        traj_ring=cfg.traj_ring,
        steps_per_dispatch=cfg.steps_per_dispatch,
        donate_batch=cfg.donate_batch,
        train_dtype=cfg.train_dtype,
    )


def scaled_base_lr(cfg: ExperimentConfig) -> float:
    """cfg.lr linearly scaled by the effective batch, `batch_size *
    steps_per_dispatch` (B * K, as JAX's), against `lr_scale_ref_batch`
    (arxiv 1803.02811); 0 turns the scaling off."""
    if cfg.lr_scale_ref_batch <= 0:
        return cfg.lr
    effective_batch = cfg.batch_size * max(1, cfg.steps_per_dispatch)
    return cfg.lr * (effective_batch / cfg.lr_scale_ref_batch)


def make_lr_schedule(cfg: ExperimentConfig):
    """The learning-rate schedule, or a constant, indexed by the optimizer's
    count: a linear warmup over `lr_warmup_steps` from 0 to the
    (batch-scaled) base lr, then the linear anneal to 0 over the remaining
    learner steps, or a constant tail with lr_anneal=False (JAX's
    `make_lr_schedule`)."""
    base_lr = scaled_base_lr(cfg)
    warmup = max(0, cfg.lr_warmup_steps)
    if cfg.lr_anneal:
        tail = linear_schedule(base_lr, 0.0, max(1, cfg.total_learner_steps - warmup))
    elif warmup:
        tail = constant_schedule(base_lr)
    else:
        return base_lr
    if warmup:
        return join_schedules([linear_schedule(0.0, base_lr, warmup), tail], [warmup])
    return tail


def make_optimizer(cfg: ExperimentConfig) -> RMSProp:
    return RMSProp(
        make_lr_schedule(cfg), decay=cfg.rmsprop_decay, eps=cfg.rmsprop_eps
    )


@dataclasses.dataclass(frozen=True)
class _EnvFactory:
    """Picklable (seed, env_index=None) -> env for one preset (fake envs
    only), a module-level class so the process pool can ship it to its
    workers. Each env's `task_id` is `env_index % num_tasks` (the seed
    when no index is given), as JAX's factory assigns it."""

    cfg: ExperimentConfig

    def _task_of(self, seed: int, env_index) -> int:
        idx = env_index if env_index is not None else seed
        return idx % max(1, self.cfg.num_tasks)

    def __call__(self, seed: int, env_index: Optional[int] = None):
        from torched_impala_tpu_torch.envs.fake import FakeAtariEnv, FakeDiscreteEnv

        cfg = self.cfg
        task = self._task_of(seed, env_index)
        if cfg.obs_dtype == "uint8":
            return FakeAtariEnv(
                num_actions=cfg.num_actions, seed=seed, obs_shape=cfg.obs_shape, task_id=task
            )
        return FakeDiscreteEnv(
            obs_shape=cfg.obs_shape, num_actions=cfg.num_actions, task_id=task, seed=seed
        )


def make_env_factory(
    cfg: ExperimentConfig, *, fake: bool = False
) -> Callable[..., object]:
    """Env factory for `cfg`. Only the shape-faithful fakes are ported:
    the real emulators (gymnasium, ale-py) are absent on the port's hosts."""
    if not fake:
        raise NotImplementedError(
            "real environments are not ported yet; pass fake=True "
            "(--fake-envs) (ROADMAP.md queue 1: Real envs and the rest of the "
            "CartPole path)"
        )
    return _EnvFactory(cfg)
