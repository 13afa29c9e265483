"""Experiment configs and the builders that turn one into the port's
objects (counterpart of `torched_impala_tpu/configs.py`, cut to the
fields and presets of the ported slices; preset values are unchanged).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from torched_impala_tpu_torch.models.agent import Agent
from torched_impala_tpu_torch.models.nets import ImpalaNet
from torched_impala_tpu_torch.models.torsos import (
    AtariDeepTorso,
    AtariShallowTorso,
    MLPTorso,
)
from torched_impala_tpu_torch.ops.losses import ImpalaLossConfig
from torched_impala_tpu_torch.optim import RMSProp, linear_schedule
from torched_impala_tpu_torch.runtime.learner import LearnerConfig


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """The fields of the JAX `ExperimentConfig` that this slice reads."""

    name: str
    obs_shape: tuple = ()
    obs_dtype: str = "float32"
    num_actions: int = 2
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
    total_env_frames: int = 1_000_000
    lr: float = 6e-4
    lr_anneal: bool = True  # linear anneal to 0 over total_learner_steps
    rmsprop_decay: float = 0.99
    rmsprop_eps: float = 1e-7
    max_grad_norm: float = 40.0
    discount: float = 0.99
    entropy_coef: float = 0.01
    vf_coef: float = 0.5

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

PRESETS = {c.name: c for c in (CARTPOLE, PONG, BREAKOUT, PONG_TRANSFORMER)}

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
    g = torch.Generator().manual_seed(seed)
    if cfg.model == "mlp":
        torso = MLPTorso(cfg.obs_shape[-1], dtype=cfg.compute_dtype, generator=g)
    elif cfg.model == "shallow_cnn":
        torso = AtariShallowTorso(
            cfg.obs_shape[-1], dtype=cfg.compute_dtype, generator=g
        )
    elif cfg.model == "deep_resnet":
        torso = AtariDeepTorso(
            cfg.obs_shape[-1],
            in_hw=tuple(cfg.obs_shape[:2]),
            dtype=cfg.compute_dtype,
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
    )
    return Agent(net)


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
        ),
        max_grad_norm=cfg.max_grad_norm,
        traj_ring=cfg.traj_ring,
    )


def make_lr_schedule(cfg: ExperimentConfig):
    """Linear anneal from cfg.lr to 0 over the run's learner steps, indexed
    by the optimizer's step count; a constant with lr_anneal=False."""
    if not cfg.lr_anneal:
        return cfg.lr
    return linear_schedule(cfg.lr, 0.0, cfg.total_learner_steps)


def make_optimizer(cfg: ExperimentConfig) -> RMSProp:
    return RMSProp(
        make_lr_schedule(cfg), decay=cfg.rmsprop_decay, eps=cfg.rmsprop_eps
    )


@dataclasses.dataclass(frozen=True)
class _EnvFactory:
    """(seed, env_index=None) -> env for one preset (fake envs only)."""

    cfg: ExperimentConfig

    def __call__(self, seed: int, env_index: Optional[int] = None):
        from torched_impala_tpu_torch.envs.fake import FakeAtariEnv, FakeDiscreteEnv

        cfg = self.cfg
        if cfg.obs_dtype == "uint8":
            if tuple(cfg.obs_shape) != (84, 84, 4):
                raise NotImplementedError(
                    f"fake pixel envs are 84x84x4 only, got {cfg.obs_shape}"
                )
            return FakeAtariEnv(num_actions=cfg.num_actions, seed=seed)
        return FakeDiscreteEnv(
            obs_shape=cfg.obs_shape, num_actions=cfg.num_actions, seed=seed
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
