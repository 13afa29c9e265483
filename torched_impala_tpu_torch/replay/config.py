"""Replay's knobs (counterpart of `torched_impala_tpu/replay/config.py`).

One frozen dataclass carries the whole IMPACT surface (ring retention,
sampling, the target network's cadence, the surrogate's clip) through
`LearnerConfig.replay`.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    """IMPACT-style circular replay (arxiv 1912.00167).

    `max_reuse=1` with `target_update_interval=0` is the disabled
    configuration: the learner takes the step it takes without replay,
    bit for bit.
    """

    # Deliveries of each committed ring slot (1 = train once). > 1 turns
    # the trajectory ring into a circular replay buffer and needs a target
    # network (target_update_interval >= 1): replayed data is off-policy,
    # and the plain V-trace step has no clip against the drift.
    max_reuse: int = 1
    # Most of the delivered batches that may be replays (fresh batches
    # always come first; this caps how far replays run ahead when the
    # actors stall). 1.0 leaves the reuse budget as the only bound.
    replay_mix: float = 1.0
    # Expire a retained slot once the learner's frame counter is more
    # than this many frames past the slot's acting param version (0 = no
    # bound; the reuse budget still applies). The ring checks it at every
    # version note, draw and release.
    staleness_frames: int = 0
    # Learner steps between target-network refreshes (a copy on the
    # device, no host sync: replay/target_store.py). 0 = no target network
    # (only with max_reuse == 1).
    target_update_interval: int = 0
    # PPO-style clip of the learner/target ratio in the surrogate
    # (ops.losses.impact_loss); IMPACT's epsilon.
    target_clip_epsilon: float = 0.2
    # Refuse a target older than this many frames behind the newest
    # version the learner reported (0 = never refuse).
    target_max_lag_frames: int = 0
    # Seed of the ring's replay sampler (np.random.default_rng): the
    # staleness-weighted draw among retained slots is deterministic given
    # the seed and the order of deliveries.
    sampler_seed: int = 0

    @property
    def enabled(self) -> bool:
        """True when this config changes the learner's behaviour at all."""
        return self.max_reuse > 1 or self.target_update_interval > 0

    def validate(self) -> None:
        if self.max_reuse < 1:
            raise ValueError(f"max_reuse must be >= 1, got {self.max_reuse}")
        if not (0.0 < self.replay_mix <= 1.0):
            raise ValueError(
                f"replay_mix must be in (0, 1], got {self.replay_mix}"
            )
        if self.staleness_frames < 0:
            raise ValueError(
                f"staleness_frames must be >= 0, got {self.staleness_frames}"
            )
        if self.target_update_interval < 0:
            raise ValueError(
                f"target_update_interval must be >= 0, got "
                f"{self.target_update_interval}"
            )
        if self.max_reuse > 1 and self.target_update_interval < 1:
            raise ValueError(
                "max_reuse > 1 replays off-policy data and requires the "
                "clipped target-network surrogate: set "
                "target_update_interval >= 1 (IMPACT, arxiv 1912.00167)"
            )
        if not (0.0 < self.target_clip_epsilon < 1.0):
            raise ValueError(
                f"target_clip_epsilon must be in (0, 1), got "
                f"{self.target_clip_epsilon}"
            )
        if self.target_max_lag_frames < 0:
            raise ValueError(
                f"target_max_lag_frames must be >= 0, got "
                f"{self.target_max_lag_frames}"
            )
