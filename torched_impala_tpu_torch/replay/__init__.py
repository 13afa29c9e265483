"""IMPACT-style circular replay (arxiv 1912.00167; counterpart of
`torched_impala_tpu/replay/`): the learner trains on each trajectory-ring
slot more than once without off-policy collapse.

- Ring replay: `runtime/traj_ring.py`'s retain-after-release mode
  (`max_reuse`, `replay_mix`, `staleness_frames`): released slots wait on
  a retained list, and a seeded sampler that prefers fresh slots delivers
  them again until their reuse budget or staleness bound runs out.
- Target network: `TargetParamStore` keeps a copy of the learner params
  on the device, refreshed every `target_update_interval` steps: the
  pi_target of the clipped surrogate.
- Clipped-target surrogate loss: `ops.losses.impact_loss` takes V-trace's
  corrections against the target policy and clips the learner/target
  ratio PPO-style.

`ReplayConfig` is the one knob surface; `LearnerConfig.replay` carries it
through the runtime.
"""

from torched_impala_tpu_torch.replay.config import ReplayConfig
from torched_impala_tpu_torch.replay.target_store import TargetParamStore

__all__ = ["ReplayConfig", "TargetParamStore"]
