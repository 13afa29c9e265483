"""The port's IMPACT replay held against the JAX package's, on the CPU.

- `ReplayConfig`: `enabled` and `validate` case by case, the same
  messages.
- The trajectory ring in replay mode against JAX's `TrajectoryRing`,
  driven by the same script of fill, pop_ready, release, note_version and
  held writer blocks, for the cases of JAX's tests/test_replay.py (fresh
  first, the inert max_reuse=1 ring, the metrics, the seeded sampler, the
  replay_mix cap, the staleness bound, eviction under pressure, a
  delivered slot never evicted, a stale writer's commit) and
  `discard_torn` with a retained slot: the same delivered slots,
  `reuse_count`, `staleness`, param versions, generations and contents,
  the same retained and free lists, and the same `replay/*` registry
  values.
- `TargetParamStore` against JAX's: the cadence, the lag, the refusals,
  the constructor's checks; and the pinned copy survives an in-place
  update of the params it was taken from.
- `clipped_surrogate` and `impact_loss` against JAX's: the total, every
  log (the health ones too), the grads to the learner logits and the
  values, none to the target; sum and mean reductions, a mask with zeros,
  learner == target (the surrogate's minimum ties everywhere), and a
  ratio exactly on 1 - eps and 1 + eps in both frameworks, where
  `jnp.clip` passes half the gradient.
- One replay step against JAX's `_train_step_replay_impl` from the same
  params, target and batch: MLP, narrow Nature-CNN and deep torso + LSTM
  in float32 (params at rtol 1e-4, atol 1e-6; logs at rtol 1e-4, atol
  1e-5), and the narrow deep torso + LSTM in bf16 (JAX's LSTM net in step
  mode and compiled without XLA's excess precision, as
  tests/test_torch_port_bf16.py runs it; the step within BF16_STEP_RTOL
  by relative L2).
- The learner: a disabled `ReplayConfig` is bit for bit `replay=None`;
  JAX's scenario of 6 steps from 3 fresh batches (3 replays); the four
  refusals with JAX's messages; `set_state` pins the target again; the
  replayed batch's `reuse_count` and `staleness` reach `BatchLineage`.
- The CLI: `run.REPLAY_CPU_EXAMPLE` returns 0.

Actors here are thread actors or a bare ring: no process pool.
"""

import dataclasses
import queue
import shlex

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torched_impala_tpu.models import Agent as JaxAgent
from torched_impala_tpu.models import AtariDeepTorso as JaxDeep
from torched_impala_tpu.models import AtariShallowTorso as JaxAtari
from torched_impala_tpu.models import ImpalaNet as JaxNet
from torched_impala_tpu.models import MLPTorso as JaxMLP
from torched_impala_tpu.ops import losses as jax_losses
from torched_impala_tpu.ops import vtrace as jax_vtrace
from torched_impala_tpu.replay import ReplayConfig as JaxReplayConfig
from torched_impala_tpu.replay import TargetParamStore as JaxTargetStore
from torched_impala_tpu.runtime import Learner as JaxLearner
from torched_impala_tpu.runtime import LearnerConfig as JaxLearnerConfig
from torched_impala_tpu.runtime import ParamStore as JaxParamStore
from torched_impala_tpu.runtime import TrajectoryRing as JaxRing
from torched_impala_tpu.telemetry.registry import Registry as JaxRegistry
from torched_impala_tpu_torch import configs, run
from torched_impala_tpu_torch.envs.fake import ScriptedEnv
from torched_impala_tpu_torch.models.agent import Agent
from torched_impala_tpu_torch.models.convert import params_from_jax
from torched_impala_tpu_torch.models.nets import ImpalaNet
from torched_impala_tpu_torch.models.torsos import AtariDeepTorso, AtariShallowTorso, MLPTorso
from torched_impala_tpu_torch.ops import losses as port_losses
from torched_impala_tpu_torch.ops import vtrace as port_vtrace
from torched_impala_tpu_torch.optim import RMSProp
from torched_impala_tpu_torch.replay import ReplayConfig, TargetParamStore
from torched_impala_tpu_torch.runtime.learner import Learner, LearnerConfig
from torched_impala_tpu_torch.runtime.param_store import ParamStore
from torched_impala_tpu_torch.runtime.traj_ring import TrajectoryRing
from torched_impala_tpu_torch.runtime.vector_actor import VectorActor
from torched_impala_tpu_torch.telemetry import Registry

# Losses: the port's f32 ops against JAX's on the same inputs.
TOL = dict(rtol=1e-5, atol=1e-6)
# A learner step from the same state (tests/test_torch_port_learner.py's
# limits): the params after it and its logs.
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
LOG_TOL = dict(rtol=1e-4, atol=1e-5)
# The bf16 replay step against JAX's bf16 replay step, by the relative L2
# distance of the whole step, as tests/test_torch_port_bf16.py holds the
# bf16 step (STEP_RTOL there, 2^-5; the same rounding of the same
# operations, summed in another order, in both unrolls); the loss logs
# at its LOG_TOL, 1e-3.
BF16_STEP_RTOL = 2.0**-5
BF16_LOG_TOL = 1e-3
A, LSTM = 4, 16
LR, DECAY, EPS = 6e-4, 0.99, 1e-7
EXACT = {"xla_allow_excess_precision": False}
# The replay step's target: each param plus seeded normal noise of this
# many of its own standard deviations, so that the learner/target ratio is
# off 1 and the clip acts on some steps and not on others (measured clip
# fractions 0.125-0.58 on the four nets). Measured against JAX: the f32
# steps within 1.4e-6 relative L2, their logs within 2.1e-5 of 1 + |log|
# (Nature-CNN's); the bf16 step 1.33e-2 relative L2, its loss logs within
# 8.1e-4 (grad_norm_unclipped).
TARGET_NOISE = 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _outcome(fn):
    """('ok', value) or (exception type name, message)."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - compared across the packages
        return (type(e).__name__, str(e))


# ---- ReplayConfig ----------------------------------------------------------

CONFIG_CASES = {
    "default": {},
    "target_only": dict(target_update_interval=4),
    "reuse_and_target": dict(max_reuse=2, target_update_interval=1),
    "reuse_without_target": dict(max_reuse=2),
    "reuse_zero": dict(max_reuse=0),
    "mix_zero": dict(replay_mix=0.0),
    "mix_above_one": dict(replay_mix=1.5),
    "mix_third": dict(replay_mix=0.34, max_reuse=3, target_update_interval=2),
    "staleness_negative": dict(staleness_frames=-1),
    "interval_negative": dict(target_update_interval=-1),
    "epsilon_zero": dict(target_clip_epsilon=0.0),
    "epsilon_one": dict(target_clip_epsilon=1.0),
    "lag_negative": dict(target_max_lag_frames=-1),
    "everything": dict(max_reuse=4, replay_mix=0.5, staleness_frames=100,
                       target_update_interval=8, target_clip_epsilon=0.3,
                       target_max_lag_frames=50, sampler_seed=3),
}


@pytest.mark.parametrize("case", list(CONFIG_CASES))
def test_replay_config_matches_jax(case):
    fields = CONFIG_CASES[case]
    port, want = ReplayConfig(**fields), JaxReplayConfig(**fields)
    assert port.enabled == want.enabled
    assert _outcome(port.validate) == _outcome(want.validate)
    assert dataclasses.asdict(port) == dataclasses.asdict(want)


def test_replay_config_fields_are_jaxs():
    assert [f.name for f in dataclasses.fields(ReplayConfig)] == [
        f.name for f in dataclasses.fields(JaxReplayConfig)
    ]
    assert not ReplayConfig().enabled


# ---- the ring in replay mode -----------------------------------------------


class _Driver:
    """One ring (JAX's or the port's) with its own registry, driven by a
    script; `trace` records what each step saw."""

    def __init__(self, ring_cls, registry_cls, *, T=2, B=2, num_slots=3, **replay):
        self.registry = registry_cls()
        self.jax = ring_cls is JaxRing
        self.ring = ring_cls(
            num_slots=num_slots, unroll_length=T, batch_size=B,
            example_obs=np.zeros((4,), np.float32), num_actions=2,
            telemetry=self.registry, **replay,
        )
        self.popped, self.held, self.trace = [], None, []

    def rewards(self, view):
        return np.asarray(view.arrays[4] if self.jax else view.tensors[4])

    def fill(self, value, version):
        block = self.ring.acquire(self.ring.batch_size)
        block.obs[...] = 0.0
        block.first[...] = False
        block.actions[...] = 0
        block.behaviour_logits[...] = 0.0
        block.rewards[...] = value
        block.cont[...] = 1.0
        if self.jax:
            block.task[...] = 0
        self.ring.commit(block, param_version=version)

    def pop(self, timeout=1.0):
        view = self.ring.pop_ready(timeout=timeout)
        if view is None:
            self.trace.append(("pop", None))
            return
        self.popped.append(view)
        self.trace.append(("pop", view.slot, view.reuse_count, view.staleness,
                           view.param_version, view.gen, float(self.rewards(view)[0, 0])))

    def run(self, script):
        for op, *args in script:
            if op == "fill":
                self.fill(*args)
            elif op == "pop":
                self.pop(*args)
            elif op == "release":
                self.ring.release(self.popped[-1].slot)
            elif op == "pop_release":
                self.pop()
                self.ring.release(self.popped[-1].slot)
            elif op == "note":
                self.ring.note_version(*args)
            elif op == "hold":
                self.held = self.ring.acquire(args[0] if args else self.ring.batch_size)
            elif op == "commit_held":
                self.trace.append(("commit_held", _outcome(
                    lambda: self.ring.commit(self.held, param_version=args[0]))[0]))
            elif op == "discard":
                self.trace.append(("discard", self.ring.discard_torn()))
            elif op == "contents":
                # The last delivered view's buffers: one value throughout.
                r = self.rewards(self.popped[-1])
                self.trace.append(("contents", float(r.min()), float(r.max())))
            elif op == "state":
                slots = self.ring._slots
                self.trace.append((
                    "state", list(self.ring._retained), sorted(self.ring._free),
                    [s.gen for s in slots],
                    [int(slots[i].versions.min()) if self.jax else slots[i].version()
                     for i in self.ring._retained],
                ))
            else:
                raise ValueError(op)
        return self

    def replay_metrics(self):
        return {k: v for k, v in self.registry.snapshot().items()
                if k.startswith("telemetry/replay/")}


RING_CASES = {
    # JAX tests/test_replay.py:82 - both fresh slots first, then the two
    # replays, then nothing.
    "fresh_first_then_replay_then_exhausted": (
        dict(max_reuse=2),
        [("fill", 1.0, 5), ("fill", 2.0, 6), ("pop_release",), ("pop_release",),
         ("pop_release",), ("pop_release",), ("pop", 0.05), ("state",)],
    ),
    # :103 - max_reuse=1 is inert (and registers no replay/* series).
    "reuse_one_is_inert": (
        dict(max_reuse=1),
        [("fill", 1.0, 0), ("pop_release",), ("state",), ("pop", 0.05)],
    ),
    # :119 - the replay/* metrics counted.
    "replay_metrics_counted": (
        dict(max_reuse=2),
        [("fill", 1.0, 0), ("pop_release",), ("pop_release",), ("state",)],
    ),
    # :133 - the seeded sampler: four slots drained fresh, then drawn.
    "sampler_seed_7": (
        dict(B=1, num_slots=6, max_reuse=2, sampler_seed=7),
        [*(("fill", float(i), i) for i in range(4)), *(("pop_release",),) * 8, ("state",)],
    ),
    # The same with a frame watermark, so the weights 1/(1+staleness)
    # differ slot to slot, and three deliveries each.
    "sampler_weighted_by_staleness": (
        dict(B=1, num_slots=6, max_reuse=3, sampler_seed=11),
        [*(("fill", float(i), 4 * i) for i in range(4)), *(("pop_release",),) * 4,
         ("note", 13), *(("pop_release",),) * 8, ("pop", 0.05), ("state",)],
    ),
    # :151 - the replay_mix cap.
    "replay_mix_caps_replays": (
        dict(max_reuse=3, replay_mix=0.34),
        [("fill", 1.0, 0), ("pop_release",), ("pop", 0.05), ("fill", 2.0, 0),
         ("pop_release",), ("pop_release",), ("pop", 0.05), ("state",)],
    ),
    # :166 - the staleness bound expires a retained slot.
    "staleness_bound_expires": (
        dict(max_reuse=3, staleness_frames=10),
        [("fill", 1.0, 100), ("pop_release",), ("state",), ("note", 105), ("state",),
         ("note", 111), ("state",), ("pop", 0.05)],
    ),
    # A retained slot past the bound at its release is recycled there.
    "staleness_ends_at_release": (
        dict(max_reuse=3, staleness_frames=10),
        [("fill", 1.0, 100), ("pop",), ("note", 120), ("release",), ("state",),
         ("pop", 0.05)],
    ),
    # :182 - eviction under pressure: acquire never blocks, the stalest
    # retained slot goes.
    "eviction_under_pressure": (
        dict(num_slots=2, max_reuse=5),
        [("fill", 1.0, 1), ("fill", 2.0, 9), ("pop_release",), ("pop_release",),
         ("state",), ("fill", 3.0, 10), ("state",)],
    ),
    # :200 - a delivered (replayed) slot is never the eviction candidate.
    "delivered_slot_never_evicted": (
        dict(num_slots=2, max_reuse=5),
        [("fill", 1.0, 1), ("fill", 2.0, 2), ("pop_release",), ("pop_release",),
         ("pop",), ("state",), ("fill", 3.0, 3), ("state",), ("contents",), ("release",),
         ("state",)],
    ),
    # :221 - a stale writer's commit still raises only where its slot was
    # recycled; here its slot never was.
    "stale_writer_commit": (
        dict(num_slots=2, max_reuse=5),
        [("fill", 1.0, 1), ("hold",), ("pop",), ("release",), ("fill", 9.0, 2),
         ("state",), ("commit_held", 2), ("state",)],
    ),
    # A writer holding a block of an evicted slot: its commit raises.
    "evicted_writer_commit_raises": (
        dict(num_slots=2, max_reuse=5, B=2),
        [("fill", 1.0, 1), ("pop",), ("release",), ("fill", 2.0, 2), ("pop",), ("release",),
         ("state",), ("hold", 1), ("state",), ("commit_held", 3), ("state",)],
    ),
    # discard_torn recycles the torn slot and keeps the retained one.
    "discard_torn_keeps_retained": (
        dict(num_slots=4, max_reuse=2),
        [("fill", 1.0, 1), ("pop_release",), ("hold", 1), ("state",), ("discard",),
         ("state",), ("commit_held", 2), ("pop_release",), ("state",)],
    ),
}


@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_replay_matches_jax(case):
    fields, script = RING_CASES[case]
    want = _Driver(JaxRing, JaxRegistry, **fields).run(script)
    got = _Driver(TrajectoryRing, Registry, **fields).run(script)
    assert got.trace == want.trace
    np.testing.assert_equal(got.replay_metrics(), want.replay_metrics())
    if fields.get("max_reuse", 1) == 1:
        assert got.replay_metrics() == {}
    else:
        assert got.replay_metrics()


def test_ring_superbatch_replay_refusal_matches_jax():
    kw = dict(num_slots=2, unroll_length=2, batch_size=2,
              example_obs=np.zeros((4,), np.float32), num_actions=2,
              max_reuse=2, superbatch_k=2)
    assert _outcome(lambda: TrajectoryRing(**kw)) == _outcome(lambda: JaxRing(**kw))
    assert _outcome(lambda: TrajectoryRing(**{**kw, "superbatch_k": 1, "replay_mix": 0.0}))[0] \
        == "ValueError"


# ---- TargetParamStore -------------------------------------------------------

def _stores(update_interval=4, max_lag_frames=0):
    jstore, pstore = JaxParamStore(), ParamStore()
    jstore.publish(0, {"w": jnp.ones((2,))})
    pstore.publish(0, {"w": torch.ones(2)})
    jreg, preg = JaxRegistry(), Registry()
    return (
        JaxTargetStore(jstore, update_interval=update_interval, max_lag_frames=max_lag_frames,
                       telemetry=jreg), jreg,
        TargetParamStore(pstore, update_interval=update_interval,
                         max_lag_frames=max_lag_frames, telemetry=preg), preg,
    )


TARGET_SCRIPTS = {
    # JAX tests/test_replay.py:257 - the cadence and the lag.
    "cadence_and_lag": dict(interval=4, lag=0, calls=[
        ("update", 0, 0), ("maybe", 1, 8), ("maybe", 2, 16), ("maybe", 3, 24),
        ("maybe", 4, 32), ("maybe", 5, 40), ("maybe", 8, 64), ("maybe", 9, 72),
    ]),
    # :269 - the refusal past max_lag_frames.
    "max_lag_refusal": dict(interval=100, lag=5, calls=[
        ("update", 0, 0), ("maybe", 1, 4), ("maybe", 2, 6), ("update", 6, 3),
    ]),
    # No update before maybe_update: the first call pins.
    "first_maybe_pins": dict(interval=3, lag=0, calls=[
        ("maybe", 1, 8), ("maybe", 2, 16), ("maybe", 4, 32),
    ]),
}


@pytest.mark.parametrize("case", list(TARGET_SCRIPTS))
def test_target_store_matches_jax(case):
    spec = TARGET_SCRIPTS[case]
    jtps, jreg, ptps, preg = _stores(spec["interval"], spec["lag"])
    assert _outcome(ptps.current) == _outcome(jtps.current)
    for i, (op, step, version) in enumerate(spec["calls"]):
        params = float(i)
        if op == "update":
            jtps.update({"w": jnp.full((2,), params)}, version=version, step=step)
            ptps.update({"w": torch.full((2,), params)}, version=version, step=step)
            results = (None, None)
        else:
            results = (jtps.maybe_update(step, {"w": jnp.full((2,), params)}, version),
                       ptps.maybe_update(step, {"w": torch.full((2,), params)}, version))
        assert results[1] == results[0], (i, op)
        assert (ptps.version, ptps.lag()) == (jtps.version, jtps.lag()), (i, op)
        jcur, pcur = _outcome(jtps.current), _outcome(ptps.current)
        assert pcur[0] == jcur[0], (i, pcur, jcur)
        if jcur[0] == "ok":
            assert pcur[1][0] == jcur[1][0]
            np.testing.assert_array_equal(pcur[1][1]["w"].numpy(), np.asarray(jcur[1][1]["w"]))
        else:
            assert pcur == jcur
        assert preg.snapshot() == jreg.snapshot(), (i, op)


def test_target_store_constructor_checks_match_jax():
    for kw in (dict(update_interval=0), dict(update_interval=1, max_lag_frames=-1)):
        assert _outcome(lambda: TargetParamStore(ParamStore(), **kw)) == _outcome(
            lambda: JaxTargetStore(JaxParamStore(), **kw))


def test_target_store_pins_a_copy_that_survives_in_place_updates():
    """The optimizer updates the params in place: the pinned target must be
    a copy, or its ratio to the learner would stay 1."""
    _, _, tps, _ = _stores()
    params = {"w": torch.arange(2.0), "b": torch.zeros(3)}
    tps.update(params, version=10, step=0)
    params["w"].add_(5.0)
    params["b"].fill_(1.0)
    version, pinned = tps.current()
    assert version == 10
    assert torch.equal(pinned["w"], torch.tensor([0.0, 1.0]))
    assert torch.equal(pinned["b"], torch.zeros(3))
    assert all(pinned[k].data_ptr() != params[k].data_ptr() for k in params)


# ---- clipped_surrogate and impact_loss --------------------------------------

def _on_both(x_np, jax_fn, torch_fn):
    return np.asarray(jax_fn(jnp.asarray(x_np))), torch_fn(torch.from_numpy(x_np)).numpy()


def _exactly(bound: float) -> np.float32:
    """A float32 log-ratio whose exp is exactly float32(bound) in both
    jnp.exp and torch.exp (searched from log(bound), ulp by ulp)."""
    target = np.float32(bound)
    x = np.float32(np.log(target))
    for k in range(200):
        for cand in (x, ) if k == 0 else (
            np.float32(x + np.float32(k) * np.spacing(x)), np.float32(x - np.float32(k) * np.spacing(x))
        ):
            j, t = _on_both(np.array([cand], np.float32), jnp.exp, torch.exp)
            if j[0] == target and t[0] == target:
                return cand
    raise AssertionError(f"no float32 x with exp(x) == {target} in both")


def test_clipped_surrogate_at_the_clip_bounds_matches_jax():
    """A ratio exactly on 1 - eps and 1 + eps: `jnp.clip` passes half the
    gradient there, as the port's minimum(maximum()) does; torch.clamp
    would pass all of it (the test sees the difference)."""
    eps = 0.2
    lo, hi = _exactly(1.0 - eps), _exactly(1.0 + eps)
    log_ratio = np.array([lo, 0.0, hi, lo, hi, -0.5, 0.5], np.float32)
    adv = np.array([1.0, 1.0, 1.0, -1.0, -1.0, 2.0, -3.0], np.float32)

    def jax_sum(lr):
        return jax_vtrace.clipped_surrogate(lr, jnp.asarray(adv), eps)[0].sum()

    want_value = np.asarray(jax_vtrace.clipped_surrogate(jnp.asarray(log_ratio), jnp.asarray(adv), eps)[0])
    want_grad = np.asarray(jax.grad(jax_sum)(jnp.asarray(log_ratio)))
    lr = torch.from_numpy(log_ratio).requires_grad_()
    surrogate, ratio = port_vtrace.clipped_surrogate(lr, torch.from_numpy(adv), eps)
    (grad,) = torch.autograd.grad(surrogate.sum(), lr)
    assert ratio[0].item() == np.float32(0.8) and ratio[2].item() == np.float32(1.2)
    np.testing.assert_array_equal(surrogate.detach().numpy(), want_value)
    np.testing.assert_allclose(grad.numpy(), want_grad, **TOL)
    # clamp's gradient at the bounds is another one.
    lr2 = torch.from_numpy(log_ratio).requires_grad_()
    r = torch.exp(lr2)
    a = torch.from_numpy(adv)
    clamp = torch.minimum(r * a, torch.clamp(r, 1 - eps, 1 + eps) * a)
    (clamp_grad,) = torch.autograd.grad(clamp.sum(), lr2)
    assert not np.allclose(clamp_grad.numpy(), want_grad, **TOL)


def _impact_inputs(seed, mask=True, same=False, A6=6):
    rng = np.random.default_rng(seed)
    T, B = 5, 4
    learner = rng.normal(size=(T, B, A6)).astype(np.float32) * 1.5
    x = dict(
        learner_logits=learner,
        target_logits=learner.copy() if same
        else (learner + rng.normal(size=(T, B, A6)).astype(np.float32) * 0.6),
        behaviour_logits=rng.normal(size=(T, B, A6)).astype(np.float32),
        values=rng.normal(size=(T, B)).astype(np.float32),
        bootstrap_value=rng.normal(size=(B,)).astype(np.float32),
        actions=rng.integers(0, A6, size=(T, B)).astype(np.int32),
        rewards=rng.normal(size=(T, B)).astype(np.float32),
        discounts=(0.99 * (rng.uniform(size=(T, B)) > 0.2)).astype(np.float32),
    )
    if mask:
        x["mask"] = (rng.uniform(size=(T, B)) > 0.25).astype(np.float32)
    return x


IMPACT_CASES = {
    "sum_mask": dict(reduction="sum", mask=True),
    "mean_mask": dict(reduction="mean", mask=True),
    "sum_no_mask": dict(reduction="sum", mask=False),
    "learner_equals_target": dict(reduction="sum", mask=True, same=True),
    "health": dict(reduction="sum", mask=True, health=True),
    "mean_health_eps_0_1": dict(reduction="mean", mask=True, health=True, eps=0.1),
}


@pytest.mark.parametrize("case", list(IMPACT_CASES))
def test_impact_loss_matches_jax(case):
    spec = IMPACT_CASES[case]
    x = _impact_inputs(7, mask=spec["mask"], same=spec.get("same", False))
    eps = spec.get("eps", 0.2)
    health = spec.get("health", False)
    jcfg = jax_losses.ImpalaLossConfig(vtrace_implementation="scan", reduction=spec["reduction"],
                                       health_diagnostics=health)

    def jax_total(learner, values, target):
        j = {k: jnp.asarray(v) for k, v in x.items()}
        out = jax_losses.impact_loss(
            **{**j, "learner_logits": learner, "values": values, "target_logits": target},
            clip_epsilon=eps, config=jcfg,
        )
        return out.total, out.logs

    (want_total, want_logs), want_grads = jax.value_and_grad(jax_total, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x["learner_logits"]), jnp.asarray(x["values"]), jnp.asarray(x["target_logits"]))
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    leaves = [t[k].requires_grad_() for k in ("learner_logits", "values", "target_logits")]
    out = port_losses.impact_loss(
        **t, clip_epsilon=eps,
        config=port_losses.ImpalaLossConfig(reduction=spec["reduction"], health_diagnostics=health),
    )
    grads = torch.autograd.grad(out.total, leaves, allow_unused=True)
    np.testing.assert_allclose(float(out.total.detach()), float(want_total), **TOL)
    assert set(out.logs) == set(want_logs)
    assert {"impact_ratio", "impact_clip_frac", "mean_vtrace_target", "mean_advantage"} <= set(out.logs)
    assert sum(k.startswith("health_") for k in out.logs) == (15 if health else 0)
    for key, value in want_logs.items():
        np.testing.assert_allclose(float(out.logs[key].detach()), float(value), **TOL, err_msg=key)
    for got, want in zip(grads[:2], want_grads[:2]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # No gradient reaches the target, in either.
    assert grads[2] is None or not torch.any(grads[2])
    np.testing.assert_array_equal(np.asarray(want_grads[2]), 0.0)
    if spec.get("same"):
        assert float(out.logs["impact_ratio"]) == 1.0
        assert float(out.logs["impact_clip_frac"]) == 0.0
    else:
        assert 0.0 < float(out.logs["impact_clip_frac"]) < 1.0


def test_impact_loss_grads_equal_impala_loss_at_learner_equals_target():
    """JAX's test_gradients_match_impala_at_learner_equals_target on the
    port: at pi_theta == pi_target the surrogate's grads are IMPALA's."""
    x = _impact_inputs(8, mask=False, same=True)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    logits, values = t["learner_logits"].requires_grad_(), t["values"].requires_grad_()
    common = {k: v for k, v in t.items() if k not in ("learner_logits", "target_logits")}
    impact = port_losses.impact_loss(**common, learner_logits=logits,
                                     target_logits=t["target_logits"]).total
    impala = port_losses.impala_loss(**common, target_logits=logits).total
    for a, b in zip(torch.autograd.grad(impact, [logits, values]),
                    torch.autograd.grad(impala, [logits, values])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


# ---- the replay step against JAX's _train_step_replay_impl ------------------

class _Agent(JaxAgent):
    """JAX's agent, its params initialised under one jit."""

    def init_params(self, rng, example_obs):
        return jax.jit(lambda r, x: JaxAgent.init_params(self, r, x))(rng, example_obs)


class _SteppedAgent(_Agent):
    """JAX's agent with the LSTM unroll applied in step mode, one call a time
    step (tests/test_torch_port_bf16.py: JAX's scanned LSTM unroll raises
    under bf16 in the scan's transpose)."""

    def unroll(self, params, obs, first, state):
        outs = []
        for t in range(obs.shape[0]):
            out, state = self.net.apply(params, obs[t], first[t], state, unroll=False)
            outs.append(out)
        return jax.tree.map(lambda *x: jnp.stack(x), *outs), state


@dataclasses.dataclass(frozen=True)
class Net:
    jax_net: object  # torso dtype -> flax ImpalaNet
    port_net: object  # torso dtype -> port ImpalaNet
    obs_shape: tuple
    pixels: bool
    lstm: bool = False


NETS = {
    "mlp": Net(
        jax_net=lambda dt: JaxNet(num_actions=A, torso=JaxMLP(hidden_sizes=(16, 16), dtype=jnp.dtype(dt))),
        port_net=lambda dt: ImpalaNet(A, MLPTorso(4, (16, 16), dtype=dt)),
        obs_shape=(4,), pixels=False,
    ),
    "nature_cnn": Net(
        jax_net=lambda dt: JaxNet(num_actions=A, torso=JaxAtari(dtype=jnp.dtype(dt))),
        port_net=lambda dt: ImpalaNet(A, AtariShallowTorso(4, dtype=dt)),
        obs_shape=(84, 84, 4), pixels=True,
    ),
    "deep_lstm": Net(
        jax_net=lambda dt: JaxNet(
            num_actions=A, torso=JaxDeep(channel_sections=(4, 8, 8), hidden_size=32, dtype=jnp.dtype(dt)),
            use_lstm=True, lstm_size=LSTM,
        ),
        port_net=lambda dt: ImpalaNet(
            A, AtariDeepTorso(4, (16, 16), (4, 8, 8), 2, 32, dtype=dt), core="lstm", lstm_size=LSTM,
        ),
        obs_shape=(16, 16, 4), pixels=True, lstm=True,
    ),
}


def _batch(net, T, B, seed):
    rng = np.random.default_rng(seed)
    if net.pixels:
        obs = rng.integers(0, 256, size=(T + 1, B, *net.obs_shape), dtype=np.uint8)
    else:
        obs = rng.normal(size=(T + 1, B, *net.obs_shape)).astype(np.float32)
    batch = dict(
        obs=obs,
        first=rng.uniform(size=(T + 1, B)) < 0.25,
        actions=rng.integers(0, A, size=(T, B)).astype(np.int32),
        behaviour_logits=rng.normal(size=(T, B, A)).astype(np.float32),
        rewards=rng.normal(size=(T, B)).astype(np.float32),
        cont=(rng.uniform(size=(T, B)) > 0.1).astype(np.float32),
    )
    state = tuple(rng.normal(size=(B, LSTM)).astype(np.float32) * 0.5 for _ in range(2)) \
        if net.lstm else ()
    return batch, state


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def _replay_step(name, dtype="float32", seed=3):
    """One replay step of JAX's learner (`_train_step_replay_impl`, jitted)
    and of the port's (`train_step`) from the same flax params, a target
    moved off them by seeded noise, and one batch. Returns the port's and
    JAX's params before and after, and both logs."""
    net = NETS[name]
    T, B = (2, 4) if name == "nature_cnn" else (3, 4)
    example = np.zeros(net.obs_shape, np.uint8 if net.pixels else np.float32)
    replay = dict(max_reuse=2, target_update_interval=4, target_clip_epsilon=0.2)
    agent_cls = _SteppedAgent if net.lstm and dtype != "float32" else _Agent
    jlearner = JaxLearner(
        agent=agent_cls(net.jax_net(dtype)),
        optimizer=optax.rmsprop(LR, decay=DECAY, eps=EPS),
        config=JaxLearnerConfig(
            batch_size=B, unroll_length=T, traj_ring=True, train_dtype=dtype,
            loss=jax_losses.ImpalaLossConfig(vtrace_implementation="scan", health_diagnostics=True),
            replay=JaxReplayConfig(**replay),
        ),
        example_obs=example,
        rng=jax.random.key(0),
        telemetry=JaxRegistry(),
    )
    rng = np.random.default_rng(seed)
    params = jlearner._params
    target = jax.tree.map(
        lambda p: p + jnp.asarray(rng.normal(size=p.shape).astype(np.float32)) * TARGET_NOISE * jnp.std(p),
        params,
    )
    batch, state = _batch(net, T, B, seed)
    jstate = tuple(map(jnp.asarray, state)) if state else jlearner._agent.initial_state(B)
    step = jax.jit(jlearner._train_step_replay_impl,
                   compiler_options=EXACT if dtype != "float32" else None)
    new_params, _, _, jlogs = step(
        params, jlearner._opt_state, jlearner._popart_state, target,
        *(jnp.asarray(batch[k]) for k in ("obs", "first", "actions", "behaviour_logits",
                                          "rewards", "cont")),
        jnp.zeros((B,), jnp.int32), jstate,
    )

    port = net.port_net(dtype)
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    learner = Learner(
        agent=Agent(port),
        optimizer=RMSProp(LR, decay=DECAY, eps=EPS),
        config=LearnerConfig(
            batch_size=B, unroll_length=T, traj_ring=True, train_dtype=dtype,
            loss=port_losses.ImpalaLossConfig(health_diagnostics=True),
            replay=ReplayConfig(**replay),
        ),
        device=torch.device("cpu"),
        example_obs=example,
        telemetry=Registry(),
    )
    learner._target_store.update(params_from_jax(jax.tree.map(np.asarray, target)), version=0, step=0)
    before = {k: v.detach().clone() for k, v in learner.params.items()}
    arrays = (
        torch.from_numpy(batch["obs"]), torch.from_numpy(batch["first"]),
        torch.from_numpy(batch["actions"]).long(), torch.from_numpy(batch["behaviour_logits"]),
        torch.from_numpy(batch["rewards"]), torch.from_numpy(batch["cont"]),
        tuple(map(torch.from_numpy, state)) if state else learner._agent.initial_state(B),
    )
    logs = learner.train_step(arrays)
    after = {k: v.detach().clone() for k, v in learner.params.items()}
    want = params_from_jax(jax.tree.map(np.asarray, new_params))
    return before, after, want, {k: float(v) for k, v in logs.items()}, {
        k: float(v) for k, v in jlogs.items()}


@pytest.mark.parametrize("name", list(NETS))
def test_replay_step_matches_jax(name):
    before, after, want, logs, jlogs = _replay_step(name)
    assert set(logs) == set(jlogs)
    assert {"impact_ratio", "impact_clip_frac"} <= set(logs)
    for key, value in jlogs.items():
        np.testing.assert_allclose(logs[key], value, **LOG_TOL, err_msg=key)
    # The target is off the learner: the ratio is not 1 and the clip acts.
    assert logs["impact_clip_frac"] > 0.0 and logs["impact_ratio"] != 1.0
    for k, p in after.items():
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), **PARAM_TOL, err_msg=k)
    assert any(not torch.equal(p, before[k]) for k, p in after.items())


def test_bf16_replay_step_matches_jax():
    """The narrow deep torso + LSTM, train_dtype="bfloat16": the target's
    unroll and the live one lowered to bf16 as JAX's are."""
    before, after, want, logs, jlogs = _replay_step("deep_lstm", "bfloat16")
    assert set(logs) == set(jlogs)
    got = torch.cat([(after[k] - before[k]).flatten() for k in after])
    step = torch.cat([(want[k] - before[k]).flatten() for k in after])
    assert _rel(got, step) <= BF16_STEP_RTOL
    for key in ("total_loss", "pg_loss", "baseline_loss", "entropy_loss", "impact_ratio",
                "impact_clip_frac", "grad_norm_unclipped"):
        np.testing.assert_allclose(logs[key], jlogs[key], rtol=BF16_LOG_TOL, atol=BF16_LOG_TOL,
                                   err_msg=key)
    assert all(p.dtype == torch.float32 for p in after.values())


# ---- the learner -----------------------------------------------------------

def _pipeline(replay, *, n=3, T=3, E=2, B=4, lstm=False, registry=None, extra_steps=False):
    """The port's learner fed by one thread actor through the ring, as JAX's
    tests/test_replay.py:_run_pipeline: per-step total losses, final
    params, the logs of each step and the learner."""
    cfg = dataclasses.replace(configs.CARTPOLE, use_lstm=lstm, lstm_size=8,
                              unroll_length=T, batch_size=B, traj_ring=True)
    agent = configs.make_agent(cfg, seed=0)
    learner = Learner(
        agent=agent,
        optimizer=RMSProp(1e-2),
        config=dataclasses.replace(configs.make_learner_config(cfg), replay=replay),
        device=torch.device("cpu"),
        example_obs=np.zeros((4,), np.float32),
        telemetry=registry or Registry(),
    )
    actor = VectorActor(
        actor_id=0, envs=[ScriptedEnv(episode_len=4) for _ in range(E)], agent=agent,
        param_store=learner.param_store, enqueue=learner.enqueue, unroll_length=T,
        device=torch.device("cpu"), seed=3, traj_ring=learner.traj_ring,
    )
    learner.start()
    logs = []
    try:
        if extra_steps:
            for _ in range(n * B // E):
                actor.unroll_and_push()
            while True:
                try:
                    logs.append(learner.step_once(timeout=2.0))
                except queue.Empty:
                    break
        else:
            for _ in range(n):
                for _ in range(B // E):
                    actor.unroll_and_push()
                logs.append(learner.step_once(timeout=60))
    finally:
        learner.stop()
        learner.join()
    params = {k: v.detach().clone() for k, v in learner.params.items()}
    return [float(x["total_loss"]) for x in logs], params, logs, learner


@pytest.mark.parametrize("lstm", [False, True], ids=["mlp", "lstm"])
def test_disabled_replay_config_is_bit_for_bit_no_replay(lstm):
    """JAX's test_disabled_replay_config_is_bit_identical on the port: the
    same losses and params, and the learner keeps no target and takes
    impala_loss (no impact logs)."""
    base_losses, base_params, base_logs, base = _pipeline(None, lstm=lstm)
    off_losses, off_params, off_logs, off = _pipeline(ReplayConfig(), lstm=lstm)
    assert base_losses == off_losses
    for k in base_params:
        assert torch.equal(base_params[k], off_params[k]), k
    assert off._replay is None and off._target_store is None
    assert off.traj_ring.max_reuse == 1
    assert off.traj_ring.num_slots == base.traj_ring.num_slots
    assert "impact_ratio" not in off_logs[-1]


def test_enabled_replay_multiplies_updates_per_env_frame():
    """JAX's scenario: 3 fresh batches at max_reuse=2 give 6 steps, 3 of
    them replays; the target refreshed on its cadence (at steps 0, 2, 4,
    6)."""
    reg = Registry()
    _, _, logs, learner = _pipeline(
        ReplayConfig(max_reuse=2, target_update_interval=2), registry=reg, extra_steps=True
    )
    assert len(logs) == 6
    assert all("impact_ratio" in x for x in logs)
    snap = reg.snapshot()
    assert snap["telemetry/replay/reuse_delivered"] == 3
    assert snap["telemetry/replay/target_updates"] == 4
    assert learner.traj_ring.num_slots == learner._batch_q.maxsize + 4
    assert learner.num_frames == 6 * 3 * 4


def test_replay_lineage_reaches_the_health_monitor():
    """The delivered slot's reuse_count and staleness go with the batch to
    BatchLineage, in the order the ring delivered them (a fresh batch, then
    its replay)."""
    seen, delivered = [], []

    class Monitor:
        def bind_context(self, **kw):
            pass

        def observe(self, logs, lineage):
            seen.append((lineage.reuse_count, lineage.staleness))

    cfg = dataclasses.replace(configs.CARTPOLE, unroll_length=3, batch_size=4, traj_ring=True)
    agent = configs.make_agent(cfg, seed=0)
    learner = Learner(
        agent=agent, optimizer=RMSProp(1e-2),
        config=dataclasses.replace(configs.make_learner_config(cfg),
                                   replay=ReplayConfig(max_reuse=2, target_update_interval=1)),
        device=torch.device("cpu"), example_obs=np.zeros((4,), np.float32), telemetry=Registry(),
    )
    learner.attach_health(Monitor())
    ring = learner.traj_ring
    pop_ready = ring.pop_ready

    def recording_pop_ready(timeout=None):
        view = pop_ready(timeout)
        if view is not None:
            delivered.append((view.reuse_count, view.staleness))
        return view

    ring.pop_ready = recording_pop_ready
    actor = VectorActor(actor_id=0, envs=[ScriptedEnv(episode_len=4) for _ in range(4)],
                        agent=agent, param_store=learner.param_store, enqueue=learner.enqueue,
                        unroll_length=3, device=torch.device("cpu"), seed=3,
                        traj_ring=ring)
    actor.unroll_and_push()
    learner.start()
    try:
        for _ in range(2):
            learner.step_once(timeout=60)
    finally:
        learner.stop()
        learner.join()
    assert [r for r, _ in seen] == [1, 2]
    assert seen == delivered[:2]


REFUSALS = {
    "no_traj_ring": dict(traj_ring=False),
    "grad_accum": dict(grad_accum=2),
    "steps_per_dispatch": dict(steps_per_dispatch=2),
    "donate_batch": dict(donate_batch=True),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_replay_refusals_match_jax(case):
    fields = {"batch_size": 4, "unroll_length": 3, "traj_ring": True, **REFUSALS[case]}
    example = np.zeros((4,), np.float32)

    def jax_learner():
        JaxLearner(
            agent=_Agent(JaxNet(num_actions=2, torso=JaxMLP(hidden_sizes=(8,)))),
            optimizer=optax.sgd(1e-2),
            config=JaxLearnerConfig(replay=JaxReplayConfig(max_reuse=2, target_update_interval=2),
                                    **fields),
            example_obs=example, rng=jax.random.key(0), telemetry=JaxRegistry(),
        )

    def port_learner():
        Learner(
            agent=Agent(ImpalaNet(2, MLPTorso(4, (8,)))), optimizer=RMSProp(1e-2),
            config=LearnerConfig(replay=ReplayConfig(max_reuse=2, target_update_interval=2),
                                 **fields),
            device=torch.device("cpu"), example_obs=example, telemetry=Registry(),
        )

    got, want = _outcome(port_learner), _outcome(jax_learner)
    assert got[0] == want[0] == "ValueError"
    # JAX's message, up to its pointer to the JAX package's docs or to XLA.
    assert want[1].startswith(got[1]) and len(got[1]) > 60, (got, want)


def test_set_state_pins_the_target_again():
    cfg = dataclasses.replace(configs.CARTPOLE, unroll_length=3, batch_size=4, traj_ring=True)
    reg = Registry()
    learner = Learner(
        agent=configs.make_agent(cfg, seed=0), optimizer=RMSProp(1e-2),
        config=dataclasses.replace(configs.make_learner_config(cfg),
                                   replay=ReplayConfig(max_reuse=2, target_update_interval=100)),
        device=torch.device("cpu"), example_obs=np.zeros((4,), np.float32), telemetry=reg,
    )
    state = learner.get_state()
    state["params"] = {k: v + 1.0 for k, v in state["params"].items()}
    state["num_frames"], state["num_steps"] = 480, 40
    learner.set_state(state)
    version, target = learner._target_store.current()
    assert version == 480
    for k, v in state["params"].items():
        assert torch.equal(target[k], v), k
    assert reg.snapshot()["telemetry/replay/target_updates"] == 2
    assert learner._target_store.lag() == 0


def test_replay_cli_returns_zero(capsys):
    rc = run.main(shlex.split(run.REPLAY_CPU_EXAMPLE))
    assert rc == 0
    assert "done: steps=6" in capsys.readouterr().out
    args = run.parse_args(shlex.split(run.REPLAY_CPU_EXAMPLE))
    cfg = run.build_config(args)
    assert (cfg.max_reuse, cfg.target_update_interval, cfg.traj_ring) == (2, 2, True)
    replay = configs.make_learner_config(cfg).replay
    assert replay == ReplayConfig(max_reuse=2, target_update_interval=2)
