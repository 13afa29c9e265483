"""The port's training-health plane held against the JAX package's, on
the CPU.

- `health_diagnostics_logs` on the same numpy inputs (A = 6 and 15,
  masks with zeros, and an on-policy batch whose log-ratios are 0): each
  key within rtol 1e-5, atol 1e-6, the histogram bins equal.
- `impala_loss` with health on, unfused against JAX's unfused loss and
  fused against JAX's fused loss (its kernel and its V-trace in Pallas
  interpret mode), at the same tolerance; in the port health on leaves
  the total and the grads bit for bit as health off.
- The learner step with health on, from JAX's state (`state_from_jax`),
  against JAX's learner: the MLP, Nature-CNN and deep-torso + LSTM nets
  (JAX's LSTM net in step mode, as tests/test_torch_port_bf16.py runs
  it), also at grad_accum = 2 and steps_per_dispatch = 2: the same
  `health_*` key names, the values within rtol 1e-4, atol 1e-5 (the
  learner tolerance); and one bf16 Nature-CNN step (JAX compiled without
  XLA's excess precision) within BF16_TOL, which the port's f32 learner
  misses.
- The host half: the same log sequences into JAX's and the port's
  `HealthMonitor`, each with a fresh registry and flight recorder; the
  same gauges, fired alerts, first breaches and bundles (manifests equal
  but for their time stamps), and JAX's `tools/postmortem.py` renders the
  port's bundle.
- The CLI: `run.py --health` on the CPU publishes every health gauge of
  its net, finite, and a `crash_learner` plan writes one crash bundle.
"""

import dataclasses
import functools
import json
import math
import os
import shlex
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from tools import postmortem as pm_tool
from torched_impala_tpu.models import Agent as JaxAgent
from torched_impala_tpu.models import AtariDeepTorso as JaxDeep
from torched_impala_tpu.models import AtariShallowTorso as JaxAtari
from torched_impala_tpu.models import ImpalaNet as JaxNet
from torched_impala_tpu.models import MLPTorso as JaxMLP
from torched_impala_tpu.ops import losses as jax_losses
from torched_impala_tpu.ops import vtrace_pallas as jax_vtrace_pallas
from torched_impala_tpu.runtime import Learner as JaxLearner
from torched_impala_tpu.runtime import LearnerConfig as JaxLearnerConfig
from torched_impala_tpu.runtime import Trajectory as JaxTrajectory
from torched_impala_tpu.runtime.learner import BatchLineage as JaxBatchLineage
from torched_impala_tpu.telemetry import FlightRecorder as JaxRecorder
from torched_impala_tpu.telemetry import Registry as JaxRegistry
from torched_impala_tpu.telemetry import health as jax_health
from torched_impala_tpu_torch import run
from torched_impala_tpu_torch.models.agent import Agent
from torched_impala_tpu_torch.models.convert import params_from_jax, state_from_jax
from torched_impala_tpu_torch.models.nets import ImpalaNet
from torched_impala_tpu_torch.models.torsos import AtariDeepTorso, AtariShallowTorso, MLPTorso
from torched_impala_tpu_torch.ops import losses as port_losses
from torched_impala_tpu_torch.optim import RMSProp
from torched_impala_tpu_torch.resilience import ChaosError
from torched_impala_tpu_torch.runtime.learner import BatchLineage, Learner, LearnerConfig
from torched_impala_tpu_torch.runtime.types import Trajectory
from torched_impala_tpu_torch.telemetry import FlightRecorder, Registry, get_registry
from torched_impala_tpu_torch.telemetry import health as port_health

TOL = dict(rtol=1e-5, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
A, LSTM = 4, 16
LR, DECAY, EPS = 6e-4, 0.99, 1e-7
# XLA's CPU compile of JAX's bf16 step without excess precision, as in
# tests/test_torch_port_bf16.py: with it XLA drops the bf16 round trips.
EXACT = {"xla_allow_excess_precision": False}
# The bf16 Nature-CNN step's health logs against JAX's bf16 step, each
# key by |port - JAX| / (1 + |JAX|). Both round the same operations to
# bf16 but may sum in another order, so a value can land on the other
# bf16 neighbour; the group norms and ratios sum over many such values.
# Measured: <= 4.5e-6 (the torso's grad norm; the loss's keys <= 1.1e-7).
# The port's f32 learner on the same bf16 torso through the same
# comparison: 2.6e-3 (the policy head's grad norm), 1.9e-3 (the torso's),
# 1.3e-3 (ev_value). Held to 2^-10 = 9.8e-4, between the two readings.
BF16_TOL = 2.0**-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _health(logs) -> dict:
    return {k: float(v) for k, v in logs.items() if k.startswith("health_")}


# ---- health_diagnostics_logs ------------------------------------------

DIAG_CASES = {
    "A6": dict(A=6, clips={}),
    "A15_clips": dict(A=15, clips=dict(clip_rho_threshold=0.5, clip_c_threshold=2.0)),
    "on_policy": dict(A=6, clips={}, on_policy=True),
}


def _diag_inputs(A, seed, on_policy=False):
    rng = np.random.default_rng(seed)
    T, B = 7, 5
    target = (rng.normal(size=(T, B, A)) * 2).astype(np.float32)
    return dict(
        learner_logits=target,
        behaviour_logits=target.copy() if on_policy
        else (rng.normal(size=(T, B, A)) * 2).astype(np.float32),
        log_rhos=np.zeros((T, B), np.float32) if on_policy
        else (rng.normal(size=(T, B)) * 1.5).astype(np.float32),
        values=rng.normal(size=(T, B)).astype(np.float32),
        vs=rng.normal(size=(T, B)).astype(np.float32),
        mask=(rng.uniform(size=(T, B)) > 0.25).astype(np.float32),
    )


@pytest.mark.parametrize("case", list(DIAG_CASES))
def test_health_diagnostics_logs_match_jax(case):
    spec = DIAG_CASES[case]
    x = _diag_inputs(spec["A"], seed=len(case), on_policy=spec.get("on_policy", False))
    want = jax_losses.health_diagnostics_logs(
        **{k: jnp.asarray(v) for k, v in x.items()},
        config=jax_losses.ImpalaLossConfig(**spec["clips"]),
    )
    got = port_losses.health_diagnostics_logs(
        **{k: torch.from_numpy(v) for k, v in x.items()},
        config=port_losses.ImpalaLossConfig(**spec["clips"]),
    )
    assert list(got) == list(want)
    for key in want:
        if "_bin" in key:
            assert float(got[key]) == float(want[key]), key
        else:
            np.testing.assert_allclose(float(got[key]), float(want[key]), **TOL, err_msg=key)
    if spec.get("on_policy"):
        assert float(got["health_clip_logrho_bin4"]) == 1.0
        assert float(got["health_clip_rho_frac"]) == 0.0
        assert float(got["health_kl_behaviour_learner"]) == 0.0


# ---- impala_loss with health on ----------------------------------------


def _loss_inputs(seed, mask=True):
    rng = np.random.default_rng(seed)
    T, B, A6 = 5, 4, 6
    x = dict(
        target_logits=rng.normal(size=(T, B, A6)).astype(np.float32),
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


def _port_loss(x, **cfg):
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    leaves = [t["target_logits"].requires_grad_(), t["values"].requires_grad_()]
    out = port_losses.impala_loss(**t, config=port_losses.ImpalaLossConfig(**cfg))
    grads = torch.autograd.grad(out.total, leaves)
    return out.total.detach(), {k: v.detach() for k, v in out.logs.items()}, grads


LOSS_CASES = {"unfused": dict(fused=False, mask=True), "fused": dict(fused=True, mask=True),
              "fused_no_mask": dict(fused=True, mask=False)}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_impala_loss_health_logs_match_jax(case, monkeypatch):
    """Unfused: JAX's separate loss (scan V-trace). Fused: JAX's fused loss
    with its Pallas kernel and its diagnostic V-trace pass in interpret
    mode. Every log, the health ones included, at TOL."""
    fused = LOSS_CASES[case]["fused"]
    x = _loss_inputs(3, mask=LOSS_CASES[case]["mask"])
    if fused:
        monkeypatch.setattr(
            jax_vtrace_pallas, "fused_vtrace_loss",
            functools.partial(jax_vtrace_pallas.fused_vtrace_loss, implementation="kernel"),
        )
    jcfg = jax_losses.ImpalaLossConfig(
        health_diagnostics=True, fused_epilogue=fused,
        vtrace_implementation="pallas" if fused else "scan",
    )
    want = jax_losses.impala_loss(**{k: jnp.asarray(v) for k, v in x.items()}, config=jcfg)
    _, got, _ = _port_loss(x, health_diagnostics=True, fused_epilogue=fused)
    assert set(got) == set(want.logs)
    assert len(_health(got)) == 15
    for key in want.logs:
        np.testing.assert_allclose(float(got[key]), float(want.logs[key]), **TOL, err_msg=key)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_health_on_leaves_total_and_grads_bit_for_bit(fused):
    x = _loss_inputs(4)
    on_total, on_logs, on_grads = _port_loss(x, health_diagnostics=True, fused_epilogue=fused)
    off_total, off_logs, off_grads = _port_loss(x, fused_epilogue=fused)
    assert torch.equal(on_total, off_total)
    for a, b in zip(on_grads, off_grads):
        assert torch.equal(a, b)
    assert set(on_logs) - set(off_logs) == set(_health(on_logs))
    for key, value in off_logs.items():
        assert torch.equal(on_logs[key], value), key


def test_fused_bf16_still_raises_with_health():
    t = {k: torch.from_numpy(v) for k, v in _loss_inputs(5).items()}
    cfg = port_losses.ImpalaLossConfig(
        fused_epilogue=True, health_diagnostics=True, train_dtype="bfloat16"
    )
    with pytest.raises(NotImplementedError, match="The learner step's launches"):
        port_losses.impala_loss(**t, config=cfg)


# ---- the learner step ----------------------------------------------------


class _Agent(JaxAgent):
    """JAX's agent, its params initialised under one jit (flax's eager
    init compiles each initializer apart)."""

    def init_params(self, rng, example_obs):
        return jax.jit(lambda r, x: JaxAgent.init_params(self, r, x))(rng, example_obs)


class _SteppedAgent(_Agent):
    """JAX's agent with the LSTM unroll applied in step mode, one call a
    time step (tests/test_torch_port_bf16.py)."""

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


def _unrolls(net, T, n, seed):
    out = []
    for i in range(n):
        rng = np.random.default_rng(1000 * seed + i)
        if net.pixels:
            obs = rng.integers(0, 256, size=(T + 1, *net.obs_shape), dtype=np.uint8)
        else:
            obs = rng.normal(size=(T + 1, *net.obs_shape)).astype(np.float32)
        out.append(dict(
            obs=obs,
            first=rng.uniform(size=(T + 1,)) < 0.25,
            actions=rng.integers(0, A, size=(T,)).astype(np.int32),
            behaviour_logits=rng.normal(size=(T, A)).astype(np.float32),
            rewards=rng.normal(size=(T,)).astype(np.float32),
            cont=(rng.uniform(size=(T,)) > 0.1).astype(np.float32),
            agent_state=tuple(
                rng.normal(size=(1, LSTM)).astype(np.float32) * 0.5 for _ in range(2)
            ) if net.lstm else (),
        ))
    return out


def _learner_health(name, fields, jax_dtype="float32", port_dtypes=("float32",), dispatches=2):
    """`dispatches` dispatches of JAX's learner and of one port learner a
    dtype of `port_dtypes`, health on, each port dispatch from JAX's
    state: a dispatch, ({port dtype: its health logs}, JAX's)."""
    net = NETS[name]
    T, B = (3, 4) if name == "mlp" else (2, 2)
    K = fields.get("steps_per_dispatch", 1)
    example = np.zeros(net.obs_shape, np.uint8 if net.pixels else np.float32)
    jlearner = JaxLearner(
        agent=(_SteppedAgent if net.lstm else _Agent)(net.jax_net(jax_dtype)),
        optimizer=optax.rmsprop(LR, decay=DECAY, eps=EPS),
        config=JaxLearnerConfig(
            batch_size=B, unroll_length=T, train_dtype=jax_dtype,
            loss=jax_losses.ImpalaLossConfig(vtrace_implementation="scan", health_diagnostics=True),
            queue_capacity=dispatches * K * B, **fields,
        ),
        example_obs=example,
        rng=jax.random.key(0),
    )
    if jax_dtype != "float32":
        impl = jlearner._train_multi_impl if K > 1 else jlearner._train_step_impl
        jlearner._train_step = jax.jit(impl, compiler_options=EXACT)
    learners = {}
    for dtype in port_dtypes:
        # The torso's dtype follows the JAX net's, as make_agent builds it.
        port = net.port_net(jax_dtype)
        port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jlearner.params)))
        learners[dtype] = Learner(
            agent=Agent(port),
            optimizer=RMSProp(LR, decay=DECAY, eps=EPS),
            config=LearnerConfig(
                batch_size=B, unroll_length=T, train_dtype=dtype,
                loss=port_losses.ImpalaLossConfig(health_diagnostics=True),
                queue_capacity=dispatches * K * B, **fields,
            ),
            device=torch.device("cpu"),
        )
        learners[dtype].start()
    for u in _unrolls(net, T, dispatches * K * B, seed=5):
        jlearner.enqueue(JaxTrajectory(**u))
        for learner in learners.values():
            learner.enqueue(Trajectory(**u))
    jlearner.start()
    readings = []
    try:
        for _ in range(dispatches):
            state = state_from_jax(jax.tree.map(np.asarray, jlearner.get_state()))
            jlogs = jlearner.step_once(timeout=300)
            got = {}
            for dtype, learner in learners.items():
                learner.set_state(state)
                got[dtype] = _health(learner.step_once(timeout=60))
            readings.append((got, _health(jlogs)))
    finally:
        jlearner.stop()
        for learner in learners.values():
            learner.stop()
            learner.join()
    return readings


STEP_CASES = {
    "mlp": ("mlp", {}),
    "nature_cnn": ("nature_cnn", {}),
    "deep_lstm": ("deep_lstm", {}),
    "mlp_accum2": ("mlp", dict(grad_accum=2)),
    "mlp_dispatch2": ("mlp", dict(steps_per_dispatch=2)),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_learner_step_health_logs_match_jax(case):
    name, fields = STEP_CASES[case]
    readings = [(got["float32"], want)
                for got, want in _learner_health(name, fields, dispatches=1 if fields else 2)]
    groups = {"mlp": ["torso", "policy_head", "value_head"],
              "nature_cnn": ["torso", "policy_head", "value_head"],
              "deep_lstm": ["torso", "lstm", "policy_head", "value_head"]}[name]
    for got, want in readings:
        assert sorted(got) == sorted(want)
        assert {f"health_grad_norm_{g}" for g in groups} | {
            f"health_update_ratio_{g}" for g in groups
        } <= set(got)
        assert len(got) == 15 + 2 * len(groups)
        for key, value in want.items():
            np.testing.assert_allclose(got[key], value, **STEP_TOL, err_msg=key)


def test_bf16_step_health_logs_match_jax_bf16_step():
    """One bf16 Nature-CNN step against JAX's bf16 step (BF16_TOL); the
    port's f32 learner (on the same bf16 torso), through the same
    comparison, misses it."""
    ((got, want),) = _learner_health(
        "nature_cnn", {}, "bfloat16", port_dtypes=("bfloat16", "float32"), dispatches=1
    )
    dist = {
        dtype: {k: abs(logs[k] - want[k]) / (1 + abs(want[k])) for k in want}
        for dtype, logs in got.items()
    }
    assert all(sorted(logs) == sorted(want) for logs in got.values())
    assert max(dist["bfloat16"].values()) <= BF16_TOL, dist["bfloat16"]
    assert max(dist["float32"].values()) > BF16_TOL, dist["float32"]


# ---- the host half ---------------------------------------------------------


def _monitors(tmp_path, fast_window_s=5.0, postmortem=True):
    """JAX's and the port's HealthMonitor, each with a fresh registry,
    flight recorder and bundle directory."""
    out = {}
    for side, reg_cls, rec_cls, lib in (
        ("jax", JaxRegistry, JaxRecorder, jax_health),
        ("port", Registry, FlightRecorder, port_health),
    ):
        reg, rec = reg_cls(), rec_cls(capacity=64)
        pm = lib.PostmortemWriter(str(tmp_path / side), recorder=rec) if postmortem else None
        out[side] = types.SimpleNamespace(
            mon=lib.HealthMonitor(
                specs=lib.health_slo_specs(fast_window_s=fast_window_s, slow_window_s=10 * fast_window_s),
                registry=reg, recorder=rec, postmortem=pm,
            ),
            reg=reg,
            rec=rec,
        )
    return out["jax"], out["port"]


def _feed(pair, logs_seq, lineages=None):
    """The same (logs, now) sequence into both monitors; the names fired
    at each observe, which must agree."""
    fired = []
    for i, (logs, now) in enumerate(logs_seq):
        lineage = None if lineages is None else lineages[i]
        j = pair[0].mon.observe(logs, lineage=None if lineage is None else lineage[0], now=now)
        p = pair[1].mon.observe(logs, lineage=None if lineage is None else lineage[1], now=now)
        assert p == j, i
        fired.append(p)
    return fired


def _same_gauges(j, p):
    js, ps = j.reg.snapshot(), p.reg.snapshot()
    assert js.keys() == ps.keys()
    for key, value in js.items():
        if isinstance(value, float) and math.isnan(value):
            assert math.isnan(ps[key]), key
        else:
            assert ps[key] == value, key
    return ps


STAMPS = ("wall_time", "wall_time_iso", "monotonic")


def _bundle(path):
    with open(os.path.join(path, port_health.BUNDLE_MANIFEST)) as f:
        manifest = json.load(f)
    with open(os.path.join(path, port_health.BUNDLE_TRACE)) as f:
        trace = json.load(f)
    with open(os.path.join(path, port_health.BUNDLE_SNAPSHOTS)) as f:
        rows = [json.loads(line) for line in f]
    return manifest, trace, rows


def _same_bundles(j, p):
    assert len(j.mon.bundles) == len(p.mon.bundles)
    for jpath, ppath in zip(j.mon.bundles, p.mon.bundles):
        assert os.listdir(ppath) and sorted(os.listdir(ppath)) == sorted(os.listdir(jpath))
        jm, jt, jr = _bundle(jpath)
        pm, pt, pr = _bundle(ppath)
        assert {k: v for k, v in pm.items() if k not in STAMPS} == {
            k: v for k, v in jm.items() if k not in STAMPS
        }
        assert pr == jr
        # The flight tails hold the same events; their clocks differ.
        strip = [{k: v for k, v in e.items() if k not in ("ts", "tid")} for e in jt["traceEvents"]]
        assert strip == [
            {k: v for k, v in e.items() if k not in ("ts", "tid")} for e in pt["traceEvents"]
        ]


def test_monitor_grad_spike_ratio_matches_jax(tmp_path):
    pair = _monitors(tmp_path)
    seq = [({"grad_norm_unclipped": 1.0}, 100.0 + i) for i in range(5)]
    _feed(pair, seq + [({"grad_norm_unclipped": 64.0}, 105.0)])
    snap = _same_gauges(*pair)
    assert snap["telemetry/health/grad_spike_ratio"] == pytest.approx(64.0)


def test_monitor_staleness_clip_correlation_matches_jax(tmp_path):
    pair = _monitors(tmp_path)
    seq = [({"health_clip_rho_frac": 0.01 * i}, 100.0 + i) for i in range(10)]
    lineages = [(types.SimpleNamespace(staleness=i),) * 2 for i in range(10)]
    _feed(pair, seq, lineages)
    snap = _same_gauges(*pair)
    assert snap["telemetry/health/staleness_clip_corr"] == pytest.approx(1.0)
    # A fresh batch's lineage has staleness 0: the correlation is 0.0 once
    # 8 samples are in, as a run outside replay publishes it.
    pair = _monitors(tmp_path / "fresh")
    fresh = [(JaxBatchLineage(batch=i), BatchLineage(batch=i)) for i in range(8)]
    _feed(pair, seq[:8], fresh)
    assert _same_gauges(*pair)["telemetry/health/staleness_clip_corr"] == 0.0


def test_entropy_collapse_fires_and_bundles_as_jax(tmp_path):
    """The sustained entropy breach fires at the coverage gate (sample
    10) on both, with the same first breach, and each writes one bundle
    with the same contents; JAX's tools/postmortem.py renders the
    port's."""
    pair = _monitors(tmp_path)
    fields = dict(batch=7, lineage=("a0u12",), versions=(41,), reuse_count=2, staleness=12,
                  ring_slot=5)
    lineages = [(JaxBatchLineage(**fields), BatchLineage(**fields))] * 14
    seq = [({"health_entropy_mean": 0.01, "num_steps": 100 + i}, 1000.0 + 0.5 * i)
           for i in range(14)]
    fired = _feed(pair, seq, lineages)
    assert [i for i, f in enumerate(fired) if f] == [10]
    assert fired[10] == ["entropy_collapse"]
    j, p = pair
    snap = _same_gauges(j, p)
    assert snap["telemetry/alerts/firing_entropy_collapse"] == 1.0
    assert p.mon.first_breach == j.mon.first_breach
    assert p.mon.first_breach["entropy_collapse"]["t"] == 1000.0
    assert len(p.mon.bundles) == 1
    _same_bundles(j, p)
    bundle = pm_tool.load_bundle(p.mon.bundles[0])
    assert pm_tool.first_breach_signal(bundle["manifest"]) == "entropy_collapse"
    report = pm_tool.render_report(bundle)
    assert "FIRST BREACH: entropy_collapse" in report
    assert "reuse_count: 2" in report
    assert "staleness: 12" in report
    assert "Perfetto" in report


def test_healthy_run_never_fires_on_either(tmp_path):
    pair = _monitors(tmp_path)
    seq = [({"health_entropy_mean": 1.2, "health_clip_rho_frac": 0.05, "health_ev_value": 0.8},
            1000.0 + 0.5 * i) for i in range(20)]
    assert _feed(pair, seq) == [[]] * 20
    _same_gauges(*pair)
    assert pair[1].mon.bundles == []
    assert not os.path.exists(tmp_path / "port") or os.listdir(tmp_path / "port") == []


@dataclasses.dataclass(frozen=True)
class _Config:
    lr: float = 6e-4
    name: str = "pong"


def test_crash_bundle_written_once_as_jax(tmp_path):
    j, p = _monitors(tmp_path)
    for side in (j, p):
        side.mon.bind_context(config=_Config(), get_counters=lambda: {"num_steps": 3})
    _feed((j, p), [({"health_entropy_mean": 0.8}, 50.0)])
    err = ValueError("boom in train step")
    for side in (j, p):
        assert side.mon.on_crash(err) is not None
        assert side.mon.on_crash(ValueError("again")) is None
    _same_bundles(j, p)
    manifest, _, _ = _bundle(p.mon.bundles[0])
    assert manifest["reason"] == "crash" and manifest["rng"] is None
    assert manifest["counters"] == {"num_steps": 3}
    report = pm_tool.render_report(pm_tool.load_bundle(p.mon.bundles[0]))
    assert "ValueError: boom in train step" in report


def test_monitor_without_postmortem_is_safe(tmp_path):
    j, p = _monitors(tmp_path, postmortem=False)
    _feed((j, p), [({"health_entropy_mean": 0.5}, 1.0)])
    assert p.mon.on_crash(RuntimeError("x")) is None
    _same_gauges(j, p)


def test_slo_table_matches_jax():
    want = [dataclasses.asdict(s) for s in jax_health.health_slo_specs()]
    assert [dataclasses.asdict(s) for s in port_health.health_slo_specs()] == want
    assert (port_health.BUNDLE_SCHEMA_VERSION, port_health.BUNDLE_MANIFEST,
            port_health.BUNDLE_TRACE, port_health.BUNDLE_SNAPSHOTS) == (
        jax_health.BUNDLE_SCHEMA_VERSION, jax_health.BUNDLE_MANIFEST,
        jax_health.BUNDLE_TRACE, jax_health.BUNDLE_SNAPSHOTS)


# ---- the CLI -------------------------------------------------------------

PONG_GAUGES = {
    f"health/{k}"
    for k in (
        "clip_rho_frac", "clip_c_frac", "clip_logrho_mean", "clip_logrho_std",
        *(f"clip_logrho_bin{i}" for i in range(8)),
        "entropy_mean", "kl_behaviour_learner", "ev_value",
        *(f"{kind}_{g}" for kind in ("grad_norm", "update_ratio")
          for g in ("torso", "policy_head", "value_head")),
        "grad_spike_ratio", "staleness_clip_corr",
    )
}


def test_cli_health_publishes_every_gauge(tmp_path):
    """`run.HEALTH_CPU_EXAMPLE`: 8 steps logged each, so the staleness
    correlation has its 8 samples; every health gauge of the Pong net in
    the global registry, finite (chip_smoke's expected set is the same)."""
    argv = shlex.split(run.HEALTH_CPU_EXAMPLE.format(dir=tmp_path / "pm"))
    assert run.main(argv) == 0
    snap = get_registry().snapshot()
    health = {k[len("telemetry/"):]: v for k, v in snap.items() if k.startswith("telemetry/health/")}
    assert set(health) == PONG_GAUGES
    assert all(math.isfinite(v) for v in health.values()), health
    names = [k for k, _ in ImpalaNet(6, AtariShallowTorso(4)).named_parameters()]
    assert chip_smoke.expected_health_gauges(names) == PONG_GAUGES


def test_cli_crash_learner_writes_one_bundle(tmp_path):
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps([{"kind": "crash_learner", "at": 2}]))
    argv = shlex.split(run.HEALTH_CPU_EXAMPLE.format(dir=tmp_path / "pm")) + [
        "--chaos-plan", str(plan)]
    with pytest.raises(ChaosError):
        run.main(argv)
    bundles = pm_tool.list_bundles(str(tmp_path / "pm"))
    assert len(bundles) == 1 and bundles[0].endswith("_crash")
    manifest, trace, rows = _bundle(bundles[0])
    assert manifest["reason"] == "crash" and "ChaosError" in manifest["error"]
    assert manifest["counters"]["num_steps"] == 2
    assert rows and all("telemetry/health/entropy_mean" in r for r in rows)
    assert "traceEvents" in trace
