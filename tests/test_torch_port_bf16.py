"""The port's bf16 train step (`train_dtype="bfloat16"`) held against the
JAX package's full-bf16 step, on the CPU.

Narrow nets with flax-initialised params carried across by
`params_from_jax`, inputs made from numpy seeds, the torso built in bf16
as each package's `make_agent` builds it under this mode:

- the rounding contract, leaf by leaf: whether each grad of one bf16
  step is bf16-representable is the same on the port and on JAX, for the
  narrow Breakout net (unfused and fused) and the transformer net: the
  torso's, the heads', the fused block's and the transformer's grads are
  rounded, the LSTM cell's are not;
- the grads of one `_grads` call against JAX's `_compute_grads`, for the
  MLP, Nature-CNN, deep ResNet + LSTM (unfused and fused) and transformer
  nets: every leaf within a relative L2 distance of GRAD_RTOL (the LSTM
  leaves within LSTM_RTOL), the logs within LOG_TOL. The port's f32 step of
  the MLP net, whose compute is f32, fails that comparison: the mode
  flips the torso;
- three learner steps against JAX's bf16 learner on narrow Breakout,
  plain, with grad_accum=2 and with steps_per_dispatch=2 (two dispatches
  of two), each from JAX's state: the step within STEP_RTOL of JAX's,
  relative L2; the port's f32 learner fails that limit in each of the
  three;
- what stays f32 (params and RMSProp `nu` after an actor-fed step), the
  refusal of float16, the greedy-action gate and its f32 fallback in
  `run.py`, the CLI, and the fused loss's refusal of bf16.

The JAX reference of the LSTM nets. JAX's `ImpalaNet` unrolls the LSTM
under `nn.scan`. Under `train_dtype="bfloat16"` the transpose of that
scan meets the cell's float32 cotangents of its bf16 params and raises
(`AssertionError: (ShapedArray(bfloat16[16]), ShapedArray(float32[16]))`,
jax 0.9.0 on the CPU). JAX's learner is therefore given `_SteppedAgent`,
whose `unroll` applies the same JAX net in step mode, one call a time
step: the same torso, reset, cell and heads, the cotangents summed by
JAX's autodiff outside a scan. The learner, its cast and its loss are
JAX's own.
"""

import dataclasses
import functools
from typing import NamedTuple

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
from torched_impala_tpu.ops import ImpalaLossConfig as JaxLossConfig
from torched_impala_tpu.runtime import Learner as JaxLearner
from torched_impala_tpu.runtime import LearnerConfig as JaxLearnerConfig
from torched_impala_tpu.runtime import Trajectory as JaxTrajectory
from torched_impala_tpu_torch import configs, run
from torched_impala_tpu_torch.envs.fake import ScriptedEnv
from torched_impala_tpu_torch.models.agent import Agent
from torched_impala_tpu_torch.models.convert import params_from_jax, state_from_jax
from torched_impala_tpu_torch.models.nets import ImpalaNet
from torched_impala_tpu_torch.models.torsos import AtariDeepTorso, AtariShallowTorso, MLPTorso
from torched_impala_tpu_torch.ops import losses as port_losses
from torched_impala_tpu_torch.optim import RMSProp
from torched_impala_tpu_torch.runtime.learner import Learner, LearnerConfig
from torched_impala_tpu_torch.runtime.types import Trajectory
from torched_impala_tpu_torch.runtime.vector_actor import VectorActor

A, LSTM = 4, 16
HW, SECTIONS, HIDDEN = (16, 16), (4, 8, 8), 32
CORE = dict(d_model=32, num_layers=2, num_heads=2, window=16)
LR, DECAY, EPS = 6e-4, 0.99, 1e-7
BF16 = "bfloat16"
# Tolerances of the bf16 step against JAX's, relative L2 distance of a
# leaf's grad (float64 sums). Both packages round the same operations to
# bf16 but may sum products in another order, so a rounded value can
# land on the other bf16 neighbour, 2^-8 apart:
# - nets of matmuls only (MLP, transformer) agree leaf for leaf but for
#   the sums over rows of a bias grad: measured <= 2.7e-3, held to 2^-8;
# - conv torsos flip values all through the convs; a conv bias grad sums
#   N*H*W such values and cancels: measured <= 3.06e-2 (Nature-CNN's
#   first conv bias), held to 2^-4; their weights measured <= 4.2e-3;
# - the LSTM cell's grads are float32 sums of float32 products of rounded
#   weights: measured <= 1.7e-7, held to 1e-5.
# JAX's grads are those of its jaxpr: its step is compiled without XLA's
# excess precision (EXACT). With it, XLA on the CPU drops the rounding
# f32 -> bf16 -> f32 pairs, so the torso runs at f32 precision and no
# grad is rounded: its torso grads then sit 10-40% from the bf16 step's
# at these narrow widths (measured), as far as an f32 torso's do.
EXACT = {"xla_allow_excess_precision": False}
GRAD_RTOL = {"matmul": 2.0**-8, "conv": 2.0**-4}
LSTM_RTOL = 1e-5
# The loss logs, relative and absolute: a sum that cancels (Nature-CNN's
# pg_loss, -0.0330) moves 8e-5 (measured).
LOG_TOL = 1e-3
# A learner step (a dispatch of K steps) taken from JAX's state, held by
# the relative L2 distance of the whole step, ||dp_port - dp_jax|| /
# ||dp_jax||, which no single element dominates (RMSProp divides each
# grad by its own history). Each step starts from JAX's state: the bf16
# lowering is discontinuous in the master (an f32 difference of one ulp
# can flip a weight's bf16 rounding), so free-running steps compound the
# flips (measured: 0.16 after three free steps). Measured from JAX's
# state, the bf16 learner: <= 4.1e-3 a step (plain and grad_accum=2),
# 2.2e-2 and 6.4e-2 for the two K = 2 dispatches (a dispatch's second
# step starts from the first's own rounding). The port's f32 learner
# through the same comparison: >= 0.130 a step plain, >= 0.087 with
# grad_accum=2, 0.204 and 0.272 a K = 2 dispatch
# (test_the_f32_learner_fails_the_step_comparison). Held to 2^-5 = 0.031
# a step and 2^-3 = 0.125 a dispatch of two, between the two readings;
# the dispatch's logs (its last step's) at 2^-3 too.
STEP_RTOL = {1: 2.0**-5, 2: 2.0**-3}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _Agent(JaxAgent):
    """JAX's agent, its params initialised under one jit: flax's eager
    init compiles each initializer apart, most of a narrow learner's
    construction time. Both packages get the params it returns."""

    def init_params(self, rng, example_obs):
        return jax.jit(lambda r, x: JaxAgent.init_params(self, r, x))(rng, example_obs)


class _SteppedAgent(_Agent):
    """JAX's agent with the unroll applied in step mode, one call a time
    step (module docstring)."""

    def unroll(self, params, obs, first, state):
        outs = []
        for t in range(obs.shape[0]):
            out, state = self.net.apply(params, obs[t], first[t], state, unroll=False)
            outs.append(out)
        return jax.tree.map(lambda *x: jnp.stack(x), *outs), state


@dataclasses.dataclass(frozen=True)
class Net:
    """A narrow net in both packages, and its observations."""

    jax_net: object  # torso dtype -> flax ImpalaNet
    port_net: object  # torso dtype -> port ImpalaNet
    obs_shape: tuple
    pixels: bool
    lstm: bool = False

    @property
    def grad_rtol(self) -> float:
        return GRAD_RTOL["conv" if self.pixels else "matmul"]


def _breakout(fused):
    return Net(
        jax_net=lambda dt: JaxNet(
            num_actions=A,
            torso=JaxDeep(channel_sections=SECTIONS, hidden_size=HIDDEN, dtype=jnp.dtype(dt),
                          fused_blocks=fused),
            use_lstm=True, lstm_size=LSTM,
        ),
        port_net=lambda dt: ImpalaNet(
            A, AtariDeepTorso(4, HW, SECTIONS, 2, HIDDEN, dtype=dt, fused_blocks=fused),
            core="lstm", lstm_size=LSTM,
        ),
        obs_shape=(*HW, 4), pixels=True, lstm=True,
    )


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
    "breakout_unfused": _breakout(False),
    "breakout_fused": _breakout(True),
    "transformer": Net(
        jax_net=lambda dt: JaxNet(num_actions=A, torso=JaxMLP(hidden_sizes=(16, 16), dtype=jnp.dtype(dt)),
                                  core="transformer", transformer=tuple(CORE.items())),
        port_net=lambda dt: ImpalaNet(A, MLPTorso(4, (16, 16), dtype=dt), core="transformer",
                                      transformer=dict(CORE, dense_kernel="einsum")),
        obs_shape=(4,), pixels=False,
    ),
}


def _learners(name, T, B, port_dtype=BF16, **fields):
    """JAX's bf16 learner and the port's learner at `port_dtype`, from the
    same flax params; `fields` go to both LearnerConfigs."""
    net = NETS[name]
    K = fields.get("steps_per_dispatch", 1)
    agent_cls = _SteppedAgent if net.lstm else _Agent
    example = np.zeros(net.obs_shape, np.uint8 if net.pixels else np.float32)
    jlearner = JaxLearner(
        agent=agent_cls(net.jax_net(BF16)),
        optimizer=optax.rmsprop(LR, decay=DECAY, eps=EPS),
        config=JaxLearnerConfig(
            batch_size=B, unroll_length=T, loss=JaxLossConfig(vtrace_implementation="scan"),
            train_dtype=BF16, **fields,
        ),
        example_obs=example,
        rng=jax.random.key(0),
    )
    impl = jlearner._train_multi_impl if K > 1 else jlearner._train_step_impl
    jlearner._train_step = jax.jit(impl, compiler_options=EXACT)
    port = net.port_net(port_dtype)
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jlearner.params)))
    learner = Learner(
        agent=Agent(port),
        optimizer=RMSProp(LR, decay=DECAY, eps=EPS),
        config=LearnerConfig(batch_size=B, unroll_length=T, train_dtype=port_dtype, **fields),
        device=torch.device("cpu"),
    )
    return jlearner, learner


def _unrolls(name, T, n, seed):
    """`n` single-env unrolls of net `name` as dicts of numpy arrays."""
    net = NETS[name]
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


def _batch(name, T, B, seed):
    """One `[T(+1), B]` batch: numpy arrays by field, the start state
    stacked on axis 0 (empty for the transformer: each package's zero
    state is passed in its place)."""
    unrolls = _unrolls(name, T, B, seed)
    batch = {k: np.stack([u[k] for u in unrolls], axis=1) for k in unrolls[0] if k != "agent_state"}
    batch["agent_state"] = tuple(
        np.concatenate([u["agent_state"][i] for u in unrolls]) for i in range(len(unrolls[0]["agent_state"]))
    )
    return batch


class GradsCall(NamedTuple):
    port: dict  # grads by name
    jax: dict  # JAX's grads by name (params_from_jax's names)
    port_logs: dict
    jax_logs: dict
    learner: Learner
    arrays: tuple  # the port's batch


@functools.lru_cache(maxsize=None)
def _one_grads_call(name, port_dtype=BF16) -> GradsCall:
    """One `_grads` call of the port's learner and one `_compute_grads`
    call of JAX's bf16 learner on the same batch."""
    T, B = (2, 2) if name == "nature_cnn" else (3, 2)
    jlearner, learner = _learners(name, T, B, port_dtype)
    batch = _batch(name, T, B, seed=7)
    jstate = batch["agent_state"] or jlearner._agent.initial_state(B)
    pstate = tuple(map(torch.from_numpy, batch["agent_state"])) or learner._agent.initial_state(B)
    args = dict(
        params=jlearner._params, popart_state=(),
        **{k: jnp.asarray(v) for k, v in batch.items() if k != "agent_state"},
        tasks=jnp.zeros((B,), jnp.int32), agent_state=jax.tree.map(jnp.asarray, jstate),
    )
    jgrads, jlogs, _ = jax.jit(jlearner._compute_grads, compiler_options=EXACT)(**args)
    arrays = (
        torch.from_numpy(batch["obs"]), torch.from_numpy(batch["first"]),
        torch.from_numpy(batch["actions"]).long(), torch.from_numpy(batch["behaviour_logits"]),
        torch.from_numpy(batch["rewards"]), torch.from_numpy(batch["cont"]), pstate,
    )
    grads, logs = learner._grads(arrays)
    return GradsCall(
        dict(zip(learner.params, grads)),
        params_from_jax(jax.tree.map(np.asarray, jgrads)),
        {k: float(v) for k, v in logs.items()},
        {k: float(v) for k, v in jlogs.items()},
        learner,
        arrays,
    )


def _representable(g: torch.Tensor) -> bool:
    return bool(torch.equal(g.to(torch.bfloat16).float(), g))


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def _mismatches(name, call: GradsCall) -> dict:
    """The leaves and logs where the port's step is off JAX's: (relative
    distance, port rounded, JAX rounded) by leaf; empty if it matches."""
    bad = {}
    for leaf, g in call.port.items():
        tol = LSTM_RTOL if leaf.startswith("lstm.") else NETS[name].grad_rtol
        want = call.jax[leaf]
        rel = _rel(g, want)
        if not rel <= tol or _representable(g) != _representable(want):
            bad[leaf] = (rel, _representable(g), _representable(want))
    for key in ("total_loss", "pg_loss", "baseline_loss", "entropy_loss"):
        got, want = call.port_logs[key], call.jax_logs[key]
        if not abs(got - want) <= LOG_TOL * (1 + abs(want)):
            bad[key] = (got, want)
    return bad


@pytest.mark.parametrize("name", ["breakout_unfused", "breakout_fused", "transformer"])
def test_rounding_contract_matches_jax_leaf_by_leaf(name):
    """Which grads of the bf16 step are bf16-representable is JAX's, for
    every leaf: the LSTM cell's reach the f32 masters unrounded (its
    backward returns f32 grads for bf16 primals), every other leaf's are
    rounded on their way back."""
    port, want = _one_grads_call(name)[:2]
    assert sorted(port) == sorted(want)
    got = {k: _representable(g) for k, g in port.items()}
    assert got == {k: _representable(g) for k, g in want.items()}
    for k, rounded in got.items():
        assert rounded == (not k.startswith("lstm.")), k
        assert port[k].dtype == torch.float32, k


@pytest.mark.parametrize("name", list(NETS))
def test_bf16_grads_match_jax(name):
    """One `_grads` call of the bf16 step against JAX's `_compute_grads`
    under train_dtype="bfloat16" (module docstring's tolerances)."""
    assert _mismatches(name, _one_grads_call(name)) == {}


def test_the_f32_step_fails_the_bf16_comparison():
    """The comparison discriminates: the port's float32 step of the MLP
    net (an f32 torso, as make_agent builds CartPole in float32) is off
    JAX's bf16 step past the tolerance, and no grad of it is rounded."""
    call = _one_grads_call("mlp", "float32")
    rels = {k: _rel(g, call.jax[k]) for k, g in call.port.items()}
    assert max(rels.values()) > NETS["mlp"].grad_rtol, rels
    assert not any(_representable(g) for g in call.port.values())
    assert set(_mismatches("mlp", call)) >= set(call.port)


LOG_KEYS = ("total_loss", "pg_loss", "baseline_loss", "entropy_loss", "grad_norm_unclipped")


def _learner_steps(fields, port_dtype=BF16):
    """Three learner steps on narrow Breakout with LSTM start states (two
    dispatches at K = 2) of JAX's bf16 learner and the port's at
    `port_dtype`, through each learner's own queue, each dispatch from
    JAX's state (`state_from_jax`, module constants). Returns, a dispatch,
    the relative L2 distance of the port's step from JAX's and the logs
    (port, JAX); and the port's learner."""
    T, B = 3, 2
    K = fields.get("steps_per_dispatch", 1)
    dispatches = 3 if K == 1 else 2
    jlearner, learner = _learners(
        "breakout_unfused", T, B, port_dtype, queue_capacity=dispatches * K * B, **fields
    )
    unrolls = _unrolls("breakout_unfused", T, dispatches * K * B, seed=3)
    learner.start()
    for u in unrolls:
        jlearner.enqueue(JaxTrajectory(**u))
        learner.enqueue(Trajectory(**u))
    jlearner.start()
    readings = []
    try:
        for _ in range(dispatches):
            learner.set_state(state_from_jax(jax.tree.map(np.asarray, jlearner.get_state())))
            before = {k: v.detach().clone() for k, v in learner.params.items()}
            jlogs = jlearner.step_once(timeout=300)
            plogs = learner.step_once(timeout=60)
            want = params_from_jax(jax.tree.map(np.asarray, jlearner.params))
            got = torch.cat([(p.detach() - before[k]).flatten() for k, p in learner.params.items()])
            step = torch.cat([(want[k] - before[k]).flatten() for k in learner.params])
            readings.append((_rel(got, step),
                             {k: (float(plogs[k]), float(jlogs[k])) for k in LOG_KEYS}))
    finally:
        jlearner.stop()
        learner.stop()
        learner.join()
    assert learner.num_steps == jlearner.num_steps == dispatches * K
    return readings, learner


STEP_FIELDS = dict(plain={}, accum2=dict(grad_accum=2), dispatch2=dict(steps_per_dispatch=2))


@pytest.mark.parametrize("fields", list(STEP_FIELDS.values()), ids=list(STEP_FIELDS))
def test_learner_steps_match_jax_bf16_learner(fields):
    """Three bf16 learner steps against JAX's bf16 learner (`_learner_steps`):
    each dispatch within STEP_RTOL of JAX's, the logs close, the params and
    RMSProp moments still f32."""
    K = fields.get("steps_per_dispatch", 1)
    log_tol = LOG_TOL if K == 1 else STEP_RTOL[K]
    readings, learner = _learner_steps(fields)
    for i, (rel, logs) in enumerate(readings):
        assert rel <= STEP_RTOL[K], (i, rel)
        for key, (got, want) in logs.items():
            np.testing.assert_allclose(got, want, rtol=log_tol, atol=log_tol,
                                       err_msg=f"dispatch {i} {key}")
    assert all(p.dtype == torch.float32 for p in learner.params.values())
    assert all(v.dtype == torch.float32 for v in learner._optimizer.nu.values())


@pytest.mark.parametrize("name", list(STEP_FIELDS))
def test_the_f32_learner_fails_the_step_comparison(name):
    """The step comparison discriminates: every dispatch of the port's
    float32 learner (a bf16 torso, as make_agent builds Breakout, but the
    params not lowered) is off JAX's bf16 learner past STEP_RTOL."""
    fields = STEP_FIELDS[name]
    readings, _ = _learner_steps(fields, "float32")
    rels = [rel for rel, _ in readings]
    assert min(rels) > STEP_RTOL[fields.get("steps_per_dispatch", 1)], rels


def test_params_and_nu_stay_f32_after_an_actor_fed_step():
    """One actor-fed bf16 step: the params, the published params and every
    RMSProp moment are exactly float32 and finite (JAX's
    test_accumulators_stay_f32_through_full_step); the actor acts on the
    f32 params."""
    T, B = 5, 2
    cfg = dataclasses.replace(configs.CARTPOLE, train_dtype=BF16, batch_size=B, unroll_length=T)
    agent = configs.make_agent(cfg)
    assert agent.net.torso.dtype == torch.bfloat16
    learner = Learner(agent=agent, optimizer=configs.make_optimizer(cfg),
                      config=configs.make_learner_config(cfg), device=torch.device("cpu"))
    actor = VectorActor(actor_id=0, envs=[ScriptedEnv(episode_len=4) for _ in range(B)],
                        agent=agent, param_store=learner.param_store, enqueue=learner.enqueue,
                        unroll_length=T, device=torch.device("cpu"))
    actor.unroll_and_push()
    learner.start()
    try:
        logs = learner.step_once(timeout=60)
    finally:
        learner.stop()
        learner.join()
    assert np.isfinite(float(logs["total_loss"]))
    _, published = learner.param_store.get()
    for tensors in (learner.params, learner._optimizer.nu, published, dict(actor._agent.net.named_parameters())):
        for k, t in tensors.items():
            assert t.dtype == torch.float32 and bool(torch.isfinite(t).all()), k
    # Only the learner's private net was rebound: the agent's params are
    # the masters, not lowered copies.
    for k, p in agent.net.named_parameters():
        assert p is learner.params[k]


def test_remat_torso_gives_the_same_bf16_grads(monkeypatch):
    """The lowered params stay bound through the backward, where a
    rematerialized torso runs its forward again: the same grads bit for
    bit as without remat."""
    call = _one_grads_call("breakout_fused")
    net = NETS["breakout_fused"].port_net(BF16)
    net.remat_torso = True
    net.load_state_dict({k: v.detach() for k, v in call.learner.params.items()})
    learner = Learner(agent=Agent(net), optimizer=RMSProp(LR, decay=DECAY, eps=EPS),
                      config=LearnerConfig(batch_size=2, unroll_length=3, train_dtype=BF16),
                      device=torch.device("cpu"))
    calls = []
    checkpoint = torch.utils.checkpoint.checkpoint

    def counted(*args, **kwargs):
        calls.append(1)
        return checkpoint(*args, **kwargs)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counted)
    grads, _ = learner._grads(call.arrays)
    assert calls, "remat did not run"
    for k, g in zip(learner.params, grads):
        assert torch.equal(g, call.port[k]), k


@pytest.mark.parametrize("where", ["make_agent", "learner"])
def test_float16_is_refused(where):
    cfg = dataclasses.replace(configs.CARTPOLE, train_dtype="float16")
    with pytest.raises(ValueError, match="float16"):
        if where == "make_agent":
            configs.make_agent(cfg)
        else:
            Learner(agent=configs.make_agent(configs.CARTPOLE), optimizer=configs.make_optimizer(cfg),
                    config=LearnerConfig(train_dtype="float16"), device=torch.device("cpu"))


def test_gate_passes_on_cartpole():
    """JAX's test_cartpole_bf16_passes: the probe's greedy actions agree."""
    cfg = dataclasses.replace(configs.CARTPOLE, train_dtype=BF16)
    assert configs.check_train_dtype_parity(cfg, "cpu", seed=0, batch=8, unroll=4) == (True, 0)
    assert configs.check_train_dtype_parity(configs.CARTPOLE, "cpu") == (True, 0)


def test_failing_gate_falls_back_to_f32(monkeypatch, capsys):
    """A half forward made to disagree fails the gate; `run.py` then warns
    on stderr and trains the f32 step, and exits 0."""
    from torched_impala_tpu_torch.models import nets

    linear = nets._linear_f32

    def flipped(layer, x):
        out = linear(layer, x)
        return -out if layer.weight.dtype == torch.bfloat16 else out

    monkeypatch.setattr(nets, "_linear_f32", flipped)
    cfg = dataclasses.replace(configs.CARTPOLE, train_dtype=BF16)
    ok, mismatches = configs.check_train_dtype_parity(cfg, "cpu", seed=0)
    assert not ok and mismatches > 0
    dtypes = []
    learner_init = Learner.__init__

    def recording(self, *, config, **kw):
        dtypes.append(config.train_dtype)
        learner_init(self, config=config, **kw)

    monkeypatch.setattr(Learner, "__init__", recording)
    rc = run.main((run.BREAKOUT_BF16_CPU_EXAMPLE.replace("breakout", "cartpole")).split())
    out = capsys.readouterr()
    assert rc == 0 and "done: steps=3" in out.out
    assert "warning: --train-dtype bfloat16 refused" in out.err
    assert "falling back to float32" in out.err
    assert dtypes == ["float32"]


def test_breakout_bf16_cli_returns_zero(capsys, monkeypatch):
    """The README's bf16 Breakout command on thread actors: the gate
    passes and the learner trains the bf16 step."""
    from pathlib import Path

    readme = " ".join(
        (Path(__file__).resolve().parents[1] / "README.md").read_text().replace("\\\n", " ").split()
    )
    assert f"python -m torched_impala_tpu_torch.run {run.BREAKOUT_BF16_CPU_EXAMPLE}" in readme
    dtypes = []
    learner_init = Learner.__init__

    def recording(self, *, config, **kw):
        dtypes.append(config.train_dtype)
        learner_init(self, config=config, **kw)

    monkeypatch.setattr(Learner, "__init__", recording)
    rc = run.main(run.BREAKOUT_BF16_CPU_EXAMPLE.split())
    out = capsys.readouterr()
    assert rc == 0 and "done: steps=3" in out.out
    assert "refused" not in out.err
    assert dtypes == [BF16]


def test_fused_epilogue_still_refuses_bf16():
    """The bf16 phase of the fused loss is not ported: it raises under its
    ROADMAP title, in the loss and in a learner step."""
    title = "The learner step's launches, then the rest of the learner"
    rng = np.random.default_rng(0)
    T, B = 3, 2
    x = dict(
        target_logits=torch.from_numpy(rng.normal(size=(T, B, A)).astype(np.float32)),
        behaviour_logits=torch.from_numpy(rng.normal(size=(T, B, A)).astype(np.float32)),
        values=torch.zeros(T, B), bootstrap_value=torch.zeros(B),
        actions=torch.zeros(T, B, dtype=torch.long), rewards=torch.zeros(T, B),
        discounts=torch.full((T, B), 0.99),
    )
    cfg = port_losses.ImpalaLossConfig(fused_epilogue=True, train_dtype=BF16)
    with pytest.raises(NotImplementedError, match=title):
        port_losses.impala_loss(**x, config=cfg)
    # The unfused loss takes the field and ignores it.
    plain = port_losses.impala_loss(**x, config=port_losses.ImpalaLossConfig())
    bf16 = port_losses.impala_loss(**x, config=port_losses.ImpalaLossConfig(train_dtype=BF16))
    assert torch.equal(plain.total, bf16.total)
    rc_cfg = run.build_config(run.parse_args(
        (run.BREAKOUT_BF16_CPU_EXAMPLE + " --fused-epilogue").split()))
    assert configs.make_learner_config(rc_cfg).loss.train_dtype == BF16
    with pytest.raises(NotImplementedError, match=title):
        run.main((run.BREAKOUT_BF16_CPU_EXAMPLE + " --fused-epilogue").split())
