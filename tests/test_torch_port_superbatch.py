"""The port's K-step superbatch dispatch held against the JAX learner's
`steps_per_dispatch`, on the CPU.

- One K = 3 dispatch through the port's `Learner` and through the JAX
  `Learner` on the same K*B unrolls and the same flax params, for the MLP
  and the LSTM nets (and K = 2 with grad_accum = 2): the params after the
  dispatch at rtol 1e-4, atol 1e-6 and the last step's logs at rtol 1e-4,
  atol 1e-5, as tests/test_torch_port_learner.py holds one step.
- The port's dispatch against K sequential port steps: bit for bit.
- `stack_superbatch` and the batcher's in-place assembly against JAX's
  `stack_superbatch`; the ring's superbatch slots against JAX's
  `TrajectoryRing(superbatch_k=K)` fed the same writes.
- The K-step semantics: publish and log crossings, the step budget, the
  queue capacity, `scaled_base_lr`, `donate_batch` (bit for bit, the
  slot released only after its step), the CLI example, a resume and a
  chaos crash at K = 2.
"""

import dataclasses
import json
import threading
import warnings

import jax
import numpy as np
import optax
import pytest
import torch

from torched_impala_tpu import configs as jax_configs
from torched_impala_tpu.models import Agent as JaxAgent
from torched_impala_tpu.models import ImpalaNet as JaxNet
from torched_impala_tpu.models import MLPTorso as JaxMLP
from torched_impala_tpu.ops import ImpalaLossConfig as JaxLossConfig
from torched_impala_tpu.runtime import Learner as JaxLearner
from torched_impala_tpu.runtime import LearnerConfig as JaxLearnerConfig
from torched_impala_tpu.runtime import Trajectory as JaxTrajectory
from torched_impala_tpu.runtime import stack_superbatch as jax_stack_superbatch
from torched_impala_tpu.runtime import stack_trajectories as jax_stack
from torched_impala_tpu.runtime.learner import alloc_stack_buffers as jax_alloc_stack_buffers
from torched_impala_tpu.runtime.traj_ring import TrajectoryRing as JaxRing
from torched_impala_tpu_torch import configs, run
from torched_impala_tpu_torch.envs.fake import ScriptedEnv
from torched_impala_tpu_torch.models.agent import Agent
from torched_impala_tpu_torch.models.convert import params_from_jax
from torched_impala_tpu_torch.models.nets import ImpalaNet
from torched_impala_tpu_torch.models.torsos import MLPTorso
from torched_impala_tpu_torch.ops.losses import ImpalaLossConfig
from torched_impala_tpu_torch.optim import RMSProp
from torched_impala_tpu_torch.resilience import recovery
from torched_impala_tpu_torch.runtime.learner import (
    Learner,
    LearnerConfig,
    alloc_stack_buffers,
    stack_superbatch,
    stack_trajectories,
)
from torched_impala_tpu_torch.runtime.traj_ring import TrajectoryRing
from torched_impala_tpu_torch.runtime.types import Trajectory
from torched_impala_tpu_torch.runtime.vector_actor import VectorActor

A = 6
LSTM = 8
LR, DECAY, EPS = 6e-4, 0.99, 1e-7
LOG_KEYS = ("total_loss", "pg_loss", "baseline_loss", "entropy_loss", "grad_norm_unclipped")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _unrolls(kind, T, n, seed=0):
    """`n` single-env unrolls as dicts of numpy arrays, from `seed`."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(1000 * seed + i)
        out.append(
            dict(
                obs=rng.normal(size=(T + 1, 4)).astype(np.float32),
                first=rng.uniform(size=(T + 1,)) < 0.2,
                actions=rng.integers(0, A, size=(T,)).astype(np.int32),
                behaviour_logits=rng.normal(size=(T, A)).astype(np.float32),
                rewards=rng.normal(size=(T,)).astype(np.float32),
                cont=(rng.uniform(size=(T,)) > 0.1).astype(np.float32),
                agent_state=tuple(
                    rng.normal(size=(1, LSTM)).astype(np.float32) * 0.5 for _ in range(2)
                ) if kind == "lstm" else (),
                param_version=int(rng.integers(0, 50)),
            )
        )
    return out


def _build(kind, T, B, *, jax_logger=None, logger=None, **fields):
    """The JAX learner and the port's from the same flax params; `fields`
    (steps_per_dispatch, grad_accum, intervals, ...) go to both configs."""
    core = dict(use_lstm=True, lstm_size=LSTM) if kind == "lstm" else {}
    jlearner = JaxLearner(
        agent=JaxAgent(JaxNet(num_actions=A, torso=JaxMLP(hidden_sizes=(16, 16)), **core)),
        optimizer=optax.rmsprop(LR, decay=DECAY, eps=EPS),
        config=JaxLearnerConfig(
            batch_size=B, unroll_length=T,
            loss=JaxLossConfig(vtrace_implementation="scan"), **fields,
        ),
        example_obs=np.zeros((4,), np.float32),
        rng=jax.random.key(0),
        logger=jax_logger,
    )
    net = ImpalaNet(A, MLPTorso(4, (16, 16)), core="lstm" if core else "none", lstm_size=LSTM)
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jlearner.params)))
    learner = Learner(
        agent=Agent(net), optimizer=RMSProp(LR, decay=DECAY, eps=EPS),
        config=LearnerConfig(batch_size=B, unroll_length=T, loss=ImpalaLossConfig(), **fields),
        device=torch.device("cpu"), logger=logger,
    )
    return jlearner, learner


def _port_learner(kind, T, B, seed=0, **fields):
    net = ImpalaNet(A, MLPTorso(4, (16, 16), generator=torch.Generator().manual_seed(seed)),
                    core="lstm" if kind == "lstm" else "none", lstm_size=LSTM,
                    generator=torch.Generator().manual_seed(seed + 1))
    return Learner(
        agent=Agent(net), optimizer=RMSProp(LR, decay=DECAY, eps=EPS),
        config=LearnerConfig(batch_size=B, unroll_length=T, **fields),
        device=torch.device("cpu"),
    )


def _assert_close_to_jax(learner, jlearner, plogs, jlogs, what):
    for key in LOG_KEYS:
        np.testing.assert_allclose(float(plogs[key]), float(jlogs[key]), rtol=1e-4, atol=1e-5,
                                   err_msg=f"{what} log {key}")
    want = params_from_jax(jax.tree.map(np.asarray, jlearner.params))
    for name, p in learner.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=f"{what} param {name}")


def _feed_both(jlearner, learner, unrolls):
    learner.start()
    for u in unrolls:
        jlearner.enqueue(JaxTrajectory(**u))
        learner.enqueue(Trajectory(**u))
    jlearner.start()


@pytest.mark.parametrize(
    "kind,K,fields",
    [("mlp", 3, {}), ("lstm", 3, {}), ("mlp", 2, dict(grad_accum=2))],
    ids=["mlp_k3", "lstm_k3", "mlp_k2_accum2"],
)
def test_dispatch_matches_jax_steps_per_dispatch(kind, K, fields):
    """One dispatch of K steps on K*B unrolls: the params after it and the
    last step's logs are JAX's (its scan over K steps), the counters K
    steps and K*T*B frames."""
    T, B = 5, 4
    jlearner, learner = _build(kind, T, B, steps_per_dispatch=K, **fields)
    _feed_both(jlearner, learner, _unrolls(kind, T, K * B))
    try:
        jlogs = jlearner.step_once(timeout=300)
        plogs = learner.step_once(timeout=60)
        _assert_close_to_jax(learner, jlearner, plogs, jlogs, f"K={K}")
    finally:
        jlearner.stop()
        learner.stop()
        learner.join()
    assert learner.num_steps == jlearner.num_steps == K
    assert learner.num_frames == jlearner.num_frames == K * T * B
    assert plogs["num_steps"] == K and plogs["num_frames"] == K * T * B


@pytest.mark.parametrize("kind", ["mlp", "lstm"])
def test_dispatch_equals_k_sequential_steps_bit_for_bit(kind):
    """A K = 3 dispatch against three K = 1 `step_once`s of a twin learner
    on the same unrolls: the same params and last logs, bit for bit."""
    T, B, K = 4, 2, 3
    unrolls = _unrolls(kind, T, K * B, seed=4)
    learners = {k: _port_learner(kind, T, B, steps_per_dispatch=k) for k in (1, K)}
    logs = {}
    for k, learner in learners.items():
        learner.start()
        for u in unrolls:
            learner.enqueue(Trajectory(**u))
        try:
            for _ in range(K // k):
                logs[k] = learner.step_once(timeout=60)
        finally:
            learner.stop()
            learner.join()
        assert (learner.num_steps, learner.num_frames) == (K, K * T * B)
    for name, p in learners[1].params.items():
        assert torch.equal(p, learners[K].params[name]), name
    for key in (*LOG_KEYS, "weight_norm"):
        assert torch.equal(logs[1][key], logs[K][key]), key


def test_superbatch_assembly_matches_jax_stack_superbatch():
    """The batcher's in-place assembly (`stack_trajectories(..., out=)`
    into the [k] slices of one buffer) equals the port's and JAX's
    `stack_superbatch` of the K stacked rounds, bit for bit; its param
    version is the least of the K rounds'. The queue holds 2*B*K unrolls
    by default, as JAX's."""
    T, B, K = 3, 4, 2
    unrolls = _unrolls("lstm", T, K * B, seed=7)
    learner = _port_learner("lstm", T, B, steps_per_dispatch=K)
    assert learner._traj_q.maxsize == 2 * B * K
    assert _port_learner("lstm", T, B, steps_per_dispatch=K, queue_capacity=5)._traj_q.maxsize == 5
    for u in unrolls:
        learner.enqueue(Trajectory(**u))
    got = learner._assemble_superbatch(K)
    rounds = [unrolls[k * B:(k + 1) * B] for k in range(K)]
    ours = stack_superbatch([stack_trajectories([Trajectory(**u) for u in r]) for r in rounds])
    want = jax_stack_superbatch([jax_stack([JaxTrajectory(**u) for u in r]) for r in rounds])
    for a, b, c in zip(got[:6], ours[:6], want[:6]):
        assert a.shape == b.shape == c.shape and a.shape[:1] == (K,)
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    for a, b, c in zip(got.agent_state, ours.agent_state, want.agent_state):
        assert a.shape == (K, B, LSTM)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    assert got.param_version == ours.param_version == want.param_version
    assert got.param_version == min(u["param_version"] for u in unrolls)
    shapes = jax_alloc_stack_buffers([JaxTrajectory(**u) for u in rounds[0]], K)
    mine = alloc_stack_buffers([Trajectory(**u) for u in rounds[0]], K)
    for a, b in zip((*mine[:6], *mine.agent_state), (*shapes[:6], *shapes.agent_state)):
        assert a.shape == b.shape and a.dtype == b.dtype


def _write(block, rng):
    for name in ("obs", "behaviour_logits", "rewards", "cont"):
        getattr(block, name)[...] = rng.normal(size=getattr(block, name).shape)
    block.first[...] = rng.uniform(size=block.first.shape) < 0.3
    block.actions[...] = rng.integers(0, A, size=block.actions.shape)
    for leaf in block.agent_state:
        leaf[...] = rng.normal(size=leaf.shape)


def test_superbatch_ring_matches_jax_ring_on_identical_writes():
    """Blocks of E = 2 columns into K = 3 sub-batches of B = 4: each
    writer's view is a plain [T+1, E, ...] slice of one sub-batch, at
    JAX's global -> (k, local) columns; the slot is ready only once all
    K*B columns committed; the delivered [K, ...] slot, its param version
    and its per-block versions are JAX's."""
    T, B, K, E = 3, 4, 3, 2
    state = tuple(np.zeros((1, LSTM), np.float32) for _ in range(2))
    common = dict(num_slots=2, unroll_length=T, batch_size=B,
                  example_obs=np.zeros((4,), np.float32), num_actions=A, superbatch_k=K)
    port = TrajectoryRing(**common, agent_state_example=tuple(torch.from_numpy(x) for x in state))
    ref = JaxRing(**common, agent_state_example=state)
    assert port.validate_env_spec(np.zeros((4,), np.float32), A) == []
    assert port._slots[0].arrays.obs.shape == ref._slots[0].buffers.obs.shape == (K, T + 1, B, 4)
    versions = [40, 31, 52, 47, 33, 60]
    for i, version in enumerate(versions):
        block, ref_block = port.acquire(E), ref.acquire(E)
        assert (block.slot, block.cols) == (ref_block.slot, ref_block.cols)
        for a, b in zip((*block[3:9], *block.agent_state), (*ref_block[3:9], *ref_block.agent_state)):
            assert a.shape == b.shape
        assert block.obs.shape == (T + 1, E, 4)
        _write(block, np.random.default_rng(i))
        _write(ref_block, np.random.default_rng(i))
        if i == len(versions) - 1:
            assert port.pop_ready(timeout=0.05) is None  # K*B - E columns committed
        port.commit(block, version)
        ref.commit(ref_block, version)
    got, want = port.pop_ready(timeout=1.0), ref.pop_ready(timeout=1.0)
    for a, b in zip(got.tensors[:6], want.arrays[:6]):
        assert a.shape[0] == K and a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(got.tensors[6], want.arrays[7]):
        np.testing.assert_array_equal(a.numpy(), b)
    assert (got.param_version, got.versions) == (want.param_version, want.versions)
    assert got.versions == tuple(versions) and got.param_version == 31


@pytest.mark.parametrize("interval", [2, 4])
def test_publish_and_log_fire_on_crossings_as_jax(interval):
    """K = 3 with publish and log intervals 2 and 4: the logger runs and
    the params publish on the dispatches whose K steps cross a multiple
    of the interval, the same dispatches as JAX's."""
    T, B, K, dispatches = 3, 1, 3, 4
    jseen, seen = [], []
    jlearner, learner = _build(
        "mlp", T, B, steps_per_dispatch=K, log_interval=interval, publish_interval=interval,
        queue_capacity=dispatches * K * B, jax_logger=lambda logs: jseen.append(logs["num_steps"]),
        logger=lambda logs: seen.append(logs["num_steps"]),
    )
    _feed_both(jlearner, learner, _unrolls("mlp", T, dispatches * K * B, seed=2))
    versions = []
    try:
        for _ in range(dispatches):
            jlearner.step_once(timeout=300)
            learner.step_once(timeout=60)
            versions.append((learner.param_store.get()[0], jlearner.param_store.get()[0]))
    finally:
        jlearner.stop()
        learner.stop()
        learner.join()
    want = {2: [3, 6, 9, 12], 4: [6, 9, 12]}[interval]
    assert seen == jseen == want
    frames = T * B
    published = [v for v, _ in versions]
    assert published == [j for _, j in versions]
    assert published == [max([0] + [n * frames for n in want if n <= 3 * (d + 1)])
                         for d in range(dispatches)]


def test_run_never_overshoots_the_budget_and_warns():
    """run(7) at K = 3 takes two dispatches (6 steps) and warns about the
    step left, as JAX's run does; the post-step hooks run once a dispatch
    with the step count."""
    T, B, K = 3, 1, 3
    jlearner, learner = _build("mlp", T, B, steps_per_dispatch=K, queue_capacity=4 * K * B)
    unrolls = _unrolls("mlp", T, 4 * K * B, seed=3)
    for u in unrolls:
        jlearner.enqueue(JaxTrajectory(**u))
    hooked = []
    feeder = threading.Thread(
        target=lambda: [learner.enqueue(Trajectory(**u)) for u in unrolls], daemon=True
    )
    feeder.start()
    for lrn, kwargs in ((jlearner, {}), (learner, dict(post_step=[hooked.append]))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            lrn.run(7, **kwargs)
        assert lrn.num_steps == 6
        assert any("not a multiple" in str(w.message) for w in caught)
    feeder.join(timeout=10)
    assert hooked == [3, 6]
    learner.join()


def _ring_learner(donate, T=4, B=4, K=2, E=2):
    cfg = dataclasses.replace(configs.CARTPOLE, use_lstm=True, lstm_size=LSTM, unroll_length=T,
                              batch_size=B, traj_ring=True, steps_per_dispatch=K,
                              donate_batch=donate)
    agent = configs.make_agent(cfg, seed=2)
    learner = Learner(agent=agent, optimizer=configs.make_optimizer(cfg),
                      config=configs.make_learner_config(cfg), device=torch.device("cpu"),
                      example_obs=np.zeros((4,), np.float32))
    actor = VectorActor(
        actor_id=0, envs=[ScriptedEnv(episode_len=4) for _ in range(E)], agent=agent.clone(),
        param_store=learner.param_store, enqueue=learner.enqueue, unroll_length=T,
        device=torch.device("cpu"), seed=3, traj_ring=learner.traj_ring,
    )
    return learner, actor


@pytest.mark.parametrize("dispatches", [3])
def test_donate_batch_is_bit_identical_and_releases_after_the_step(dispatches, monkeypatch):
    """Superbatch ring slots with and without `donate_batch`: the same
    params and logs bit for bit. With it the step reads the slot itself
    (no staging clone), the ring has two more slots, and every slot is
    released only after the dispatch that consumed it returned."""
    K, B, E = 2, 4, 2
    events = []
    lock = threading.Lock()
    dispatch, release = Learner.train_dispatch, TrajectoryRing.release

    def recording_dispatch(self, arrays):
        ptr = arrays[0].data_ptr()
        with lock:
            events.append(("start", ptr))
        out = dispatch(self, arrays)
        with lock:
            events.append(("end", ptr))
        return out

    def recording_release(self, s):
        with lock:
            events.append(("release", self._slots[s].tensors.obs.data_ptr()))
        return release(self, s)

    monkeypatch.setattr(Learner, "train_dispatch", recording_dispatch)
    monkeypatch.setattr(TrajectoryRing, "release", recording_release)
    results = {}
    for donate in (False, True):
        events.clear()
        learner, actor = _ring_learner(donate, B=B, K=K, E=E)
        assert learner.traj_ring.num_slots == learner._batch_q.maxsize + 2 + (2 if donate else 0)
        slot_ptrs = {s.tensors.obs.data_ptr() for s in learner.traj_ring._slots}
        learner.start()
        try:
            for _ in range(dispatches):
                for _ in range(K * B // E):
                    actor.unroll_and_push()
                logs = learner.step_once(timeout=60)
            # The batcher releases a handed-back slot on its next pass.
            for _ in range(500):
                with lock:
                    released = sum(kind == "release" for kind, _ in events)
                if not donate or released == dispatches:
                    break
                threading.Event().wait(0.01)
        finally:
            learner.stop()
            learner.join()
        with lock:
            seen = list(events)
        steps = [ptr for kind, ptr in seen if kind == "start"]
        assert len(steps) == dispatches
        assert all((ptr in slot_ptrs) == donate for ptr in steps)
        if donate:
            for i, (kind, ptr) in enumerate(seen):
                if kind != "release":
                    continue
                # The last start on this slot before its release has ended.
                starts = [j for j, e in enumerate(seen[:i]) if e == ("start", ptr)]
                assert starts and ("end", ptr) in seen[starts[-1]:i], seen
            assert sum(kind == "release" for kind, _ in seen) == dispatches
        results[donate] = ({k: v.clone() for k, v in learner.params.items()}, logs)
    (p0, l0), (p1, l1) = results[False], results[True]
    for name in p0:
        assert torch.equal(p0[name], p1[name]), name
    for key in (*LOG_KEYS, "weight_norm"):
        assert torch.equal(l0[key], l1[key]), key



def test_donated_slot_goes_back_when_the_step_raises(monkeypatch):
    """A dispatch that raises still hands its donated slot back: the
    batcher releases it, and the next dispatch trains on a fresh slot."""
    K, B, E = 2, 4, 2
    released = []
    release = TrajectoryRing.release
    dispatch = Learner.train_dispatch
    failed = []

    def failing_once(self, arrays):
        if not failed:
            failed.append(arrays[0].data_ptr())
            raise RuntimeError("injected step failure")
        return dispatch(self, arrays)

    def recording_release(self, s):
        released.append(self._slots[s].tensors.obs.data_ptr())
        return release(self, s)

    monkeypatch.setattr(Learner, "train_dispatch", failing_once)
    monkeypatch.setattr(TrajectoryRing, "release", recording_release)
    learner, actor = _ring_learner(True, B=B, K=K, E=E)
    learner.start()
    try:
        for _ in range(K * B // E):
            actor.unroll_and_push()
        with pytest.raises(RuntimeError, match="injected step failure"):
            learner.step_once(timeout=60)
        for _ in range(500):
            if failed[0] in released:
                break
            threading.Event().wait(0.01)
        assert released == failed
        for _ in range(K * B // E):
            actor.unroll_and_push()
        logs = learner.step_once(timeout=60)
    finally:
        learner.stop()
        learner.join()
    assert learner.num_steps == K and torch.isfinite(logs["total_loss"])

def test_scaled_base_lr_scales_by_the_effective_batch_as_jax():
    for K in (1, 2, 4):
        ours = dataclasses.replace(configs.PONG, lr_scale_ref_batch=16, steps_per_dispatch=K)
        theirs = dataclasses.replace(jax_configs.PONG, lr_scale_ref_batch=16, steps_per_dispatch=K)
        assert configs.scaled_base_lr(ours) == jax_configs.scaled_base_lr(theirs)
        assert configs.scaled_base_lr(ours) == configs.PONG.lr * 32 * K / 16
    assert configs.make_learner_config(
        dataclasses.replace(configs.PONG, steps_per_dispatch=3, donate_batch=True)
    ).steps_per_dispatch == 3


def test_steps_per_dispatch_below_one_raises():
    with pytest.raises(ValueError, match="steps_per_dispatch must be >= 1"):
        _port_learner("mlp", 3, 2, steps_per_dispatch=0)


def test_superbatch_cli_example_returns_zero(capsys):
    """`run.SUPERBATCH_CPU_EXAMPLE`: the Pong preset's process actors (two
    pools of one worker) into donated superbatch ring slots at K = 2."""
    from pathlib import Path

    readme = " ".join(
        (Path(__file__).resolve().parents[1] / "README.md").read_text().replace("\\\n", " ").split()
    )
    assert f"python -m torched_impala_tpu_torch.run {run.SUPERBATCH_CPU_EXAMPLE}" in readme
    args = run.parse_args(run.SUPERBATCH_CPU_EXAMPLE.split())
    cfg = run.build_config(args)
    assert (cfg.traj_ring, cfg.steps_per_dispatch, cfg.donate_batch) == (True, 2, True)
    assert run.main(run.SUPERBATCH_CPU_EXAMPLE.split()) == 0
    assert "done: steps=4" in capsys.readouterr().out


def test_queue_feed_cli_at_two_steps_a_dispatch(capsys):
    """`--steps-per-dispatch 2` on thread actors: the queue feed collects
    2*B unrolls a dispatch at the default queue capacity, and a budget of
    5 runs 4 steps."""
    argv = run.CPU_EXAMPLE.replace("--total-steps 3", "--total-steps 5").split()
    with pytest.warns(UserWarning, match="not a multiple"):
        assert run.main(argv + ["--steps-per-dispatch", "2", "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "done: steps=4" in out
    assert [line.split()[0] for line in out.splitlines() if line.startswith("num_steps")] == [
        "num_steps=2", "num_steps=4"]


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_resume_and_chaos_at_two_steps_a_dispatch(tmp_path, capsys):
    """K = 2 with the async checkpointer every 2 steps: the chaos plan's
    learner crash fires on the third dispatch (step 6), with the interval
    saves on multiples of 2; a resume to a budget of 9 restores the newest
    and runs to step 8 (the step left over warns), never past the budget,
    its saves on multiples of 2 as well."""
    from torched_impala_tpu_torch.resilience.chaos import ChaosError

    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps([{"kind": "crash_learner", "at": 3}]))
    ckpt = tmp_path / "ckpt"
    flags = (f" --steps-per-dispatch 2 --checkpoint-dir {ckpt} --async-checkpoint "
             "--checkpoint-interval 2")

    def argv(total):
        return (run.CPU_EXAMPLE.replace("--total-steps 3", f"--total-steps {total}") + flags).split()

    with pytest.raises(ChaosError, match="step 6"):
        run.main(argv(8) + ["--chaos-plan", str(plan)])
    saved = recovery.list_manifest_steps(str(ckpt))
    # A save that finds the writer busy is skipped, never moved.
    assert saved and 2 in saved and set(saved) <= {2, 4, 6}
    with pytest.warns(UserWarning, match="the final 1 step"):
        assert run.main(argv(9) + ["--resume"]) == 0
    captured = capsys.readouterr()
    assert f"[resume] manifest @ step {saved[-1]}" in captured.err
    assert "done: steps=8" in captured.out
    resumed = recovery.list_manifest_steps(str(ckpt))
    assert resumed[-1] == 8 and all(step % 2 == 0 for step in resumed)
