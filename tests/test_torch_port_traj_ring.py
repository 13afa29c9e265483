"""The port's trajectory ring (torched_impala_tpu_torch/runtime/traj_ring.py)
against the JAX package's, on the CPU.

- Identical block writes into both rings give bit-identical ready slots
  (the port's batch tuple has no task column; JAX's `task` is skipped),
  the same batch param version and per-block versions; slot shapes equal
  JAX's `alloc_stack_buffers` and the port's.
- A ring batch equals the queue batch bit for bit, through the real
  `VectorActor` and `Learner` batcher, for the MLP and the LSTM core, and
  across more batches than slots (the CPU batcher stages each batch
  through an owning copy, so a recycled slot cannot overwrite it).
- Ring batches trained at grad_accum=2 take the queue feed's full-batch
  steps.
- The contracts: a stale commit raises after its slot recycled, an
  aborted block recycles its slot without delivering it, a torn slot is
  discarded, `acquire` blocks until a release and `close` wakes it.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from torched_impala_tpu.runtime.learner import alloc_stack_buffers as jax_alloc_stack_buffers
from torched_impala_tpu.runtime.traj_ring import TrajectoryRing as JaxRing
from torched_impala_tpu.runtime.types import Trajectory as JaxTrajectory
from torched_impala_tpu_torch import configs
from torched_impala_tpu_torch.envs.fake import ScriptedEnv
from torched_impala_tpu_torch.runtime.learner import Learner, alloc_stack_buffers
from torched_impala_tpu_torch.runtime.traj_ring import TrajectoryRing
from torched_impala_tpu_torch.runtime.types import QueueClosed, Trajectory
from torched_impala_tpu_torch.runtime.vector_actor import VectorActor

STATE = (np.zeros((1, 8), np.float32), np.zeros((1, 8), np.float32))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ring(T=3, B=4, obs_shape=(4,), num_actions=2, num_slots=2, state=()):
    return TrajectoryRing(
        num_slots=num_slots, unroll_length=T, batch_size=B,
        example_obs=np.zeros(obs_shape, np.float32), num_actions=num_actions,
        agent_state_example=tuple(torch.from_numpy(x) for x in state),
    )


def _write(block, rng):
    """Fill a block's views with random data; returns what was written."""
    data = dict(
        obs=rng.normal(size=block.obs.shape).astype(np.float32),
        first=rng.uniform(size=block.first.shape) < 0.3,
        actions=rng.integers(0, 6, size=block.actions.shape).astype(np.int32),
        behaviour_logits=rng.normal(size=block.behaviour_logits.shape).astype(np.float32),
        rewards=rng.normal(size=block.rewards.shape).astype(np.float32),
        cont=(rng.uniform(size=block.cont.shape) < 0.9).astype(np.float32),
        agent_state=tuple(rng.normal(size=x.shape).astype(np.float32) for x in block.agent_state),
    )
    for key, value in data.items():
        if key == "agent_state":
            for dst, src in zip(block.agent_state, value):
                dst[...] = src
        else:
            getattr(block, key)[...] = value
    return data


def test_ready_slot_matches_jax_ring_on_identical_writes():
    T, B, A = 5, 4, 6
    port = _ring(T=T, B=B, num_actions=A, state=STATE)
    ref = JaxRing(num_slots=2, unroll_length=T, batch_size=B,
                  example_obs=np.zeros((4,), np.float32), num_actions=A,
                  agent_state_example=STATE)
    for version in (40, 31):
        block, ref_block = port.acquire(2), ref.acquire(2)
        _write(block, np.random.default_rng(version))
        _write(ref_block, np.random.default_rng(version))
        port.commit(block, version)
        ref.commit(ref_block, version)
    got, want = port.pop_ready(timeout=1.0), ref.pop_ready(timeout=1.0)
    # JAX's batch tuple carries the task column at index 6.
    for a, b in zip(got.tensors[:6], want.arrays[:6]):
        assert a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(got.tensors[6], want.arrays[7]):
        np.testing.assert_array_equal(a.numpy(), b)
    assert (got.param_version, got.versions) == (want.param_version, want.versions)
    assert got.versions == (40, 31) and got.param_version == 31


def _trajs(T, B, obs_shape, A, state):
    return [
        Trajectory(
            obs=np.zeros((T + 1,) + obs_shape, np.uint8), first=np.zeros((T + 1,), np.bool_),
            actions=np.zeros((T,), np.int32), behaviour_logits=np.zeros((T, A), np.float32),
            rewards=np.zeros((T,), np.float32), cont=np.zeros((T,), np.float32),
            agent_state=state,
        )
        for _ in range(B)
    ]


def test_slot_shapes_are_the_stack_buffers():
    T, B, A, obs_shape = 5, 3, 6, (84, 84, 4)
    ring = TrajectoryRing(num_slots=2, unroll_length=T, batch_size=B,
                          example_obs=np.zeros(obs_shape, np.uint8), num_actions=A,
                          agent_state_example=tuple(torch.from_numpy(x) for x in STATE))
    trajs = _trajs(T, B, obs_shape, A, STATE)
    port = alloc_stack_buffers(trajs)
    ref = jax_alloc_stack_buffers([JaxTrajectory(*t[:7]) for t in trajs])
    slot = ring._slots[0].arrays
    for got, mine, want in zip(slot[:6], port[:6], ref[:6]):
        assert got.shape == mine.shape == want.shape
        assert got.dtype == mine.dtype == want.dtype
    for got, mine, want in zip(slot.agent_state, port.agent_state, ref.agent_state):
        assert got.shape == mine.shape == want.shape == (B, 8)
    assert ring.validate_env_spec(np.zeros(obs_shape, np.uint8), A) == []
    problems = ring.validate_env_spec(np.zeros((84, 84, 3), np.float32), 4)
    assert len(problems) == 3  # obs shape, obs dtype, logits shape


def _drain(use_ring, use_lstm, batches=3, T=5, E=2, B=4):
    """`batches` device batches through the real actor and batcher."""
    cfg = dataclasses.replace(configs.CARTPOLE, use_lstm=use_lstm, lstm_size=8,
                              unroll_length=T, batch_size=B, traj_ring=use_ring)
    agent = configs.make_agent(cfg, seed=2)
    learner = Learner(
        agent=agent, optimizer=configs.make_optimizer(cfg),
        config=configs.make_learner_config(cfg), device=torch.device("cpu"),
        example_obs=np.zeros((4,), np.float32),
    )
    actor = VectorActor(
        actor_id=0, envs=[ScriptedEnv(episode_len=4) for _ in range(E)], agent=agent,
        param_store=learner.param_store, enqueue=learner.enqueue, unroll_length=T,
        device=torch.device("cpu"), seed=3, traj_ring=learner.traj_ring,
    )
    learner.start()
    out = []
    try:
        for _ in range(batches):
            for _ in range(B // E):
                actor.unroll_and_push()
            arrays, version, event, donated = learner._batch_q.get(timeout=60)
            assert donated is None  # donate_batch is off
            assert event is None  # no side stream on the CPU
            out.append((arrays, version))
    finally:
        learner.stop()
        learner.join()
    return out


@pytest.mark.parametrize("use_lstm", [False, True], ids=["mlp", "lstm"])
def test_ring_batches_bit_identical_to_queue_batches(use_lstm):
    """Five batches through a ring of four slots: every slot recycles, and
    no queued batch sees a later slot's writes."""
    queue_batches = _drain(False, use_lstm, batches=5)
    ring_batches = _drain(True, use_lstm, batches=5)
    assert len(queue_batches) == len(ring_batches) == 5
    for (bq, vq), (br, vr) in zip(queue_batches, ring_batches):
        assert vq == vr
        for a, b in zip(bq[:6], br[:6]):
            assert a.dtype == b.dtype
            assert torch.equal(a, b)
        assert len(bq[6]) == len(br[6]) == (2 if use_lstm else 0)
        for a, b in zip(bq[6], br[6]):
            assert torch.equal(a, b)


def _train(use_ring, grad_accum, steps=2, T=5, E=2, B=4):
    """`steps` learner steps of the LSTM net on batches from the real actor,
    through the ring or the queue feed; the params before and after."""
    cfg = dataclasses.replace(configs.CARTPOLE, use_lstm=True, lstm_size=8,
                              unroll_length=T, batch_size=B, traj_ring=use_ring)
    agent = configs.make_agent(cfg, seed=2)
    learner = Learner(
        agent=agent, optimizer=configs.make_optimizer(cfg),
        config=dataclasses.replace(configs.make_learner_config(cfg), grad_accum=grad_accum),
        device=torch.device("cpu"), example_obs=np.zeros((4,), np.float32),
    )
    before = {k: v.detach().clone() for k, v in learner.params.items()}
    actor = VectorActor(
        actor_id=0, envs=[ScriptedEnv(episode_len=4) for _ in range(E)], agent=agent.clone(),
        param_store=learner.param_store, enqueue=learner.enqueue, unroll_length=T,
        device=torch.device("cpu"), seed=3, traj_ring=learner.traj_ring,
    )
    learner.start()
    try:
        for _ in range(steps):
            for _ in range(B // E):
                actor.unroll_and_push()
            learner.step_once(timeout=60)
    finally:
        learner.stop()
        learner.join()
    return before, {k: v.detach().clone() for k, v in learner.params.items()}


def test_ring_feed_composes_with_grad_accum():
    """Ring batches split into two microbatches (their LSTM start states
    too) take the queue feed's full-batch steps. f32 grads summed in
    another order, which RMSProp's per-element normalization magnifies
    where a grad is near 0: the relative L2 distance of the two runs'
    param changes within 1e-5, and the runs' ring and queue batches the
    same (test_ring_batches_bit_identical_to_queue_batches)."""
    before, want = _train(False, 1)
    _, got = _train(True, 2)
    num = sum(float(((got[k] - want[k]).double() ** 2).sum()) for k in want)
    den = sum(float(((want[k] - before[k]).double() ** 2).sum()) for k in want)
    assert den > 0 and (num / den) ** 0.5 <= 1e-5


def test_stale_commit_raises_after_recycle():
    ring = _ring(B=2)
    block = ring.acquire(2)
    ring.commit(block, 1)
    view = ring.pop_ready(timeout=1.0)
    ring.release(view.slot)
    with pytest.raises(RuntimeError, match="stale ring block"):
        ring.commit(block, 2)
    ring.abort(block)  # a stale abort is ignored


def test_abort_recycles_slot_without_delivering():
    ring = _ring(B=4)
    good, bad = ring.acquire(2), ring.acquire(2)
    ring.commit(good, 1)
    ring.abort(bad)
    assert ring.pop_ready(timeout=0.05) is None
    assert sorted(ring._free) == [0, 1]
    with pytest.raises(RuntimeError, match="stale"):
        ring.commit(good, 1)


def test_discard_torn_reclaims_a_half_committed_slot():
    ring = _ring(B=4)
    assert ring.discard_torn() == 0
    kept = ring.acquire(2)
    ring.acquire(2)  # its writer dies without committing or aborting
    ring.commit(kept, 1)
    assert ring.discard_torn() == 1
    assert ring.discard_torn() == 0
    with pytest.raises(RuntimeError, match="stale"):
        ring.commit(kept, 1)
    block = ring.acquire(4)  # the free list is whole again
    ring.commit(block, 2)
    assert ring.pop_ready(timeout=1.0).versions == (2,)


def test_acquire_blocks_until_release_and_close_wakes():
    ring = _ring(B=2, num_slots=2)
    for version in (1, 2):
        ring.commit(ring.acquire(2), version)
    got = []

    def writer():
        try:
            got.append(ring.acquire(2))
        except QueueClosed:
            got.append("closed")

    th = threading.Thread(target=writer)
    th.start()
    time.sleep(0.2)
    assert got == []  # both slots are ready, none free
    ring.release(ring.pop_ready(timeout=1.0).slot)
    th.join(timeout=5)
    assert not th.is_alive() and len(got) == 1 and got[0] != "closed"
    th = threading.Thread(target=writer)
    th.start()
    time.sleep(0.1)
    ring.close()
    th.join(timeout=5)
    assert not th.is_alive() and got[-1] == "closed"
    assert ring.pop_ready(timeout=1.0) is not None  # a ready slot still drains
    with pytest.raises(ValueError, match="divide"):
        ring.acquire(3)
