"""The transformer slice of the PyTorch port held against the JAX package.

Narrow shapes (d_model 32, 2 layers, 2 heads, window 16, T 8, B 4),
flax-initialised params carried across by `params_from_jax`:

- `rotary` against JAX;
- `TransformerCore` (einsum and kernel branches; the kernel branch runs
  its plain versions on the CPU) against the JAX core with
  `dense_kernel="einsum"` over two chained unrolls, the second reading a
  warm cache, with `first` resets in both: outputs, all six state leaves
  and the parameter gradients at rtol 1e-4, atol 1e-5 (f32; sums in
  another order);
- `dense_kernel="pallas"` (the JAX config's spelling) at 4 heads, dh 8,
  against the JAX core running its Pallas kernel in interpret mode;
- the kernel branch against the einsum branch, step mode against unroll
  mode, and `ImpalaNet(core="transformer")` against the JAX net;
- the GELU and LayerNorm-epsilon hazards: the flax choice matches, the
  torch default misses;
- the learner over 3 SGD steps against the JAX `Learner`, fused epilogue
  off and on, from non-zero transformer start states: logs rtol 1e-4,
  atol 1e-5, as tests/test_torch_port_learner.py; params rtol 1e-4 and
  atol 1e-5 where that file has 1e-6. Through two LayerNorms and the
  softmax some gradient elements of ~1e-3 are sums of terms of order 1,
  and carry the f32 noise of the whole gradient (measured: up to 4.9e-6
  against JAX at a largest element of 5.0); RMSProp's first step
  multiplies such an error by lr / sqrt(eps) = 1.9, past 1e-6;
- `loop.train`, the CLI and the preset of `pong_transformer`.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torched_impala_tpu.models import Agent as JaxAgent
from torched_impala_tpu.models import ImpalaNet as JaxNet
from torched_impala_tpu.models import MLPTorso as JaxMLP
from torched_impala_tpu.models.transformer import TransformerCore as JaxCore
from torched_impala_tpu.models.transformer import TransformerCoreState as JaxState
from torched_impala_tpu.models.transformer import rotary as jax_rotary
from torched_impala_tpu.ops import ImpalaLossConfig as JaxLossConfig
from torched_impala_tpu.runtime import Learner as JaxLearner
from torched_impala_tpu.runtime import LearnerConfig as JaxLearnerConfig
from torched_impala_tpu.runtime import Trajectory as JaxTrajectory
from torched_impala_tpu_torch import configs, run
from torched_impala_tpu_torch.models import transformer as port_transformer
from torched_impala_tpu_torch.models.agent import Agent
from torched_impala_tpu_torch.models.convert import params_from_jax
from torched_impala_tpu_torch.models.nets import ImpalaNet
from torched_impala_tpu_torch.models.torsos import MLPTorso
from torched_impala_tpu_torch.models.transformer import TransformerCore, TransformerCoreState
from torched_impala_tpu_torch.ops import attention, attention_cuda, fused_loss_cuda, losses
from torched_impala_tpu_torch.optim import RMSProp
from torched_impala_tpu_torch.runtime import loop
from torched_impala_tpu_torch.runtime.learner import Learner, LearnerConfig
from torched_impala_tpu_torch.runtime.learner import stack_trajectories
from torched_impala_tpu_torch.runtime.types import Trajectory

D, L, H, W, T, B, F_IN, A = 32, 2, 2, 16, 8, 4, 12, 3
CORE = dict(d_model=D, num_layers=L, num_heads=H, window=W)
TOL = dict(rtol=1e-4, atol=1e-5)
LR, DECAY, EPS = 6e-4, 0.99, 1e-7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _unrolls(seed, scale=1.0):
    """Two chained unrolls' features `[T, B, F]` and `first` flags."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        feat = (rng.normal(size=(T, B, F_IN)) * scale).astype(np.float32)
        first = rng.uniform(size=(T, B)) < 0.2
        first[3, 1] = True  # a reset in the middle of the unroll
        out.append((feat, first))
    return out


@pytest.fixture(scope="module")
def jax_core():
    core = JaxCore(dense_kernel="einsum", **CORE)
    (feat, first), _ = _unrolls(0)
    params = core.init(jax.random.key(0), jnp.asarray(feat), jnp.asarray(first), core.initial_state(B))
    return core, jax.tree.map(np.asarray, params)


def _port_core(params, dense_kernel="einsum", dtype="float32", **core_kw):
    core = TransformerCore(F_IN, dense_kernel=dense_kernel, dtype=dtype, **dict(CORE, **core_kw))
    state = params_from_jax({"transformer": params["params"]})
    core.load_state_dict({k.removeprefix("transformer."): v for k, v in state.items()})
    return core


def _weights(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(T, B, D)).astype(np.float32) for _ in range(2)]


def _jax_run(core, params, unrolls, weights):
    """Outputs, end state and param grads of sum(out * w) over the chained
    unrolls, through one jitted JAX function."""

    @jax.jit
    def run(p, unrolls, weights):
        def loss(p):
            state, total, outs = core.initial_state(B), 0.0, []
            for (feat, first), w in zip(unrolls, weights):
                out, state = core.apply(p, feat, first, state)
                total = total + jnp.sum(out * w)
                outs.append(out)
            return total, (outs, state)

        (_, aux), grads = jax.value_and_grad(loss, has_aux=True)(p)
        return aux, grads

    (outs, state), grads = run(params, unrolls, weights)
    return outs, state, grads


def _port_run(core, unrolls, weights):
    state, total, outs = core.initial_state(B), 0.0, []
    for (feat, first), w in zip(unrolls, weights):
        out, state = core(torch.from_numpy(feat), torch.from_numpy(first), state)
        total = total + (out * torch.from_numpy(w)).sum()
        outs.append(out)
    names = [n for n, _ in core.named_parameters()]
    grads = torch.autograd.grad(total, [p for _, p in core.named_parameters()])
    return outs, state, dict(zip(names, grads))


def test_rotary_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 2, 16)).astype(np.float32)
    pos = rng.integers(0, 500, size=(3, 5)).astype(np.int32)
    want = np.asarray(jax_rotary(jnp.asarray(x), jnp.asarray(pos)))
    got = port_transformer.rotary(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # Half/half split: rotating position 0 is the identity.
    same = port_transformer.rotary(torch.from_numpy(x), torch.zeros(3, 5, dtype=torch.int32))
    torch.testing.assert_close(same, torch.from_numpy(x))


@pytest.fixture(scope="module")
def jax_two_unrolls(jax_core):
    core, params = jax_core
    unrolls, weights = _unrolls(1), _weights(2)
    return unrolls, weights, _jax_run(core, params, unrolls, weights)


@pytest.mark.parametrize("dense_kernel", ["einsum", "kernel"])
def test_core_matches_jax_over_two_unrolls(jax_core, jax_two_unrolls, dense_kernel):
    _, params = jax_core
    unrolls, weights, (j_outs, j_state, j_grads) = jax_two_unrolls
    p_outs, p_state, p_grads = _port_run(_port_core(params, dense_kernel), unrolls, weights)
    for p, j in zip(p_outs, j_outs):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), **TOL)
    assert isinstance(p_state, TransformerCoreState)
    for name, p, j in zip(JaxState._fields, p_state, j_state):
        assert p.dtype == (torch.float32 if "cache" in name else torch.int32), name
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), **TOL, err_msg=name)
    want = params_from_jax({"transformer": jax.tree.map(np.asarray, j_grads["params"])})
    assert set(want) == {f"transformer.{n}" for n in p_grads}
    for name, g in p_grads.items():
        np.testing.assert_allclose(g.numpy(), want[f"transformer.{name}"].numpy(), **TOL, err_msg=name)


def test_pallas_spelling_runs_the_kernel_branch_at_dh_8(monkeypatch):
    """dense_kernel="pallas", the JAX config's value, selects the kernel
    branch. At d_model 32 with 4 heads (dh = 8, which the CUDA kernels
    run zero-padded to 16) the port's core matches the JAX core running
    its Pallas kernel (interpret mode) over two chained unrolls: outputs,
    state and parameter gradients."""
    heads = 4
    jcore = JaxCore(dense_kernel="pallas", **dict(CORE, num_heads=heads))
    (feat, first), _ = _unrolls(0)
    params = jcore.init(jax.random.key(3), jnp.asarray(feat), jnp.asarray(first), jcore.initial_state(B))
    params = jax.tree.map(np.asarray, params)
    unrolls, weights = _unrolls(11), _weights(12)
    j_outs, j_state, j_grads = _jax_run(jcore, params, unrolls, weights)
    calls = []

    def counted(*args):
        calls.append(args[0].shape)
        return attention.windowed_attention(*args)

    monkeypatch.setattr(port_transformer, "windowed_attention", counted)
    core = _port_core(params, "pallas", num_heads=heads)
    assert core.dense_kernel == "kernel"
    p_outs, p_state, p_grads = _port_run(core, unrolls, weights)
    # Two unrolls x two layers, each at the true head width.
    assert calls == [(B, T, heads, D // heads)] * 4
    for p, j in zip((*p_outs, *p_state), (*j_outs, *j_state)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), **TOL)
    want = params_from_jax({"transformer": jax.tree.map(np.asarray, j_grads["params"])})
    for name, g in p_grads.items():
        np.testing.assert_allclose(g.numpy(), want[f"transformer.{name}"].numpy(), **TOL, err_msg=name)


def test_kernel_branch_matches_einsum_branch(jax_core):
    _, params = jax_core
    unrolls, weights = _unrolls(3), _weights(4)
    e_outs, e_state, e_grads = _port_run(_port_core(params, "einsum"), unrolls, weights)
    k_outs, k_state, k_grads = _port_run(_port_core(params, "kernel"), unrolls, weights)
    for a, b in zip((*k_outs, *k_state), (*e_outs, *e_state)):
        torch.testing.assert_close(a, b, **TOL)
    for name in e_grads:
        torch.testing.assert_close(k_grads[name], e_grads[name], **TOL)


def test_step_mode_matches_unroll_mode(jax_core):
    _, params = jax_core
    core = _port_core(params, "kernel")
    (feat, first), _ = _unrolls(5)
    with torch.no_grad():
        unrolled, end = core(torch.from_numpy(feat), torch.from_numpy(first), core.initial_state(B))
        state = core.initial_state(B)
        for t in range(T):
            out, state = core(torch.from_numpy(feat[t : t + 1]), torch.from_numpy(first[t : t + 1]), state)
            torch.testing.assert_close(out[0], unrolled[t], **TOL)
    for a, b in zip(state, end):
        torch.testing.assert_close(a, b, **TOL)


def test_bf16_core_keeps_f32_state_and_tracks_f32(jax_core):
    """transformer_dtype='bfloat16': matmuls in bf16, the output and the
    KV-cache state f32; both branches agree, and the output stays within
    bf16 rounding (atol 5e-2, as the bf16 torso's gate) of the f32 core."""
    _, params = jax_core
    unrolls = _unrolls(10)
    outs = {}
    for dtype in ("float32", "bfloat16"):
        for kernel in ("einsum", "kernel"):
            core = _port_core(params, kernel, dtype)
            with torch.no_grad():
                state = core.initial_state(B)
                for feat, first in unrolls:
                    out, state = core(torch.from_numpy(feat), torch.from_numpy(first), state)
            assert out.dtype == state.k_cache.dtype == torch.float32
            outs[dtype, kernel] = out
    torch.testing.assert_close(outs["bfloat16", "kernel"], outs["bfloat16", "einsum"], rtol=0, atol=1e-2)
    torch.testing.assert_close(outs["bfloat16", "einsum"], outs["float32", "einsum"], rtol=0, atol=5e-2)


def test_initial_state_layout():
    core = TransformerCore(F_IN, **CORE)
    s = core.initial_state(5)
    assert s.k_cache.shape == s.v_cache.shape == (5, L, W, D)
    assert s.k_cache.dtype == torch.float32
    assert s.kv_seg.shape == s.kv_pos.shape == (5, W) and s.pos.shape == s.seg.shape == (5,)
    assert all(x.dtype == torch.int32 for x in s[2:])
    assert int(s.kv_seg.max()) == -1


def _jax_net():
    return JaxNet(num_actions=A, torso=JaxMLP(hidden_sizes=(16, 16)), core="transformer",
                  transformer=tuple(CORE.items()))


def _port_net(dense_kernel="einsum"):
    return ImpalaNet(A, MLPTorso(4, (16, 16)), core="transformer",
                     transformer=dict(CORE, dense_kernel=dense_kernel))


def test_net_matches_jax_net():
    agent = JaxAgent(_jax_net())
    params = jax.tree.map(np.asarray, agent.init_params(jax.random.key(1), np.zeros((4,), np.float32)))
    rng = np.random.default_rng(6)
    obs = rng.normal(size=(T, B, 4)).astype(np.float32)
    first = rng.uniform(size=(T, B)) < 0.25
    jout, jstate = agent.unroll(params, jnp.asarray(obs), jnp.asarray(first), agent.initial_state(B))
    net = _port_net("kernel")
    net.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        pout, pstate = Agent(net).unroll(torch.from_numpy(obs), torch.from_numpy(first), net.initial_state(B))
    np.testing.assert_allclose(pout.policy_logits.numpy(), np.asarray(jout.policy_logits), **TOL)
    np.testing.assert_allclose(pout.values.numpy(), np.asarray(jout.values), **TOL)
    for p, j in zip(pstate, jstate):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), **TOL)


def _core_error(jax_core, unrolls):
    """Largest |port - JAX| of the core's outputs over the two unrolls."""
    jcore, params = jax_core
    apply = jax.jit(jcore.apply)
    with torch.no_grad():
        core = _port_core(params)
        j_state, p_state = jcore.initial_state(B), core.initial_state(B)
        err = 0.0
        for feat, first in unrolls:
            j_out, j_state = apply(params, feat, first, j_state)
            out, p_state = core(torch.from_numpy(feat), torch.from_numpy(first), p_state)
            err = max(err, float(np.abs(out.numpy() - np.asarray(j_out)).max()))
    return err


def test_gelu_hazard_tanh_matches_exact_misses(jax_core, monkeypatch):
    """flax's nn.gelu is the tanh approximation; torch's default (exact)
    misses the JAX core by far more than the tolerance."""
    unrolls = _unrolls(8)
    assert _core_error(jax_core, unrolls) < TOL["atol"] * 10
    exact = torch.nn.functional.gelu
    monkeypatch.setattr(port_transformer.F, "gelu", lambda x, approximate="none": exact(x))
    assert _core_error(jax_core, unrolls) > 1e-4


def test_layernorm_eps_hazard(jax_core, monkeypatch):
    """flax LayerNorm's epsilon is 1e-6; torch's default 1e-5 misses on
    activations of small variance (features scaled by 1e-3)."""
    unrolls = _unrolls(9, scale=1e-3)
    assert port_transformer.LN_EPS == 1e-6
    assert _core_error(jax_core, unrolls) < TOL["atol"] * 10
    monkeypatch.setattr(port_transformer, "LN_EPS", 1e-5)
    assert _core_error(jax_core, unrolls) > 1e-2


def _start_state(rng):
    """A non-zero transformer start state of batch 1 (numpy leaves): a
    random cache whose slots are of this episode, an older one or empty."""
    seg = rng.integers(1, 3)
    return (
        (rng.normal(size=(1, L, W, D)) * 0.5).astype(np.float32),
        (rng.normal(size=(1, L, W, D)) * 0.5).astype(np.float32),
        rng.choice([-1, seg - 1, seg], size=(1, W)).astype(np.int32),
        np.sort(rng.integers(0, 40, size=(1, W))).astype(np.int32),
        np.array([40 + rng.integers(0, 5)], np.int32),
        np.array([seg], np.int32),
    )


def _learner_arrays(Tu, Bu, round_idx):
    out = []
    for b in range(Bu):
        rng = np.random.default_rng(500 + 100 * round_idx + b)
        out.append(
            dict(
                obs=rng.normal(size=(Tu + 1, 4)).astype(np.float32),
                first=rng.uniform(size=(Tu + 1,)) < 0.25,
                actions=rng.integers(0, A, size=(Tu,)).astype(np.int32),
                behaviour_logits=rng.normal(size=(Tu, A)).astype(np.float32),
                rewards=rng.normal(size=(Tu,)).astype(np.float32),
                cont=(rng.uniform(size=(Tu,)) > 0.1).astype(np.float32),
                agent_state=_start_state(rng),
            )
        )
    return out


@pytest.mark.parametrize("fused", [False, True], ids=["separate", "fused"])
def test_learner_matches_jax_learner(fused):
    Tu, Bu, steps = 4, 2, 3
    jlearner = JaxLearner(
        agent=JaxAgent(_jax_net()),
        optimizer=optax.rmsprop(LR, decay=DECAY, eps=EPS),
        config=JaxLearnerConfig(
            batch_size=Bu,
            unroll_length=Tu,
            loss=JaxLossConfig(vtrace_implementation="scan", fused_epilogue=fused),
            max_grad_norm=40.0,
            queue_capacity=steps * Bu,
        ),
        example_obs=np.zeros((4,), np.float32),
        rng=jax.random.key(0),
    )
    net = _port_net("kernel")
    net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jlearner.params)))
    learner = Learner(
        agent=Agent(net),
        optimizer=RMSProp(LR, decay=DECAY, eps=EPS),
        config=LearnerConfig(
            batch_size=Bu, unroll_length=Tu, loss=losses.ImpalaLossConfig(fused_epilogue=fused)
        ),
        device=torch.device("cpu"),
    )
    learner.start()
    for r in range(steps):
        for a in _learner_arrays(Tu, Bu, r):
            jlearner.enqueue(JaxTrajectory(**dict(a, agent_state=JaxState(*a["agent_state"]))))
            learner.enqueue(Trajectory(**dict(a, agent_state=TransformerCoreState(*a["agent_state"]))))
    jlearner.start()
    try:
        for step in range(steps):
            jlogs = jlearner.step_once(timeout=300)
            plogs = learner.step_once(timeout=60)
            keys = ["total_loss", "pg_loss", "baseline_loss", "entropy_loss", "grad_norm_unclipped"]
            if fused:
                keys += ["mean_vtrace_target", "mean_advantage"]
            for key in keys:
                np.testing.assert_allclose(
                    float(plogs[key]), float(jlogs[key]), rtol=1e-4, atol=1e-5,
                    err_msg=f"step {step} log {key}",
                )
            want = params_from_jax(jax.tree.map(np.asarray, jlearner.params))
            for name, p in learner.params.items():
                np.testing.assert_allclose(
                    p.detach().numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5,
                    err_msg=f"step {step} param {name}",
                )
    finally:
        jlearner.stop()
        learner.stop()
        learner.join()
    assert learner.num_steps == steps


def test_stack_trajectories_keeps_the_transformer_state():
    arrays = _learner_arrays(2, 3, 0)
    batch = stack_trajectories(
        [Trajectory(**dict(a, agent_state=TransformerCoreState(*a["agent_state"]))) for a in arrays]
    )
    state = batch.agent_state
    assert isinstance(state, TransformerCoreState)
    assert state.k_cache.shape == (3, L, W, D) and state.kv_seg.shape == (3, W)
    assert all(x.dtype == np.int32 for x in state[2:])
    np.testing.assert_array_equal(state.kv_seg[1:2], arrays[1]["agent_state"][2])


def _small_pong_transformer(**kw):
    return dataclasses.replace(
        configs.PONG_TRANSFORMER,
        actor_mode="thread",
        num_actors=2,
        envs_per_actor=2,
        unroll_length=4,
        batch_size=4,
        transformer_d_model=32,
        transformer_heads=2,
        transformer_window=8,
        **kw,
    )


def test_train_pong_transformer_slice_on_cpu():
    cfg = _small_pong_transformer(transformer_dense_kernel="kernel", fused_epilogue=True)
    agent = configs.make_agent(cfg, seed=0)
    assert agent.net.core == "transformer" and agent.net.transformer.dense_kernel == "kernel"
    before = {k: v.detach().clone() for k, v in agent.net.state_dict().items()}
    launches = (fused_loss_cuda.LAUNCHES, dict(attention_cuda.LAUNCHES))
    result = loop.train(
        agent=agent,
        env_factory=configs.make_env_factory(cfg, fake=True),
        num_actors=cfg.num_actors,
        envs_per_actor=cfg.envs_per_actor,
        learner_config=configs.make_learner_config(cfg),
        optimizer=configs.make_optimizer(cfg),
        total_steps=2,
        device="cpu",
        log_every=1,
    )
    assert result.learner.num_steps == 2
    assert math.isfinite(result.final_logs["total_loss"])
    assert "mean_vtrace_target" in result.final_logs  # the fused epilogue ran
    moved = [not torch.equal(before[k], v.detach()) for k, v in agent.net.state_dict().items()]
    assert all(moved)
    # The CPU run takes the plain versions: no kernel launched.
    assert (fused_loss_cuda.LAUNCHES, attention_cuda.LAUNCHES) == launches


def test_pong_transformer_cli_returns_zero(capsys):
    """The pong_transformer CPU command of README.md (--fused-epilogue)."""
    from pathlib import Path

    readme = " ".join(
        (Path(__file__).resolve().parents[1] / "README.md").read_text().replace("\\\n", " ").split()
    )
    assert f"python -m torched_impala_tpu_torch.run {run.PONG_TRANSFORMER_CPU_EXAMPLE}" in readme
    assert "--fused-epilogue" in run.PONG_TRANSFORMER_CPU_EXAMPLE
    rc = run.main(run.PONG_TRANSFORMER_CPU_EXAMPLE.split())
    assert rc == 0
    assert "done: steps=3" in capsys.readouterr().out


def test_pong_transformer_preset_keeps_the_jax_values():
    from torched_impala_tpu import configs as jax_configs

    ours, theirs = configs.PONG_TRANSFORMER, jax_configs.PONG_TRANSFORMER
    for field in dataclasses.fields(ours):
        assert getattr(ours, field.name) == getattr(theirs, field.name), field.name
    agent = configs.make_agent(ours)
    core = agent.net.transformer
    assert (core.d_model, core.num_layers, core.num_heads, core.window) == (256, 2, 4, 128)
    assert core.dtype == torch.float32


def test_dense_kernel_resolution(monkeypatch):
    cfg = configs.PONG_TRANSFORMER
    assert configs.resolve_dense_kernel(dataclasses.replace(cfg, transformer_dense_kernel="kernel")) == "kernel"
    assert configs.resolve_dense_kernel(dataclasses.replace(cfg, transformer_dense_kernel="einsum")) == "einsum"
    # 'auto' never picks the kernel without a card; with one, by the
    # learner's score matrix (T + 1) x (W + T + 1).
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert configs.resolve_dense_kernel(cfg) == "einsum"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    score = (cfg.unroll_length + 1) * (cfg.transformer_window + cfg.unroll_length + 1)
    want = "kernel" if score >= configs.KERNEL_MIN_SCORE_ELEMS else "einsum"
    assert configs.resolve_dense_kernel(cfg) == want
    # The JAX package's spelling of the kernel branch means the same here.
    assert configs.resolve_dense_kernel(dataclasses.replace(cfg, transformer_dense_kernel="pallas")) == "kernel"
    with pytest.raises(ValueError, match="transformer_dense_kernel"):
        configs.resolve_dense_kernel(dataclasses.replace(cfg, transformer_dense_kernel="flash"))
