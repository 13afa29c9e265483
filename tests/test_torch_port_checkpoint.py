"""The port's checkpoint files (torched_impala_tpu_torch/utils/checkpoint.py)
held against the JAX package's (torched_impala_tpu/utils/checkpoint.py).

Each case drives the same scenario through both modules on the CPU and
compares the outcomes: a round trip of the same values, a truncated
file, bit rot caught by the zip CRCs, a missing entry named, a shape
refused, the tmp file removed after a failed write, the mismatch report
(at most 8 entries, then a count), and the synchronous Checkpointer's
save policy and retention against JAX's orbax-backed one.
"""

import numpy as np
import pytest
import torch

from torched_impala_tpu.resilience.chaos import corrupt_file as jax_corrupt_file
from torched_impala_tpu.utils import checkpoint as jax_ck
from torched_impala_tpu_torch.resilience.chaos import corrupt_file
from torched_impala_tpu_torch.utils import checkpoint as ck


def _values(seed=0.0):
    rng = np.random.default_rng(int(seed))
    return {
        "params": {
            "dense": {"kernel": rng.normal(size=(4, 3)).astype(np.float32) + seed},
            "bias": np.arange(3.0, dtype=np.float32) + seed,
        },
        "num_frames": 480,
        "num_steps": 3,
    }


def _jax_state(v):
    return {
        "params": v["params"],
        "num_frames": np.asarray(v["num_frames"], np.int64),
        "num_steps": np.asarray(v["num_steps"], np.int64),
    }


def _port_state(v):
    return {
        "params": {
            "dense": {"kernel": torch.from_numpy(v["params"]["dense"]["kernel"].copy())},
            "bias": torch.from_numpy(v["params"]["bias"].copy()),
        },
        "num_frames": v["num_frames"],
        "num_steps": v["num_steps"],
    }


def _both(tmp_path, values):
    """The same values saved by each package; returns the two paths."""
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_ck.save_state_file(jpath, _jax_state(values))
    ck.save_state_file(ppath, _port_state(values))
    return jpath, ppath


def test_round_trip_matches_jax(tmp_path):
    v = _values(2.0)
    jpath, ppath = _both(tmp_path, v)
    jgot = jax_ck.load_state_file(jpath, _jax_state(_values()))
    got = ck.load_state_file(ppath, _port_state(_values()))
    for leaf in ("kernel", "bias"):
        want = v["params"]["dense"]["kernel"] if leaf == "kernel" else v["params"]["bias"]
        jleaf = jgot["params"]["dense"][leaf] if leaf == "kernel" else jgot["params"][leaf]
        pleaf = got["params"]["dense"][leaf] if leaf == "kernel" else got["params"][leaf]
        assert isinstance(pleaf, torch.Tensor) and pleaf.dtype == torch.float32
        np.testing.assert_array_equal(pleaf.numpy(), np.asarray(jleaf))
        np.testing.assert_array_equal(pleaf.numpy(), want)
    assert got["num_frames"] == int(jgot["num_frames"]) == 480
    assert isinstance(got["num_steps"], int) and got["num_steps"] == 3
    with np.load(ppath, allow_pickle=False) as data:
        assert sorted(data.files) == [
            "num_frames", "num_steps", "params/bias", "params/dense/kernel",
        ]
    assert not [p for p in tmp_path.iterdir() if ".tmp." in p.name]


@pytest.mark.parametrize("damage", ["truncated", "bit_rot"])
def test_damaged_file_raises_corrupt_error_like_jax(tmp_path, damage):
    jpath, ppath = _both(tmp_path, _values(1.0))
    for path, corrupt in ((jpath, jax_corrupt_file), (ppath, corrupt_file)):
        if damage == "truncated":
            data = open(path, "rb").read()
            open(path, "wb").write(data[: len(data) // 2])
        else:
            corrupt(path)
    with pytest.raises(jax_ck.CheckpointCorruptError) as jinfo:
        jax_ck.load_state_file(jpath, _jax_state(_values()))
    with pytest.raises(ck.CheckpointCorruptError) as info:
        ck.load_state_file(ppath, _port_state(_values()))
    for e, path in ((jinfo.value, jpath), (info.value, ppath)):
        assert path in str(e) and "corrupt or truncated" in str(e)


def test_missing_entry_is_named_like_jax(tmp_path):
    v = _values()
    target = dict(v, extra=np.zeros(2, np.float32))
    jpath, ppath = _both(tmp_path, v)
    with pytest.raises(jax_ck.CheckpointCorruptError, match=r"missing entry \"\['extra'\]\""):
        jax_ck.load_state_file(jpath, dict(_jax_state(v), extra=target["extra"]))
    with pytest.raises(ck.CheckpointCorruptError, match="missing entry 'extra'"):
        ck.load_state_file(ppath, dict(_port_state(v), extra=torch.zeros(2)))


def test_shape_mismatch_refused_like_jax(tmp_path):
    v = _values()
    jpath, ppath = _both(tmp_path, v)
    jtarget = _jax_state(v)
    jtarget["params"] = dict(jtarget["params"], bias=np.zeros(4, np.float32))
    target = _port_state(v)
    target["params"]["bias"] = torch.zeros(4)
    with pytest.raises(ValueError, match=r"restored \(3,\) vs live \(4,\)"):
        jax_ck.load_state_file(jpath, jtarget)
    with pytest.raises(ValueError, match=r"params/bias: restored \(3,\) vs live \(4,\)"):
        ck.load_state_file(ppath, target)


def test_failed_write_removes_tmp_like_jax(tmp_path):
    for module, name in ((jax_ck, "jax.bin"), (ck, "port.bin")):
        path = str(tmp_path / name)
        with pytest.raises(TypeError):
            module.atomic_write_bytes(path, object())
        assert not (tmp_path / name).exists()
    assert list(tmp_path.iterdir()) == []


def test_mismatch_report_lists_eight_then_counts_like_jax():
    live = {f"w{i}": np.zeros((2,), np.float32) for i in range(11)}
    restored = {f"w{i}": np.zeros((3,), np.float32) for i in range(10)}
    with pytest.raises(ValueError) as jinfo:
        jax_ck.validate_restored_shapes(restored, live, what="params")
    with pytest.raises(ValueError) as info:
        ck.validate_restored_shapes(
            {k: torch.zeros(3) for k in restored}, {k: torch.zeros(2) for k in live},
            what="params",
        )
    # Sorted names: w0, w1, w10 (missing), w2 .. w6 shown; 3 more.
    for e in (jinfo.value, info.value):
        msg = str(e)
        assert "(3 more)" in msg and "Known cause" in msg
        assert msg.count("restored (3,) vs live (2,)") == 7
        assert msg.count("missing from the restored tree") == 1
    assert "w10: missing from the restored tree" in str(info.value)


def test_sync_checkpointer_policy_and_retention_match_jax(tmp_path):
    """Steps 1..5 with max_to_keep=3, a repeat of the newest and an older
    step: the same saves, the same retained steps, the same values."""
    jck = jax_ck.Checkpointer(str(tmp_path / "jax"), max_to_keep=3)
    pck = ck.Checkpointer(str(tmp_path / "port"), max_to_keep=3)
    assert pck.restore(_port_state(_values())) is None
    jsaved, psaved = [], []
    for step in (1, 2, 3, 4, 5, 5, 2):
        v = _values(float(step))
        jsaved.append(bool(jck.save(step, _jax_state(v))))
        jck.wait()
        psaved.append(pck.save(step, _port_state(v)))
    assert psaved == jsaved == [True] * 5 + [False, False]
    assert pck.all_steps() == jck.all_steps() == [3, 4, 5]
    assert pck.latest_step() == jck.latest_step() == 5
    jgot = jck.restore(_jax_state(_values()), step=4)
    got = pck.restore(_port_state(_values()), step=4)
    np.testing.assert_array_equal(got["params"]["bias"].numpy(), np.asarray(jgot["params"]["bias"]))
    np.testing.assert_array_equal(got["params"]["bias"].numpy(), _values(4.0)["params"]["bias"])
    jck.close()
    pck.close()
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        f"step-{s:012d}.npz" for s in (3, 4, 5)
    ]


def test_learner_state_round_trip_through_a_file(tmp_path):
    """A port learner's `get_state()` through a file into a fresh learner:
    the entry names of the module docstring, and every value back."""
    from torched_impala_tpu_torch.models.agent import Agent
    from torched_impala_tpu_torch.models.nets import ImpalaNet
    from torched_impala_tpu_torch.models.torsos import MLPTorso
    from torched_impala_tpu_torch.optim import RMSProp
    from torched_impala_tpu_torch.runtime.learner import Learner, LearnerConfig

    def learner(seed):
        g = torch.Generator().manual_seed(seed)
        net = ImpalaNet(2, MLPTorso(4, (8,), generator=g), core="lstm", lstm_size=4, generator=g)
        return Learner(agent=Agent(net), optimizer=RMSProp(1e-3),
                       config=LearnerConfig(batch_size=1, unroll_length=2), device="cpu")

    src = learner(0)
    src.num_frames, src.num_steps = 640, 7
    src._optimizer.count = 7
    for v in src._optimizer.nu.values():
        v.uniform_()
    path = str(tmp_path / "s.npz")
    ck.save_state_file(path, src.get_state())
    with np.load(path, allow_pickle=False) as data:
        assert "params/lstm.wi" in data.files and "opt_state/nu/lstm.wi" in data.files
        assert "opt_state/count" in data.files
    dst = learner(1)
    dst.set_state(ck.load_state_file(path, dst.get_state()))
    for name, p in dst.params.items():
        assert torch.equal(p.detach(), src.params[name].detach()), name
    for name, v in dst._optimizer.nu.items():
        assert torch.equal(v, src._optimizer.nu[name]), name
    assert (dst.num_frames, dst.num_steps, dst._optimizer.count) == (640, 7, 7)
    assert dst.param_store.get(timeout=1)[0] == 640
