"""The port's resilience layer held against the JAX package's on the CPU:
run manifests and the recovery scan (resilience/recovery.py), the async
checkpointer (resilience/checkpointer.py), the chaos plans
(resilience/chaos.py), and the crash, resume and target runs through
`loop.train` and the CLI.

Each parity case drives the same scenario through the JAX module and the
port's and compares the outcomes:

- a manifest written by either package is read by the other;
- `restore_latest`: the newest pair, a corrupt newest checkpoint falling
  back one step, every checkpoint corrupt, a config hash refused (also
  past a corrupt newest manifest), host-count turnover; and `prune`;
- `config_fingerprint`: the same hash for the same dict, and the port's
  stable across two interpreters;
- the async cadence by steps and by seconds, skip-when-busy, retention,
  the manifest's version and hash, a writer error: the same saved and
  retained steps;
- chaos: one plan and one event sequence fire the same faults at the same
  site counts; unknown kinds and fields are refused; the four kinds whose
  sites the port lacks raise and name their ROADMAP.md item.

The end-to-end runs: a thread-actor crash (ChaosError) resumed to its
target, a config mismatch refused, `chip_smoke.resume_runs` (the card's
resume phase) at a small process-actor config, and the CLI examples.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torched_impala_tpu.resilience import chaos as jax_chaos
from torched_impala_tpu.resilience import checkpointer as jax_checkpointer
from torched_impala_tpu.resilience import recovery as jax_recovery
from torched_impala_tpu.telemetry import Registry
from torched_impala_tpu.utils import checkpoint as jax_ck
from torched_impala_tpu_torch import configs, run
from torched_impala_tpu_torch.resilience import chaos, recovery
from torched_impala_tpu_torch.resilience.checkpointer import AsyncCheckpointer
from torched_impala_tpu_torch.runtime import loop
from torched_impala_tpu_torch.utils.checkpoint import CheckpointCorruptError

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_state(seed=0.0):
    return {
        "params": {
            "dense": {"kernel": np.full((4, 3), seed, np.float32)},
            "bias": np.arange(3.0, dtype=np.float32) + seed,
        },
        "num_frames": np.asarray(480, np.int64),
        "num_steps": np.asarray(3, np.int64),
    }


def _port_state(seed=0.0):
    return {
        "params": {
            "dense": {"kernel": torch.full((4, 3), seed)},
            "bias": torch.arange(3.0) + seed,
        },
        "num_frames": 480,
        "num_steps": 3,
    }


class _Package:
    """One package's resilience surface, so a scenario runs on both."""

    def __init__(self, name):
        self.name = name
        self.jax = name == "jax"
        self.recovery = jax_recovery if self.jax else recovery
        self.ck = jax_ck if self.jax else __import__(
            "torched_impala_tpu_torch.utils.checkpoint", fromlist=["x"]
        )
        self.corrupt_error = jax_ck.CheckpointCorruptError if self.jax else CheckpointCorruptError
        self.chaos = jax_chaos if self.jax else chaos

    def state(self, seed=0.0):
        return _jax_state(seed) if self.jax else _port_state(seed)

    def bias(self, state):
        return np.asarray(state["params"]["bias"])

    def checkpointer(self, directory, **kwargs):
        if self.jax:
            return jax_checkpointer.AsyncCheckpointer(directory, telemetry=Registry(), **kwargs)
        return AsyncCheckpointer(directory, **kwargs)

    def save_pair(self, directory, step, seed, config_hash=None, host_count=1):
        """A (state, manifest) pair as the async writer leaves it."""
        path = self.recovery.checkpoint_path(directory, step)
        self.ck.save_state_file(path, self.state(seed))
        self.recovery.write_manifest(directory, self.recovery.RunManifest(
            step=step, param_version=step * 10, checkpoint=os.path.basename(path),
            config_hash=config_hash, host_count=host_count,
        ))


BOTH = [_Package("jax"), _Package("port")]


def _each(tmp_path, scenario):
    """`scenario(pkg, directory)` on both packages; their outcomes."""
    return [scenario(pkg, str(tmp_path / pkg.name)) for pkg in BOTH]


def test_manifest_is_read_by_the_other_package(tmp_path):
    for writer, reader in ((recovery, jax_recovery), (jax_recovery, recovery)):
        directory = str(tmp_path / writer.__name__)
        os.makedirs(directory)
        manifest = writer.RunManifest(step=7, param_version=4480, checkpoint="ckpt-000000000007.npz",
                                      config_hash="abc", saved_at=12.5, host_count=1)
        writer.write_manifest(directory, manifest)
        got = reader.load_manifest(reader.manifest_path(directory, 7))
        assert dataclasses.asdict(got) == dataclasses.asdict(manifest)
        latest = json.loads(open(os.path.join(directory, "MANIFEST.json")).read())
        assert latest == json.loads(manifest.to_json())
        assert reader.list_manifest_steps(directory) == [7]


def test_restore_latest_picks_the_newest_like_jax(tmp_path):
    def scenario(pkg, d):
        assert pkg.recovery.restore_latest(d, pkg.state()) is None
        for step in (1, 2, 3):
            pkg.save_pair(d, step, float(step))
        manifest, state = pkg.recovery.restore_latest(d, pkg.state())
        return manifest.step, manifest.param_version, pkg.bias(state).tolist()

    jax_out, port_out = _each(tmp_path, scenario)
    assert port_out == jax_out == (3, 30, [3.0, 4.0, 5.0])


def test_corrupt_newest_falls_back_like_jax(tmp_path, capsys):
    def scenario(pkg, d):
        for step in (1, 2):
            pkg.save_pair(d, step, float(step))
        pkg.chaos.corrupt_file(pkg.recovery.checkpoint_path(d, 2))
        manifest, state = pkg.recovery.restore_latest(d, pkg.state())
        return manifest.step, pkg.bias(state).tolist()

    jax_out, port_out = _each(tmp_path, scenario)
    assert port_out == jax_out == (1, [1.0, 2.0, 3.0])
    assert capsys.readouterr().err.count("step 2 checkpoint unusable, falling back") == 2


def test_all_corrupt_raises_like_jax(tmp_path):
    def scenario(pkg, d):
        for step in (1, 2):
            pkg.save_pair(d, step, float(step))
            pkg.chaos.corrupt_file(pkg.recovery.checkpoint_path(d, step))
        with pytest.raises(pkg.corrupt_error, match="every retained checkpoint"):
            pkg.recovery.restore_latest(d, pkg.state())
        return True

    assert _each(tmp_path, scenario) == [True, True]


@pytest.mark.parametrize("corrupt_newest_manifest", [False, True], ids=["newest", "past_corrupt"])
def test_config_hash_mismatch_refused_like_jax(tmp_path, corrupt_newest_manifest):
    def scenario(pkg, d):
        pkg.save_pair(d, 1, 1.0, config_hash="aaaa")
        pkg.save_pair(d, 2, 2.0, config_hash="aaaa")
        if corrupt_newest_manifest:
            with open(pkg.recovery.manifest_path(d, 2), "w") as f:
                f.write("{not json")
        with pytest.raises(pkg.recovery.ResumeConfigMismatch, match="bbbb"):
            pkg.recovery.restore_latest(d, pkg.state(), config_hash="bbbb")
        manifest, _ = pkg.recovery.restore_latest(d, pkg.state(), config_hash="aaaa")
        return manifest.step

    expected = 1 if corrupt_newest_manifest else 2
    assert _each(tmp_path, scenario) == [expected, expected]


def test_host_count_turnover_like_jax(tmp_path, capsys):
    def scenario(pkg, d):
        pkg.save_pair(d, 4, 4.0, host_count=2)
        manifest, _ = pkg.recovery.restore_latest(d, pkg.state(), host_count=1, global_batch_size=8)
        with pytest.raises(pkg.recovery.HostCountMismatch, match="2-host run"):
            pkg.recovery.restore_latest(d, pkg.state(), host_count=3, global_batch_size=8)
        return manifest.step

    assert _each(tmp_path, scenario) == [4, 4]
    assert capsys.readouterr().err.count("2-host run restoring into a 1-host run") == 2


def test_prune_like_jax(tmp_path):
    def scenario(pkg, d):
        for step in (2, 4, 6, 8, 10):
            pkg.save_pair(d, step, float(step))
        pruned = pkg.recovery.prune(d, 2)
        return pruned, sorted(os.listdir(d))

    jax_out, port_out = _each(tmp_path, scenario)
    assert port_out == jax_out
    assert port_out[0] == [2, 4, 6]
    assert "MANIFEST.json" in port_out[1]


def test_config_fingerprint_matches_jax_and_is_stable_across_interpreters():
    plain = {"lr": 6e-4, "batch": 32, "nested": {"a": [1, 2], "b": None}}
    assert recovery.config_fingerprint(plain) == jax_recovery.config_fingerprint(plain)
    code = (
        "from torched_impala_tpu_torch import configs;"
        "from torched_impala_tpu_torch.resilience import config_fingerprint as f;"
        "print(f(configs.PONG))"
    )
    env = dict(os.environ, PYTHONHASHSEED="random")
    got = {
        subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                       cwd=ROOT, env=env).stdout.strip()
        for _ in range(2)
    }
    assert got == {recovery.config_fingerprint(configs.PONG)}
    assert recovery.config_fingerprint(dataclasses.replace(configs.PONG, lr=1e-3)) not in got


# ---- the async checkpointer ----------------------------------------------


def test_async_step_cadence_and_retention_like_jax(tmp_path):
    def scenario(pkg, d):
        ck = pkg.checkpointer(d, keep=2, interval_steps=2)
        fired = []
        try:
            for step in range(1, 8):
                if ck.maybe_save(step, lambda: pkg.state(float(step))):
                    fired.append(step)
                    ck.wait()
        finally:
            ck.close()
        return fired, ck.all_steps(), ck.saves

    jax_out, port_out = _each(tmp_path, scenario)
    assert port_out == jax_out == ([1, 3, 5, 7], [5, 7], 4)


def test_async_seconds_cadence_like_jax(tmp_path):
    def scenario(pkg, d):
        ck = pkg.checkpointer(d, interval_seconds=0.5)
        try:
            fired = [ck.maybe_save(1, pkg.state)]
            time.sleep(0.55)
            fired.append(ck.maybe_save(2, pkg.state))
            ck.wait()
            fired.append(ck.maybe_save(3, pkg.state))
            time.sleep(0.55)
            fired.append(ck.maybe_save(4, pkg.state))
            ck.wait()
        finally:
            ck.close()
        return fired, ck.all_steps()

    jax_out, port_out = _each(tmp_path, scenario)
    assert port_out == jax_out == ([False, True, False, True], [2, 4])


def test_async_busy_writer_skips_like_jax(tmp_path):
    def scenario(pkg, d):
        gate = threading.Event()
        ck = pkg.checkpointer(d, interval_steps=1, post_save=lambda path, step: gate.wait(5.0))
        try:
            first = ck.maybe_save(1, pkg.state)
            time.sleep(0.05)
            second = ck.maybe_save(2, pkg.state)
            skipped = ck.skipped
            gate.set()
            ck.wait()
        finally:
            gate.set()
            ck.close()
        return first, second, skipped, ck.all_steps()

    jax_out, port_out = _each(tmp_path, scenario)
    assert port_out == jax_out == (True, False, 1, [1])


def test_async_manifest_carries_version_and_hash_like_jax(tmp_path):
    def scenario(pkg, d):
        ck = pkg.checkpointer(d, config_hash="c0ffee")
        try:
            ck.save_now(3, pkg.state(), param_version=480)
            ck.save_now(4, pkg.state())  # version from the state's num_frames
            ck.wait()
        finally:
            ck.close()
        m3 = pkg.recovery.load_manifest(pkg.recovery.manifest_path(d, 3))
        m4 = pkg.recovery.load_manifest(pkg.recovery.manifest_path(d, 4))
        return m3.param_version, m3.config_hash, m4.param_version, m4.checkpoint, m4.host_count

    jax_out, port_out = _each(tmp_path, scenario)
    assert port_out == jax_out == (480, "c0ffee", 480, "ckpt-000000000004.npz", 1)


def test_async_writer_error_raised_on_the_next_call_like_jax(tmp_path):
    class Unserializable:
        def __array__(self, dtype=None, copy=None):
            raise TypeError("cannot materialize")

    def scenario(pkg, d):
        ck = pkg.checkpointer(d)
        try:
            ck.save_now(1, {"bad": Unserializable()})
            with pytest.raises(RuntimeError, match="writer thread failed"):
                ck.wait()
            with pytest.raises(RuntimeError, match="writer thread failed"):
                ck.maybe_save(2, pkg.state)
        finally:
            ck.close()
        return sorted(os.listdir(d))

    assert _each(tmp_path, scenario) == [[], []]


def test_anchor_counts_the_cadence_from_the_start_step(tmp_path):
    """The loop anchors the cadence at the step a run starts or resumes
    at: interval 4 from 0 saves at 4, 8; from a resumed 8, at 12."""
    ck = AsyncCheckpointer(str(tmp_path), interval_steps=4)
    try:
        ck.anchor(0)
        fired = [s for s in range(1, 10) if ck.maybe_save(s, _port_state) and ck.wait() is None]
        ck.anchor(8)
        fired += [s for s in range(9, 13) if ck.maybe_save(s, _port_state) and ck.wait() is None]
    finally:
        ck.close()
    assert fired == [4, 8, 12]


def test_learner_device_state_is_a_copy_and_saves_like_get_state(tmp_path):
    """`get_state_device` (clones on the learner's device; the CPU here)
    equals `get_state`, and a later in-place update of the live params
    and `nu` does not reach it: the async save of it writes the state of
    its step."""
    from torched_impala_tpu_torch.models.agent import Agent
    from torched_impala_tpu_torch.models.nets import ImpalaNet
    from torched_impala_tpu_torch.models.torsos import MLPTorso
    from torched_impala_tpu_torch.optim import RMSProp
    from torched_impala_tpu_torch.runtime.learner import Learner, LearnerConfig

    learner = Learner(agent=Agent(ImpalaNet(2, MLPTorso(4, (8,)))), optimizer=RMSProp(1e-3),
                      config=LearnerConfig(batch_size=1, unroll_length=2), device="cpu")
    before = learner.get_state()
    clones = learner.get_state_device()
    ck = AsyncCheckpointer(str(tmp_path), interval_steps=1)
    try:
        assert ck.maybe_save(1, lambda: clones)
        with torch.no_grad():
            for p in learner.params.values():
                p.add_(1.0)
            for v in learner._optimizer.nu.values():
                v.add_(1.0)
        ck.wait()
    finally:
        ck.close()
    from chip_smoke import states_equal

    assert states_equal(clones, before)
    _, saved = recovery.restore_latest(str(tmp_path), before)
    assert states_equal(saved, before)
    assert ck.records[0]["interval"] and ck.records[0]["bytes"] > 0


# ---- chaos -----------------------------------------------------------------


class _FakePool:
    """One worker whose process is a real `sleep`, for kill_env_worker."""

    def __init__(self):
        self.proc = subprocess.Popen(["sleep", "60"])
        self.num_workers = 1
        self._procs = [SimpleNamespace(pid=self.proc.pid, is_alive=lambda: self.proc.poll() is None)]


def test_one_plan_fires_the_same_faults_at_the_same_site_counts(tmp_path):
    plan = [
        {"kind": "raise_in_actor", "at": 2, "target": 1},
        {"kind": "raise_in_actor", "at": 1},
        {"kind": "wedge_queue", "at": 3, "duration_s": 0.0},
        {"kind": "crash_learner", "at": 4},
        {"kind": "corrupt_checkpoint", "at": 2},
        {"kind": "kill_env_worker", "at": 3, "target": 0},
        {"kind": "delay_lane", "at": 1, "duration_s": 0.0},
    ]
    events = [("actor", 0), ("actor", 1), ("actor", 0), ("actor", 1), ("actor", 1),
              ("enqueue", None), ("enqueue", None), ("enqueue", None), ("enqueue", None),
              *[("learner", n) for n in range(1, 7)],
              ("save", 0), ("save", 1), ("save", 2),
              *[("pool", None)] * 4]

    def scenario(pkg, d):
        os.makedirs(d)
        plan_path = os.path.join(d, "plan.json")
        with open(plan_path, "w") as f:
            json.dump(plan, f)
        p = pkg.chaos.ChaosPlan.from_json(plan_path)
        inj = (pkg.chaos.ChaosInjector(p, telemetry=Registry()) if pkg.jax
               else pkg.chaos.ChaosInjector(p))
        pool, files, enqueued, outcome = _FakePool(), [], [], []
        enqueue = inj.wrap_enqueue(enqueued.append)
        try:
            for site, arg in events:
                try:
                    if site == "actor":
                        inj.actor_hook(arg)
                    elif site == "enqueue":
                        enqueue(len(enqueued))
                    elif site == "learner":
                        inj.learner_hook(arg)
                    elif site == "save":
                        path = os.path.join(d, f"f{arg}")
                        with open(path, "wb") as f:
                            f.write(bytes(256))
                        files.append(path)
                        inj.checkpoint_hook(path, arg)
                    else:
                        inj.pool_hook(pool)
                    outcome.append((site, arg, len(inj.fired)))
                except Exception as e:  # noqa: BLE001 - the outcome compared
                    outcome.append((site, arg, type(e).__name__, str(e)))
            killed = pool.proc.wait(timeout=5)
        finally:
            if pool.proc.poll() is None:
                pool.proc.kill()
        corrupted = [os.path.basename(f) for f in files if open(f, "rb").read() != bytes(256)]
        return outcome, [f.kind for f in inj.fired], inj.pending, corrupted, killed, len(enqueued)

    jax_out, port_out = _each(tmp_path, scenario)
    assert port_out == jax_out
    outcome, fired, pending, corrupted, killed, enqueued = port_out
    assert fired == ["raise_in_actor", "raise_in_actor", "wedge_queue", "crash_learner",
                     "corrupt_checkpoint", "delay_lane", "kill_env_worker"]
    assert pending == 0 and corrupted == ["f1"] and killed == -9 and enqueued == 4
    raised = [o for o in outcome if len(o) == 4]
    assert [(o[0], o[1], o[2]) for o in raised] == [
        ("actor", 0, "ChaosError"), ("actor", 1, "ChaosError"), ("learner", 4, "ChaosError"),
    ]


@pytest.mark.parametrize("bad", [{"kind": "set_on_fire", "at": 1},
                                 {"kind": "crash_learner", "at": 0},
                                 {"kind": "crash_learner", "when": 3},
                                 {"kind": "wedge_queue", "at": 1, "duration_s": -1.0}],
                         ids=["unknown_kind", "at_zero", "unknown_field", "negative_duration"])
def test_bad_faults_refused_like_jax(tmp_path, bad):
    for module in (jax_chaos, chaos):
        with pytest.raises(ValueError):
            module.ChaosPlan.from_dicts([bad])
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(bad))
    for module in (jax_chaos, chaos):
        with pytest.raises(ValueError, match="JSON list"):
            module.ChaosPlan.from_json(str(path))


@pytest.mark.parametrize("kind,item", [
    ("kill_host", "DP and multi-process training"),
    ("kill_server_mid_wave", "Serving"),
    ("corrupt_pinned_version", "Serving"),
    ("wedge_shm_ring", "Serving"),
])
def test_unported_kinds_raise_and_name_their_item(kind, item):
    assert jax_chaos.Fault(kind=kind, at=1).kind == kind  # JAX has the site
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1: {item}"):
        chaos.ChaosPlan.from_dicts([{"kind": kind, "at": 1}])


# ---- end to end through loop.train and the CLI ---------------------------


def _cartpole_common(**overrides):
    cfg = dataclasses.replace(configs.CARTPOLE, num_actors=2, batch_size=2, **overrides)
    return cfg, dict(
        agent=configs.make_agent(cfg),
        env_factory=configs.make_env_factory(cfg, fake=True),
        num_actors=cfg.num_actors,
        actor_mode=cfg.actor_mode,
        learner_config=configs.make_learner_config(cfg),
        optimizer=configs.make_optimizer(cfg),
        seed=0,
        log_every=1,
        device="cpu",
    )


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_crash_resume_reaches_target(tmp_path):
    """As JAX's test: an actor raised and the learner crashed at step 3
    under async saves every step; a resume reaches the target of 8 and
    writes the final save there."""
    cfg, common = _cartpole_common()
    fp = recovery.config_fingerprint(cfg)
    plan = chaos.ChaosPlan([chaos.Fault(kind="raise_in_actor", at=2),
                            chaos.Fault(kind="crash_learner", at=3)])
    ck = AsyncCheckpointer(str(tmp_path), keep=3, interval_steps=1, config_hash=fp)
    with pytest.raises(chaos.ChaosError, match="learner crash at step 3"):
        loop.train(total_steps=8, async_checkpointer=ck, chaos=plan, config_hash=fp, **common)
    ck.wait()
    saved = ck.all_steps()
    ck.close()
    # A save due while the writer is busy is skipped: some of 1, 2, 3.
    assert saved and set(saved) <= {1, 2, 3}

    _, common = _cartpole_common()
    ck2 = AsyncCheckpointer(str(tmp_path), keep=3, interval_steps=2, config_hash=fp)
    seen = []
    result = loop.train(total_steps=8, async_checkpointer=ck2, resume="auto", config_hash=fp,
                        on_learner_step=seen.append, **common)
    ck2.close()
    assert seen[0] == saved[-1] and seen[-1] == 8
    assert result.learner.num_steps == 8
    assert result.learner.num_frames == 8 * cfg.frames_per_step
    # Anchored at the restored step: interval saves from 2 steps past it
    # on, then the final save at the target.
    steps = [r["step"] for r in ck2.records]
    assert steps[-1] == 8 and min(steps) >= saved[-1] + 2
    assert ck2.all_steps()[-1] == 8


def test_resume_refuses_config_mismatch(tmp_path):
    cfg, common = _cartpole_common()
    fp = recovery.config_fingerprint(cfg)
    ck = AsyncCheckpointer(str(tmp_path), interval_steps=1, config_hash=fp)
    loop.train(total_steps=1, async_checkpointer=ck, config_hash=fp, **common)
    ck.close()
    _, common = _cartpole_common()
    ck2 = AsyncCheckpointer(str(tmp_path), interval_steps=1, config_hash="f00d")
    try:
        with pytest.raises(recovery.ResumeConfigMismatch, match="f00d"):
            loop.train(total_steps=2, async_checkpointer=ck2, resume="auto", config_hash="f00d",
                       **common)
    finally:
        ck2.close()


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_chip_smoke_resume_runs_on_the_cpu(tmp_path):
    """The card's resume phase (`chip_smoke.resume_runs`) at a small
    process-actor config on the CPU: two pools of one worker, T = 4,
    B = 2. Run 1 ends in ChaosError after a pool and a supervisor
    restart with saves at 4, 8, 12 (12 corrupt) and the step-8 file equal
    to the state at step 8; the restore falls back to 8; run 2 resumes
    there to 16; run 3 saves and resumes with the synchronous
    checkpointer. resume_runs raises on any failed check."""
    import chip_smoke

    cfg = dataclasses.replace(configs.CARTPOLE, actor_mode="process", num_actors=2,
                              envs_per_actor=1, batch_size=2, unroll_length=4)
    out = chip_smoke.resume_runs(cfg, torch.device("cpu"), str(tmp_path), min_step_s=0.05)
    assert out["run1"]["corrupt"] == [12] and out["run1"]["pool_restarts"] >= 1
    assert out["restore"]["step"] == 8
    assert out["run2"]["retained"] == [8, 12, 16]
    assert out["run3"]["saves"] == [4, 8]


def test_resume_cli_example(tmp_path):
    """`run.RESUME_CPU_EXAMPLE`: save with the async checkpointer to step
    4, then resume to 6."""
    first, second = (cmd.format(dir=tmp_path) for cmd in run.RESUME_CPU_EXAMPLE)
    assert run.main(first.split()) == 0
    assert recovery.list_manifest_steps(str(tmp_path)) == [2, 4]
    assert run.main(second.split()) == 0
    assert recovery.list_manifest_steps(str(tmp_path)) == [2, 4, 6]
    m = recovery.load_manifest(recovery.manifest_path(str(tmp_path), 6))
    assert m.param_version == 6 * 4 * 4


def test_cli_refuses_async_checkpoint_without_a_directory():
    with pytest.raises(SystemExit):
        run.main(run.CPU_EXAMPLE.split() + ["--async-checkpoint"])


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_cli_chaos_flags_run(tmp_path, capsys):
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps([{"kind": "raise_in_actor", "at": 2}]))
    assert run.main(run.CPU_EXAMPLE.split() + ["--chaos-plan", str(plan), "--chaos", "7"]) == 0
    captured = capsys.readouterr()
    assert "[chaos] firing raise_in_actor" in captured.err
    assert "done: steps=3" in captured.out
