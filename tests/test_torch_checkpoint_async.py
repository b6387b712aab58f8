"""The port's checkpoint saves that return before the write lands: the
writer thread, the reference's failure policy and decline rule (held against
the JAX manager on the same step sequence), the snapshot engine's drain and
stop, and the learner CLI's ``--on-crash-checkpoint`` and ``--profile``.
Host arithmetic and files only: every comparison is exact."""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

from dotaclient_tpu.config import RunConfig as JaxRunConfig
from dotaclient_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager
from dotaclient_tpu_torch.config import RunConfig
from dotaclient_tpu_torch.train import learner as plearner
from dotaclient_tpu_torch.train.snapshot import SnapshotEngine, device_copy
from dotaclient_tpu_torch.utils import faults, telemetry
from dotaclient_tpu_torch.utils.checkpoint import CheckpointManager

WAIT_S = 30.0


def host_state(step, n=3):
    return {"step": step, "version": step, "params": {"w": torch.full((n,), float(step))},
            "opt_state": {"state": {}, "param_groups": [{"lr": 1e-3, "params": [0]}]}}


def jax_host_state(step):
    return {"step": np.int32(step), "version": np.int32(step), "params": {"w": np.full(3, step, np.float32)},
            "opt_state": {"m": np.zeros(2, np.float32)}}


class BlockedWriter:
    """Holds every write of ``mgr`` on an event until ``release``; counts
    the writes that started."""

    def __init__(self, mgr, monkeypatch):
        self.gate, self.started = threading.Event(), threading.Semaphore(0)
        write = mgr._write

        def held(*args):
            self.started.release()
            assert self.gate.wait(WAIT_S)
            return write(*args)

        monkeypatch.setattr(mgr, "_write", held)

    def release(self):
        self.gate.set()


class TinyState:
    """A train state with one param, in the layout of ``host_state``."""

    def __init__(self):
        w = torch.nn.Parameter(torch.zeros(3))
        self.policy = torch.nn.ParameterDict({"w": w})
        self.optimizer = torch.optim.SGD([w], lr=1e-3)
        self.step = self.version = 0


def failing_write(mgr, monkeypatch, message="no space left on device"):
    def full_disk(*args):
        raise OSError(message)

    monkeypatch.setattr(mgr, "_write", full_disk)


# -- the writer ---------------------------------------------------------------------------


def test_save_returns_before_the_write_lands(tmp_path, monkeypatch):
    reg = telemetry.Registry()
    mgr = CheckpointManager(str(tmp_path), registry=reg)
    blocked = BlockedWriter(mgr, monkeypatch)
    assert mgr.save_host(host_state(1), RunConfig()) is True
    assert blocked.started.acquire(timeout=WAIT_S)
    # handed over: nothing on disk yet, and the write has not landed
    assert not os.path.exists(tmp_path / "1") and mgr.join_writes(timeout=0.05) is False
    seen = []
    reader = threading.Thread(target=lambda: seen.append(mgr.all_steps()))
    reader.start()
    reader.join(0.2)
    assert reader.is_alive() and not seen   # a reader joins the pending write
    blocked.release()
    reader.join(WAIT_S)
    assert seen == [[1]]
    mgr.wait()
    assert mgr.all_steps() == [1] and reg.snapshot()["checkpoint/save_failures_total"] == 0.0
    mgr.close()


def test_background_failure_counted_at_next_periodic_save(tmp_path, monkeypatch):
    reg = telemetry.Registry()
    mgr = CheckpointManager(str(tmp_path), registry=reg)
    failing_write(mgr, monkeypatch)
    assert mgr.save_host(host_state(1), RunConfig()) is True   # handed over; it fails on the writer
    assert mgr.join_writes(WAIT_S) and reg.snapshot()["checkpoint/save_failures_total"] == 0.0
    monkeypatch.undo()
    assert mgr.save_host(host_state(2), RunConfig()) is True   # surfaces it, counts it, goes on
    assert reg.snapshot()["checkpoint/save_failures_total"] == 1.0
    mgr.wait()
    assert mgr.all_steps() == [2]
    mgr.close()


def test_background_failure_raised_at_forced_save_and_wait(tmp_path, monkeypatch):
    reg = telemetry.Registry()
    mgr = CheckpointManager(str(tmp_path), registry=reg)
    failing_write(mgr, monkeypatch, "disk gone")
    assert mgr.save_host(host_state(1), RunConfig())
    with pytest.raises(OSError, match="disk gone"):
        mgr.save_host(host_state(2), RunConfig(), force=True)
    assert mgr.save_host(host_state(3), RunConfig(), force=True)   # the failure surfaced once
    with pytest.raises(OSError, match="disk gone"):
        mgr.wait()
    mgr.wait()   # nothing left to surface
    assert mgr.all_steps() == [] and reg.snapshot()["checkpoint/save_failures_total"] == 0.0
    mgr.close()


def test_close_counts_an_unsurfaced_failure_and_stops_the_writer(tmp_path, monkeypatch):
    reg = telemetry.Registry()
    mgr = CheckpointManager(str(tmp_path), registry=reg)
    failing_write(mgr, monkeypatch)
    mgr.save_host(host_state(1), RunConfig())
    writer = mgr._writer
    mgr.close()
    assert not writer.is_alive() and mgr._writer is None
    assert reg.snapshot()["checkpoint/save_failures_total"] == 1.0


@pytest.mark.parametrize("reader", ["restore_weights", "restore_config", "latest_step", "last_good_step",
                                    "restore_last_good", "restore_pipeline", "discard_steps_above"])
def test_readers_join_the_pending_write(tmp_path, monkeypatch, reader):
    """Every reader waits for the write in flight, and then sees it: the
    mirror into last_good included."""
    cfg = RunConfig()
    mgr = CheckpointManager(str(tmp_path), registry=telemetry.Registry())
    blocked = BlockedWriter(mgr, monkeypatch)
    mgr.save_host(host_state(4), cfg, pipeline={"ring": torch.arange(5)}, mark_good=True)
    assert blocked.started.acquire(timeout=WAIT_S)
    calls = {
        "restore_weights": lambda: mgr.restore_weights()[1],
        "restore_config": lambda: mgr.restore_config() == cfg,
        "latest_step": mgr.latest_step,
        "last_good_step": mgr.last_good_step,
        "restore_last_good": lambda: mgr.restore_last_good(cfg, TinyState())[0].step,
        "restore_pipeline": lambda: int(mgr.restore_pipeline({"ring": torch.zeros(5)}, step=4)[0]["ring"][4]),
        "discard_steps_above": lambda: (mgr.discard_steps_above(3), mgr._steps_on_disk()),
    }
    want = {"restore_weights": 4, "restore_config": True, "latest_step": 4, "last_good_step": 4,
            "restore_last_good": 4, "restore_pipeline": 4, "discard_steps_above": (1, [])}
    got = []
    t = threading.Thread(target=lambda: got.append(calls[reader]()))
    t.start()
    t.join(0.2)
    assert t.is_alive() and not got
    blocked.release()
    t.join(WAIT_S)
    assert got == [want[reader]]
    mgr.close()


def test_lock_and_join_timeouts(tmp_path, monkeypatch):
    """A write that does not land within LOCK_TIMEOUT_S: a periodic save is
    counted and declined, a forced one and ``wait`` raise."""
    reg = telemetry.Registry()
    mgr = CheckpointManager(str(tmp_path), registry=reg)
    monkeypatch.setattr(CheckpointManager, "LOCK_TIMEOUT_S", 0.1)
    blocked = BlockedWriter(mgr, monkeypatch)
    assert mgr.save_host(host_state(1), RunConfig())
    assert mgr.save_host(host_state(2), RunConfig()) is False
    assert reg.snapshot()["checkpoint/save_failures_total"] == 1.0
    with pytest.raises(RuntimeError, match="did not land"):
        mgr.save_host(host_state(2), RunConfig(), force=True)
    with pytest.raises(RuntimeError, match="did not land"):
        mgr.wait()
    with mgr._save_lock:
        assert mgr.save_host(host_state(3), RunConfig()) is False
        with pytest.raises(RuntimeError, match="lock not acquired"):
            mgr.save_host(host_state(3), RunConfig(), force=True)
    assert reg.snapshot()["checkpoint/save_failures_total"] == 2.0
    blocked.release()
    mgr.wait()
    assert mgr.all_steps() == [1]
    mgr.close()


# -- the decline rule, against orbax -------------------------------------------------------

# (step, forced): below the newest and not on disk is declined; the newest
# and a step on disk are replaced; above the newest is saved; retention
# keeps the newest 3. Saves are never forced below the newest here: orbax
# then orders its steps by save time (the forced step becomes its
# "latest"), the port by step (the module's docstring).
SEQUENCE = ((5, False), (3, False), (5, False), (7, False), (6, False), (9, False), (1, False), (8, False),
            (10, False), (10, True), (4, False), (11, True), (2, False), (12, False))


def test_decline_rule_matches_the_jax_manager(tmp_path):
    jmgr = JaxCheckpointManager(str(tmp_path / "jax"), max_to_keep=3)
    pmgr = CheckpointManager(str(tmp_path / "port"), max_to_keep=3, registry=telemetry.Registry())
    got = {"jax": [], "port": []}
    for step, force in SEQUENCE:
        got["jax"].append((jmgr.save_host(jax_host_state(step), JaxRunConfig(), force=force),
                           (jmgr.wait(), jmgr._mgr.all_steps())[1], jmgr.latest_step()))
        got["port"].append((pmgr.save_host(host_state(step), RunConfig(), force=force), pmgr.all_steps(),
                            pmgr.latest_step()))
    assert got["port"] == [(s, list(steps), latest) for s, steps, latest in got["jax"]]
    assert [saved for saved, _, _ in got["port"]].count(False) == 6
    # the newest content supersedes a replaced step's
    assert float(pmgr.restore_weights()[0]["w"][0]) == 12.0
    jmgr.close()
    pmgr.close()


# -- the snapshot engine -----------------------------------------------------------------


@pytest.mark.parametrize("end", ["drain", "stop"])
def test_engine_drain_and_stop_land_the_writes_they_queued(tmp_path, monkeypatch, end):
    mgr = CheckpointManager(str(tmp_path), registry=telemetry.Registry())
    blocked = BlockedWriter(mgr, monkeypatch)
    engine = SnapshotEngine(ckpt=mgr, registry=telemetry.Registry())
    engine.submit_checkpoint(device_copy(host_state(6)), RunConfig())
    assert blocked.started.acquire(timeout=WAIT_S)   # the engine's job handed the write over
    if end == "drain":
        assert engine.drain(timeout=0.2) is False     # queued, not landed
    done = threading.Event()
    t = threading.Thread(target=lambda: (getattr(engine, end)(), done.set()))
    t.start()
    assert not done.wait(0.2)
    blocked.release()
    assert done.wait(WAIT_S)
    assert mgr._steps_on_disk() == [6]
    engine.stop()
    mgr.close()


# -- the learner CLI: --on-crash-checkpoint and --profile -----------------------------------


@pytest.fixture
def fault_spec():
    yield faults.configure
    faults.configure(None)


@pytest.mark.parametrize("rescue", ["saved", "off", "failed"])
def test_on_crash_checkpoint_through_main(tmp_path, fault_spec, capsys, rescue):
    """The 3rd update raises: with --on-crash-checkpoint the weights are
    saved at step 2 (forced, waited for), the line printed, and the error
    re-raised; a failing rescue is printed and never masks it."""
    spec = "learner.fail_train_step@3"
    if rescue == "failed":
        spec += ",checkpoint.fail_write@1"   # the rescue's forced save hits a full disk
    fault_spec(spec)
    d = str(tmp_path / "ck")
    args = ["--smoke", "--steps", "5", "--device", "cpu", "--checkpoint-dir", d, "--checkpoint-every", "100"]
    if rescue != "off":
        args.append("--on-crash-checkpoint")
    with pytest.raises(RuntimeError, match="injected fault: learner.fail_train_step"):
        plearner.main(args)
    out = capsys.readouterr().out
    steps = CheckpointManager(d, registry=telemetry.Registry()).all_steps()
    if rescue == "saved":
        assert f"learner: crash checkpoint saved to {os.path.abspath(d)} before re-raising" in out and steps == [2]
    elif rescue == "off":
        assert "crash checkpoint" not in out and steps == []
    else:
        assert "learner: crash checkpoint failed too (OSError: injected fault: checkpoint.fail_write" in out
        assert steps == []


def test_crash_checkpoint_resumes(tmp_path, fault_spec, capsys):
    fault_spec("learner.fail_train_step@2")
    d = str(tmp_path / "ck")
    with pytest.raises(RuntimeError):
        plearner.main(["--smoke", "--steps", "3", "--device", "cpu", "--checkpoint-dir", d,
                       "--on-crash-checkpoint"])
    fault_spec(None)
    assert plearner.main(["--smoke", "--steps", "2", "--device", "cpu", "--checkpoint-dir", d, "--restore"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("done: 2 steps, ")
    assert CheckpointManager(d, registry=telemetry.Registry()).all_steps() == [1, 3]


def test_profile_writes_a_chrome_trace_on_the_cpu(tmp_path, capsys):
    d = str(tmp_path / "profile")
    assert plearner.main(["--smoke", "--steps", "1", "--device", "cpu", "--actor", "fused", "--profile", d]) == 0
    (name,) = os.listdir(d)
    with open(os.path.join(d, name)) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    # CPU activity only here: the update's ops are in it, no CUDA kernel
    assert any("aten::" in n for n in names) and not any(e.get("cat") == "kernel" for e in events)


def test_profile_is_a_no_op_without_a_directory(tmp_path):
    from dotaclient_tpu_torch.utils.profiling import trace

    with trace(None):
        torch.ones(2).sum()
    with pytest.raises(ValueError, match="inside"):
        with trace(str(tmp_path / "p")):
            raise ValueError("inside")
    assert len(os.listdir(tmp_path / "p")) == 1   # written on the way out of a raise too


def test_learner_close_lands_the_writes(tmp_path):
    _, cfg = tiny_config()
    learner = plearner.Learner(cfg, actor="fused", seed=1, device="cpu", checkpoint_dir=str(tmp_path),
                               registry=telemetry.Registry())
    learner.train(1)
    learner.ckpt.save(learner.state, learner.config, force=True)
    learner.close()
    assert learner.ckpt._writer is None and learner.ckpt._steps_on_disk() == [1]


def tiny_config():
    from tests.test_torch_common import tiny_configs

    jcfg, pcfg = tiny_configs()
    return jcfg, dataclasses.replace(pcfg, env=dataclasses.replace(pcfg.env, n_envs=2, max_dota_time=0.4),
                                     ppo=dataclasses.replace(pcfg.ppo, rollout_len=3), log_every=1)
