"""The port's checkpoints: bitwise round trip, walk-back past a corrupt
step, weights-only restore across optimizer layouts, retention, and the
learner's ``--checkpoint-dir`` / ``--restore`` on the CPU."""

import dataclasses
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from dotaclient_tpu_torch.train import learner as plearner
from dotaclient_tpu_torch.utils import telemetry
from dotaclient_tpu_torch.utils.checkpoint import CheckpointIntegrityError, CheckpointManager, verify_manifest
from tests.test_torch_common import tiny_configs


def learner_config(**ppo):
    _, cfg = tiny_configs()
    return dataclasses.replace(
        cfg,
        ppo=dataclasses.replace(cfg.ppo, rollout_len=3, **ppo),
        env=dataclasses.replace(cfg.env, n_envs=2, max_dota_time=0.4),
        log_every=1,
    )


def trained_learner(steps=2, seed=1):
    learner = plearner.Learner(learner_config(), actor="fused", seed=seed, device="cpu",
                               registry=telemetry.Registry())
    learner.train(steps)
    return learner


def assert_state_equal(a, b):
    for (ka, va), (kb, vb) in zip(a.policy.state_dict().items(), b.policy.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert set(sa["state"]) == set(sb["state"]) and sa["state"]
    for i in sa["state"]:
        for k, v in sa["state"][i].items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    assert (a.step, a.version) == (b.step, b.version)


def test_save_then_restore_is_bitwise(tmp_path):
    src = trained_learner()
    reg = telemetry.Registry()
    mgr = CheckpointManager(str(tmp_path), registry=reg)
    assert mgr.save(src.state, src.config, force=True)
    assert mgr.all_steps() == [src.state.step] == [2]
    dst = plearner.Learner(learner_config(), actor="fused", seed=9, device="cpu", registry=telemetry.Registry())
    state, cfg = mgr.restore(dst.config, dst.state)
    assert cfg == src.config and state is dst.state
    assert_state_equal(dst.state, src.state)
    params, step = mgr.restore_weights()
    assert step == 2 and all(torch.equal(params[k], v) for k, v in src.policy.state_dict().items())
    assert mgr.restore_config() == src.config
    assert reg.snapshot()["checkpoint/manifest_failures_total"] == 0.0


def flip_param_byte(path, tensor):
    """Flip one byte inside ``tensor``'s data in the saved file."""
    blob = bytearray(pathlib.Path(path).read_bytes())
    needle = tensor.detach().contiguous().numpy().tobytes()[:32]
    at = blob.find(needle)
    assert at > 0
    blob[at + 5] ^= 0x40
    pathlib.Path(path).write_bytes(bytes(blob))


@pytest.mark.parametrize("where", ["tensor_data", "file_tail"])
def test_corrupt_newest_step_walks_back(tmp_path, where):
    learner = trained_learner(steps=1)
    reg = telemetry.Registry()
    mgr = CheckpointManager(str(tmp_path), registry=reg)
    mgr.save(learner.state, learner.config)
    older = {k: v.clone() for k, v in learner.policy.state_dict().items()}
    learner.train(1)
    mgr.save(learner.state, learner.config)
    assert mgr.all_steps() == [1, 2]
    path = os.path.join(str(tmp_path), "2", "state.pt")
    if where == "tensor_data":
        flip_param_byte(path, learner.policy.state_dict()["core.wh"])
    else:
        blob = bytearray(pathlib.Path(path).read_bytes())
        blob[-3] ^= 0x01
        pathlib.Path(path).write_bytes(bytes(blob))
    params, step = mgr.restore_weights()
    assert step == 1 and mgr.last_restored_step == 1
    assert all(torch.equal(params[k], v) for k, v in older.items())
    assert reg.snapshot()["checkpoint/manifest_failures_total"] == 1.0
    # the leaf check alone catches a changed tensor too
    raw = torch.load(path, map_location="cpu", weights_only=True) if where == "tensor_data" else None
    if raw is not None:
        manifest = json.loads((tmp_path / "manifests" / "2.json").read_text())
        with pytest.raises(CheckpointIntegrityError, match="core.wh"):
            verify_manifest(manifest, raw)


def test_every_step_corrupt_raises(tmp_path):
    learner = trained_learner(steps=1)
    mgr = CheckpointManager(str(tmp_path), registry=telemetry.Registry())
    mgr.save(learner.state, learner.config)
    mgr.wait()   # the write lands after save returns
    flip_param_byte(os.path.join(str(tmp_path), "1", "state.pt"), learner.policy.state_dict()["core.wx"])
    with pytest.raises(CheckpointIntegrityError):
        mgr.restore_weights()


def test_restore_weights_across_a_kl_target_layout(tmp_path):
    """A kl_target run on the card keeps its learning rate as a device
    tensor in a capturable Adam; its checkpoint restores weights-only into
    any run, and a full restore keeps the live run's lr form."""
    learner = trained_learner(steps=1)
    opt = learner.state.optimizer.state_dict()
    opt["param_groups"][0]["lr"] = torch.tensor(1.5e-4)
    opt["param_groups"][0]["capturable"] = True
    host = {"step": 1, "version": 1, "params": {k: v.clone() for k, v in learner.policy.state_dict().items()},
            "opt_state": opt}
    mgr = CheckpointManager(str(tmp_path), registry=telemetry.Registry())
    assert mgr.save_host(host, learner_config(kl_target=0.01))
    params, step = mgr.restore_weights()
    assert step == 1 and all(torch.equal(params[k], v) for k, v in host["params"].items())
    fresh = plearner.Learner(learner_config(), actor="fused", seed=3, device="cpu", registry=telemetry.Registry())
    state, cfg = mgr.restore(fresh.config, fresh.state)
    assert cfg.ppo.kl_target == 0.01
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(1.5e-4)
    assert isinstance(state.optimizer.param_groups[0]["lr"], float)


def test_retention_keeps_the_newest_steps(tmp_path):
    learner = trained_learner(steps=1)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, registry=telemetry.Registry())
    for step in (1, 2, 3, 4):
        learner.state.step = step
        assert mgr.save(learner.state, learner.config)
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    assert sorted(os.listdir(os.path.join(str(tmp_path), "manifests"))) == ["3.json", "4.json"]
    assert not [n for n in os.listdir(str(tmp_path)) if n.startswith(".tmp")]


def test_periodic_save_failure_degrades_and_forced_raises(tmp_path, monkeypatch):
    learner = trained_learner(steps=1)
    reg = telemetry.Registry()
    mgr = CheckpointManager(str(tmp_path), registry=reg)

    def full_disk(*a, **k):
        raise OSError("no space left on device")

    monkeypatch.setattr(torch, "save", full_disk)
    # the write fails on the writer thread, after save returned: the next
    # periodic save counts it and goes on, a forced one raises it
    assert mgr.save(learner.state, learner.config) is True
    assert mgr.join_writes() and reg.snapshot()["checkpoint/save_failures_total"] == 0.0
    assert mgr.save(learner.state, learner.config) is True
    assert reg.snapshot()["checkpoint/save_failures_total"] == 1.0
    with pytest.raises(OSError):
        mgr.save(learner.state, learner.config, force=True)
    assert mgr.all_steps() == [] and not [n for n in os.listdir(str(tmp_path)) if n.startswith(".tmp")]


def record(path):
    """The (step, scalars) rows of a --metrics-jsonl file."""
    rows = [json.loads(line) for line in telemetry.load_jsonl(path)]
    return [(r["step"], r["scalars"]) for r in rows if "scalars" in r]


def test_learner_cli_checkpoints_and_restores(tmp_path, capsys):
    d, first, second = str(tmp_path / "ckpt"), str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    assert plearner.main(["--smoke", "--steps", "1", "--device", "cpu", "--checkpoint-dir", d,
                          "--checkpoint-every", "1", "--metrics-jsonl", first]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("done: 1 steps, ")
    mgr = CheckpointManager(d, registry=telemetry.Registry())
    assert mgr.all_steps() == [1] and record(first)[-1][1]["optimizer_steps"] == 1.0
    assert plearner.main(["--smoke", "--steps", "1", "--device", "cpu", "--checkpoint-dir", d, "--restore",
                          "--metrics-jsonl", second]) == 0
    rows = record(second)
    assert rows[0][0] == 2  # the first logged step continues from the saved one
    assert mgr.all_steps() == [1, 2] and np.isfinite(rows[-1][1]["loss"])
    with pytest.raises(SystemExit):
        plearner.main(["--smoke", "--device", "cpu", "--restore"])


def test_learner_restores_the_saved_state(tmp_path):
    d = str(tmp_path / "ckpt")
    src = plearner.Learner(learner_config(), actor="fused", seed=1, device="cpu", checkpoint_dir=d,
                           registry=telemetry.Registry())
    src.train(2)  # saves at every boundary of checkpoint_every and at the end
    assert CheckpointManager(d, registry=telemetry.Registry()).all_steps() == [2]
    resumed = plearner.Learner(learner_config(), actor="fused", seed=5, device="cpu", checkpoint_dir=d,
                               restore=True, registry=telemetry.Registry())
    assert_state_equal(resumed.state, src.state)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        plearner.Learner(learner_config(), actor="fused", device="cpu", restore=True)


# -- init_from: a weights-only seed from another run's checkpoint ----------------------


def test_init_from_seeds_weights_into_a_fresh_run(tmp_path):
    """The seeded run holds the source's params, a fresh optimizer and step
    0 (and, with anchor_kl on, the seeded policy as its anchor); it saves
    into its own directory and leaves the source's steps as they were."""
    src_dir, dst_dir = str(tmp_path / "src"), str(tmp_path / "dst")
    src = plearner.Learner(learner_config(), actor="fused", seed=1, device="cpu", checkpoint_dir=src_dir,
                           registry=telemetry.Registry())
    src.train(2)
    cfg = learner_config(anchor_kl_coef=0.1)
    dst = plearner.Learner(cfg, actor="fused", seed=9, device="cpu", checkpoint_dir=dst_dir, init_from=src_dir,
                           registry=telemetry.Registry())
    assert dst.init_from_step == 2 and (dst.state.step, dst.state.version) == (0, 0)
    assert dst.state.optimizer.state_dict()["state"] == {}
    for (k, v), (_, w), (_, a) in zip(src.policy.state_dict().items(), dst.policy.state_dict().items(),
                                      dst.anchor.state_dict().items()):
        assert torch.equal(v, w) and torch.equal(v, a), k
    dst.train(1)
    assert CheckpointManager(dst_dir, registry=telemetry.Registry()).all_steps() == [1]
    assert CheckpointManager(src_dir, registry=telemetry.Registry()).all_steps() == [2]


@pytest.mark.parametrize("fault", ["with_restore", "same_dir", "missing_dir", "wrong_width"])
def test_init_from_refuses(tmp_path, fault):
    src_dir = str(tmp_path / "src")
    trained = plearner.Learner(learner_config(), actor="fused", seed=1, device="cpu", checkpoint_dir=src_dir,
                               registry=telemetry.Registry())
    trained.train(1)
    cfg, kw = learner_config(), {"init_from": src_dir, "checkpoint_dir": str(tmp_path / "dst")}
    if fault == "with_restore":
        kw["restore"], err, match = True, ValueError, "mutually exclusive"
    elif fault == "same_dir":
        kw["checkpoint_dir"], err, match = src_dir, ValueError, "separate source directory"
    elif fault == "missing_dir":
        kw["init_from"], err, match = str(tmp_path / "nope"), FileNotFoundError, "does not exist"
    else:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, hidden_dim=16))
        err, match = ValueError, r"param shape core\.b: \(32,\) != \(64,\)"
    with pytest.raises(err, match=match):
        plearner.Learner(cfg, actor="fused", device="cpu", registry=telemetry.Registry(), **kw)
    assert not os.path.exists(str(tmp_path / "nope"))  # a mistyped source is not created


def test_shape_mismatches_names_each_mismatched_tensor():
    from dotaclient_tpu_torch.utils.checkpoint import shape_mismatches

    want = {"a": torch.zeros(2, 3), "b": torch.zeros(4), "c": torch.zeros(1)}
    assert shape_mismatches({k: v.clone() for k, v in want.items()}, want) == []
    got = {"a": torch.zeros(3, 2), "b": torch.zeros(4), "c": torch.zeros(2)}
    assert shape_mismatches(got, want) == ["a: (3, 2) != (2, 3)", "c: (2,) != (1,)"]
    assert shape_mismatches({"a": want["a"]}, want) == ["tree structure differs: missing ['b', 'c'], unexpected []"]


def test_learner_cli_init_from(tmp_path, capsys):
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    assert plearner.main(["--smoke", "--steps", "1", "--device", "cpu", "--checkpoint-dir", src]) == 0
    capsys.readouterr()
    path = str(tmp_path / "dst.jsonl")
    assert plearner.main(["--smoke", "--steps", "1", "--device", "cpu", "--checkpoint-dir", dst,
                          "--init-from", src, "--metrics-jsonl", path]) == 0
    assert record(path)[0][0] == 1  # a fresh count, not the source's
    assert CheckpointManager(dst, registry=telemetry.Registry()).all_steps() == [1]


# -- the health guardian's pieces: last_good, discard, pipeline, faults -------------


@pytest.fixture
def fault_spec():
    from dotaclient_tpu_torch.utils import faults

    yield faults.configure
    faults.configure(None)


def test_last_good_slot_survives_retention_and_restores_bitwise(tmp_path):
    learner = trained_learner(steps=1)
    reg = telemetry.Registry()
    mgr = CheckpointManager(str(tmp_path), max_to_keep=1, registry=reg)
    assert mgr.last_good_step() is None and mgr.restore_last_good(learner.config, learner.state) is None
    assert mgr.save(learner.state, learner.config, mark_good=True)
    good = learner.state.clone()
    for _ in range(2):
        learner.train(1)
        assert mgr.save(learner.state, learner.config)   # not marked: the slot stays at step 1
    assert mgr.all_steps() == [3] and mgr.last_good_step() == 1
    assert reg.snapshot()["health/last_good_step"] == 1.0
    state, _ = mgr.restore_last_good(learner.config, learner.state)
    assert_state_equal(state, good)
    # the slot is a manager of its own: the main directory lists none of it
    assert "last_good" in os.listdir(str(tmp_path)) and 1 not in mgr.all_steps()


def test_discard_steps_above(tmp_path):
    learner = trained_learner(steps=1)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=5, registry=telemetry.Registry())
    for _ in range(3):
        mgr.save(learner.state, learner.config, mark_good=learner.state.step == 1)
        learner.train(1)
    assert mgr.all_steps() == [1, 2, 3]
    assert mgr.discard_steps_above(1) == 2
    assert mgr.all_steps() == [1] and mgr.last_good_step() == 1
    assert sorted(os.listdir(tmp_path / "manifests")) == ["1.json"]
    assert mgr.discard_steps_above(1) == 0


def test_restore_pipeline_round_trip_and_mismatch(tmp_path):
    learner = trained_learner(steps=1)
    mgr = CheckpointManager(str(tmp_path), registry=telemetry.Registry())
    mgr.save(learner.state, learner.config)
    assert mgr.restore_pipeline({"a": torch.zeros(3)}) == (None, "")   # saved without one
    learner.train(1)
    pipeline = {"buffer": {"order": torch.arange(4), "store": (torch.randn(4, 2), torch.ones(4, 2))},
                "mb_draws": torch.tensor(7)}
    assert mgr.save(learner.state, learner.config, force=True, pipeline=pipeline)
    got, reason = mgr.restore_pipeline(pipeline)
    assert reason == "" and int(got["mb_draws"]) == 7
    assert torch.equal(got["buffer"]["store"][0], pipeline["buffer"]["store"][0])
    assert torch.equal(got["buffer"]["order"], pipeline["buffer"]["order"])
    wrong = {**pipeline, "buffer": {**pipeline["buffer"], "order": torch.arange(5)}}
    got, reason = mgr.restore_pipeline(wrong)
    assert got is None and "shape mismatch" in reason
    # a pipeline file whose crc differs from the manifest's is refused loudly
    path = tmp_path / "2" / "pipeline.pt"
    blob = bytearray(path.read_bytes())
    blob[-3] ^= 0x01
    path.write_bytes(bytes(blob))
    got, reason = mgr.restore_pipeline(pipeline)
    assert got is None and "CheckpointIntegrityError" in reason
    # the state itself still restores
    assert mgr.restore_weights()[1] == 2


def test_fail_write_fault_degrades_periodic_and_raises_forced(tmp_path, fault_spec):
    fault_spec("checkpoint.fail_write@1+1")
    learner = trained_learner(steps=1)
    reg = telemetry.Registry()
    mgr = CheckpointManager(str(tmp_path), registry=reg)
    assert mgr.save(learner.state, learner.config) is False
    assert reg.snapshot()["checkpoint/save_failures_total"] == 1.0
    with pytest.raises(OSError, match="fail_write"):
        mgr.save(learner.state, learner.config, force=True)
    assert mgr.all_steps() == []


def test_corrupt_manifest_fault_walks_back(tmp_path, fault_spec):
    learner = trained_learner(steps=1)
    reg = telemetry.Registry()
    older = {k: v.clone() for k, v in learner.policy.state_dict().items()}
    fault_spec("checkpoint.corrupt_manifest@1")   # before the manager caches the registry
    mgr = CheckpointManager(str(tmp_path), registry=reg)
    mgr.save(learner.state, learner.config)
    learner.train(1)
    mgr.save(learner.state, learner.config)
    params, step = mgr.restore_weights()
    assert step == 1 and all(torch.equal(params[k], v) for k, v in older.items())
    assert reg.snapshot()["checkpoint/manifest_failures_total"] == 1.0
