"""The port's curriculum (``train/curriculum.py``) against the reference's
``scripts/curriculum_5v5.py``: each stage's argv is the reference's, with
``scripts/train_demo.py`` run as ``-m dotaclient_tpu_torch.train.demo`` and
``--device`` passed through, for every ``--lr``, ``--kl-target`` and
``--anchor-kl`` case and ``--skip-stage1``; the ``--skip-stage1`` error is the
reference's. Marked ``slow``: a tiny curriculum on the CPU, stage 2
starting from stage 1's saved weights bit for bit."""

import importlib.util
import json
import os
import sys

import pytest
import torch

from dotaclient_tpu_torch.train import curriculum
from dotaclient_tpu_torch.utils.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference():
    spec = importlib.util.spec_from_file_location("_ref_curriculum",
                                                  os.path.join(REPO, "scripts", "curriculum_5v5.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_commands(flags, monkeypatch):
    ref = reference()
    cmds = []
    monkeypatch.setattr(ref, "run", cmds.append)
    monkeypatch.setattr(sys, "argv", ["curriculum_5v5.py", *flags])
    ref.main()
    return cmds


CASES = {
    "defaults": [],
    "lr": ["--lr", "3e-5", "--stage1-steps", "20", "--stage2-steps", "10", "--seed", "3"],
    "kl_target": ["--kl-target", "1e-3"],
    "anchor_kl": ["--anchor-kl", "0.05", "--hero-pool", "1,2"],
    "kl_and_anchor": ["--kl-target", "2e-3", "--anchor-kl", "0.1", "--lr", "9e-5"],
}


@pytest.mark.parametrize("device", [None, "cpu"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_stage_argv_equal_the_reference(case, device, tmp_path, monkeypatch):
    flags = ["--ckpt-root", str(tmp_path / "ck"), *CASES[case]]
    want = reference_commands(flags, monkeypatch)
    got = curriculum.stage_commands(curriculum.parse_args(flags + (["--device", device] if device else [])))
    assert len(got) == len(want) == 2
    demo = os.path.join(REPO, "scripts", "train_demo.py")
    for g, w in zip(got, want):
        assert w[:2] == [sys.executable, demo]
        assert g[:3] == [sys.executable, "-m", "dotaclient_tpu_torch.train.demo"]
        assert g[3:] == w[2:] + (["--device", device] if device else [])


def test_skip_stage1(tmp_path, monkeypatch):
    flags = ["--ckpt-root", str(tmp_path / "ck"), "--skip-stage1"]
    # no stage-1 checkpoint: both refuse with a usage error
    with pytest.raises(SystemExit) as ref_exit:
        reference_commands(flags, monkeypatch)
    with pytest.raises(SystemExit) as port_exit:
        curriculum.parse_args(flags)
    assert ref_exit.value.code == port_exit.value.code == 2
    os.makedirs(tmp_path / "ck" / "curriculum_stage1")
    want = reference_commands(flags, monkeypatch)
    got = curriculum.stage_commands(curriculum.parse_args(flags))
    assert len(got) == len(want) == 1 and got[0][3:] == want[0][2:]


def test_no_card_raises_before_a_stage(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ran = []
    monkeypatch.setattr(curriculum.subprocess, "run", lambda *a, **k: ran.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        curriculum.main(["--ckpt-root", str(tmp_path)])
    assert ran == []


@pytest.mark.slow
def test_tiny_curriculum_on_cpu(tmp_path, capfd):
    """Both stages as children at a tiny size (about 90 s on the CPU: two
    demo processes with their evaluations): each exits 0 with its
    DEMO_SUMMARY, stage 2 starts from stage 1's saved step, and its
    critic-only warm-up leaves every param but the value head bit for bit
    stage 1's saved weights."""
    root = tmp_path / "ck"
    assert curriculum.main(["--ckpt-root", str(root), "--stage1-steps", "1", "--stage2-steps", "2", "--n-envs", "2",
                            "--eval-games", "2", "--max-dota-time", "1", "--hero-pool", "1,2", "--device",
                            "cpu"]) == 0
    summaries = [json.loads(line[len("DEMO_SUMMARY "):]) for line in capfd.readouterr().out.splitlines()
                 if line.startswith("DEMO_SUMMARY ")]
    w1, step1 = CheckpointManager(str(root / "curriculum_stage1")).restore_weights()
    w2, step2 = CheckpointManager(str(root / "curriculum_stage2")).restore_weights()
    assert [s["team_size"] for s in summaries] == [1, 5] and (step1, step2) == (1, 2)
    assert summaries[1]["restored_step"] == step1
    assert {k for k in w1 if not torch.equal(w1[k], w2[k])} == {"head_value.weight", "head_value.bias"}
