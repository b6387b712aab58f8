"""The port's BASELINE-config bench (``train/bench_configs.py``, the
counterpart of ``scripts/bench_configs.py``): each config equals the
reference's field for field (both ``RunConfig`` trees as nested dicts), the
measurement at a tiny size on the CPU prints a row with the reference's keys,
self-play makes every hero a learner lane (games x heroes x 2), and the CLI
keeps the reference's flags. Configs 3 and 4's environments are held against
the JAX package's rollout in ``tests/test_torch_rollout.py``."""

import dataclasses
import importlib.util
import json
import os

import pytest
import torch

from dotaclient_tpu.config import default_config as jax_default_config
from dotaclient_tpu_torch.config import default_config
from dotaclient_tpu_torch.train import bench_configs
from tests.test_torch_common import tiny_configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROW_KEYS = {"config", "desc", "mode", "core", "steps_per_dispatch", "end_to_end_frames_per_sec", "n_envs",
            "team_size", "learner_lanes"}


def reference():
    spec = importlib.util.spec_from_file_location("_ref_bench_configs",
                                                  os.path.join(REPO, "scripts", "bench_configs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_build_config_equals_reference(n):
    want, want_desc = reference().build_config(n, jax_default_config())
    got, got_desc = bench_configs.build_config(n, default_config())
    assert got_desc == want_desc
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_unknown_config_raises():
    with pytest.raises(ValueError, match="unknown config 6"):
        bench_configs.build_config(6, default_config())


def tiny_base():
    """The serving tests' model with 2-step chunks and batches of 8."""
    _, cfg = tiny_configs()
    return dataclasses.replace(cfg, ppo=dataclasses.replace(cfg.ppo, rollout_len=2, batch_rollouts=8))


# (config, mode): the new self-play configs in both modes, and the 1v1
# scripted config in the buffered mode
@pytest.mark.parametrize("n,mode", [(3, "fused"), (4, "fused"), (4, "device"), (1, "device")])
def test_measure_row_at_tiny_size(n, mode):
    seen = []
    row, outs = bench_configs.measure_config(n, tiny_base(), mode=mode, seed=1, device="cpu", steps=1, warmup=1,
                                             repeats=1, max_dota_time=0.4,
                                             observe=lambda learner, outs: seen.append(outs))
    assert set(row) == ROW_KEYS and row["config"] == n and row["mode"] == mode
    # the row names the core that ran: the base's
    assert row["core"] == tiny_base().model.core == "lstm"
    assert row["end_to_end_frames_per_sec"] > 0 and len(outs) == 1 and outs[0]["frames_trained"] > 0
    cfg, desc = bench_configs.build_config(n, tiny_base())
    heroes = cfg.env.team_size * (2 if cfg.env.opponent == "selfplay" else 1)
    assert row["learner_lanes"] == cfg.env.n_envs * heroes and row["desc"] == desc
    if n in (3, 4):
        assert row["learner_lanes"] == 256
    assert seen == [None, outs]
    json.dumps(row)


def test_cli_prints_rows_and_table(monkeypatch, capsys):
    calls = []

    def fake(n, base, **kw):
        calls.append((n, kw))
        return {"config": n, "desc": f"config {n}", "end_to_end_frames_per_sec": 1.5}, []

    monkeypatch.setattr(bench_configs, "measure_config", fake)
    assert bench_configs.main(["--configs", "3,4", "--mode", "fused", "--steps", "7", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [json.loads(line)["config"] for line in out[:2]] == [3, 4]
    assert out[3].startswith("config | description")
    assert [n for n, _ in calls] == [3, 4]
    assert calls[0][1]["mode"] == "fused" and calls[0][1]["steps"] == 7 and calls[0][1]["device"].type == "cpu"
    # the reference's measurement depth by default
    assert "warmup" not in calls[0][1] and bench_configs.WARMUP == 20 and bench_configs.REPEATS == 3


@pytest.mark.parametrize("core", ["lstm", "transformer"])
def test_cli_core_reaches_the_model(monkeypatch, core):
    bases = []

    def fake(n, base, **kw):
        bases.append(base)
        return {"config": n, "desc": f"config {n}", "end_to_end_frames_per_sec": 1.5}, []

    monkeypatch.setattr(bench_configs, "measure_config", fake)
    assert bench_configs.main(["--configs", "1", "--core", core, "--device", "cpu"]) == 0
    assert [b.model.core for b in bases] == [core]


def test_cli_refuses_dispatch_batching_in_device_mode():
    with pytest.raises(SystemExit):
        bench_configs.main(["--steps-per-dispatch", "2", "--device", "cpu"])


def test_no_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_configs.main(["--configs", "1"])
