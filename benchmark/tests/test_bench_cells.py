"""Cells found by name and run at a tiny size on the CPU: a cell, a traffic
mix, a configuration and a per-layer metric added as new files alone."""

import json
import time

import torch

from benchmark import cells
from benchmark.run import run_cell
from benchmark.tests.tiny_cells import TINY_TRAIN, make_root

CPU = torch.device("cpu")
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]

FRAMES_METRIC = '''"""Frames an iteration of the tiny training cell (a metric added as one file)."""


def read(ctx):
    if ctx.get("family") != "train" or not ctx.get("model_seconds"):
        return None
    return float(ctx["profiled_calls"])
'''


def test_new_files_make_a_cell(tmp_path):
    root = make_root(str(tmp_path), metric={"tiny.profiled_calls": FRAMES_METRIC})
    cell = cells.load(TINY_TRAIN, root)
    assert cell.config["hidden_dim"] == 16 and cell.traffic["kind"] == "train"
    assert "tiny.profiled_calls" in [m["name"] for m in cell.per_layer()]
    plain = run_cell(TINY_TRAIN, 2147483659, 1.0, False, CPU, root=root, t_start=time.perf_counter())
    assert list(plain) == KEYS
    assert set(plain["metrics"]) == {"trained_frames_per_s", "setup_s"}
    assert plain["metrics"]["trained_frames_per_s"]["value"] > 0
    assert plain["correct"] is True, plain["checks"]
    traced = run_cell(TINY_TRAIN, 2147483659, 1.0, True, CPU, root=root, t_start=time.perf_counter())
    assert traced["metrics"]["tiny.profiled_calls"]["value"] == 1.0
    assert traced["metrics"]["train.iteration_ms"]["value"] > 0
    # no card: the readers of the device trace find nothing and say nothing
    assert "kernel.lstm_seq_roofline.train" not in traced["metrics"]
    json.dumps(traced)

