"""The comparison that decides ``correct`` fails the control: the plain
reference put in the program's place in float8 products (the precision below
the configuration's bfloat16), judged by the float32 reference against the
full cell's limits, on the CPU at a size a test run holds. The readings at
the cell's own size on the card come from ``python3 -m benchmark.calibrate``;
the ``cuda`` case runs the full cell briefly on the card."""

import dataclasses
import json
import subprocess
import sys

import pytest
import torch

from benchmark import cells
from benchmark.cells import ROOT
from benchmark.drivers.train import reference_setup
from benchmark.reference import train as ref_train
from benchmark.reference.precision import Arith
from benchmark.weights import make_weights, param_shapes

CPU = torch.device("cpu")


def _fails(readings, limits):
    return any(readings[k] > limits[k] for k in limits)


@pytest.mark.parametrize("seed", [2147483801, 2147483803])
def test_training_control_fails(seed):
    # the full cell's configuration and traffic at its widths, 8 games of its 256
    cell = cells.load("train_league5v5_lstm128")
    cfg = cells.run_config(cell, seed)
    cfg = cfg.replace(env=dataclasses.replace(cfg.env, n_envs=8))
    setup = reference_setup(cfg)
    w0 = make_weights(param_shapes(cell.config, dataclasses.asdict(cfg.obs), dataclasses.asdict(cfg.actions)),
                      seed, CPU)
    n = cell.traffic["checked_iterations"]
    played = ref_train.follow(setup, w0, seed, n, arith=Arith("float8"))
    judge = ref_train.follow(setup, w0, seed, n, actions=played.actions)
    readings = ref_train.compare(played.losses, played.grad1, played.params, judge, w0)
    assert _fails(readings, cell.limits), readings


@pytest.mark.cuda
def test_full_cell_on_the_card(card):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "train_league5v5_lstm128",
                          "--seed", "2147483811", "--seconds", "5", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
