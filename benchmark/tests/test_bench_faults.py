"""A run with the timed path broken underneath comes out not correct: each
fault the training cell can have, planted in the port under the harness at
a tiny size on the CPU (the tiny cell computes in float32, so its sound
runs read float32 rounding against the full cell's limits)."""

import time

import pytest
import torch

from benchmark.run import run_cell
from benchmark.tests.tiny_cells import TINY_TRAIN, make_root

CPU = torch.device("cpu")
SEED = 2147483743


def _run(root, name, plant=None):
    return run_cell(name, SEED, 1.0, False, CPU, root=root, plant=plant, t_start=time.perf_counter())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("faults")))


def test_sound_runs_are_correct(root):
    res = _run(root, TINY_TRAIN)
    assert res["correct"] is True, res["checks"]


def _state_unchanged(learner):
    learner.state.optimizer.step = lambda *a, **k: None


def _half_batch(monkeypatch):
    from dotaclient_tpu_torch.train import fused
    from dotaclient_tpu_torch.train.ppo import take_rows

    orig = fused._train_step

    def half(cfg, state, batch, **kw):
        n = batch["rewards"].shape[0]
        return orig(cfg, state, take_rows(batch, torch.arange(n // 2)), **kw)

    monkeypatch.setattr(fused, "_train_step", half)


def _altered_action(monkeypatch):
    from dotaclient_tpu_torch.models import distributions as D

    orig = D.sample

    def altered(logits, obs, generator=None, noise=None):
        acts, logp = orig(logits, obs, generator=generator, noise=noise)
        acts["action_type"] = acts["action_type"].clone()
        acts["action_type"][0] = (acts["action_type"][0] + 1) % 4
        return acts, logp

    monkeypatch.setattr(D, "sample", altered)


def test_training_faults_are_caught(root, monkeypatch):
    res = _run(root, TINY_TRAIN, plant=_state_unchanged)
    assert res["correct"] is False and res["checks"]["change_gap"]["value"] == pytest.approx(1.0)
    with monkeypatch.context() as m:
        _half_batch(m)
        res = _run(root, TINY_TRAIN)
        assert res["correct"] is False, res["checks"]
    with monkeypatch.context() as m:
        _altered_action(m)
        res = _run(root, TINY_TRAIN)
        assert res["correct"] is False and res["checks"]["action_gap"]["value"] > 1.0, res["checks"]

