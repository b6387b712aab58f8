"""The roofline's bound and the model FLOPs against counts made by hand."""

import pytest

from benchmark import readers, yardstick
from benchmark.trace import Profile

MODEL = {"unit_embed_dim": 64, "hidden_dim": 128, "hero_embed_dim": 16}
OBS = {"max_units": 32, "unit_features": 22, "global_features": 8}
ACTIONS = {"n_action_types": 4, "move_bins": 9, "max_units": 32, "max_abilities": 4}


def test_lstm_bound_by_hand():
    # B=64 T=1 D=H=512: G=2048; bytes 4 x (x 32,768 + h0,c0 65,536 + wx 1,048,576 + wh 1,048,576
    # + b 2,048 + resets 64 + hs 32,768 + hT,cT 65,536) = 9,183,488; FLOPs 2 x 64 x 1,024 x 2,048
    # + 64 x 2,048 = 268,566,528
    t, what = yardstick.lstm_bound_s(64, 1, 512, 512)
    assert what == "operations"
    assert t == pytest.approx(268_566_528 / 67e12)
    assert 9_183_488 / 3.35e12 < t
    t, what = yardstick.lstm_bound_s(1, 1, 8, 8)
    assert what == "bytes"
    assert t == pytest.approx(4 * (8 + 16 + 256 + 256 + 32 + 1 + 8 + 16) / 3.35e12)


def test_policy_flops_by_hand():
    # MACs: units 32 x (22 x 64 + 64 x 64) = 176,128; globals 8 x 64 = 512; trunk 208 x 128 = 26,624;
    # LSTM 256 x 512 = 131,072; heads 128 x (4 + 9 + 9 + 4) = 3,328; target 128 x 64 + 64 x 32 = 10,240;
    # value 128: 348,032 MACs
    assert yardstick.policy_forward_flops(MODEL, OBS, ACTIONS) == 2 * 348_032
    assert yardstick.policy_forward_flops(MODEL, OBS, ACTIONS, value_head=False) == 2 * (348_032 - 128)


def test_roofline_share_of_one_launch():
    shape = (64, 1, 512, 512)
    prof = Profile(window_s=1e-3, device=[("void lstm_seq_grid_kernel(float*)", 0.0, 20.0),
                                          ("other", 30.0, 40.0)], host=[])
    ctx = {"family": "train", "profile": prof, "profiled_lstm_launches": [shape]}
    bound = yardstick.lstm_bound_s(*shape)[0]
    assert readers.roofline_pct(ctx, "train") == pytest.approx(100 * bound / 20e-6)
    assert readers.roofline_pct(ctx, "serve") is None
    assert readers.idle_share_pct(ctx, "train") == pytest.approx(100 * (1 - 30e-6 / 1e-3))
    with pytest.raises(readers.MetricError):
        readers.roofline_pct(dict(ctx, profiled_lstm_launches=[shape] * 3), "train")
