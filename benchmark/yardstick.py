"""The yardstick: the card's peaks, the LSTM kernel's least time, and the
policy's model FLOPs, all from shapes.

Peaks are NVIDIA's data sheet for the H100 SXM at its full 700 W: 3.35 TB/s
of HBM, 67 TFLOP/s float32 outside the tensor cores, 989 TFLOP/s dense
bf16. A card set below 700 W reaches less; the result line carries the
card's power limit beside each share.
"""

from __future__ import annotations

from typing import Mapping, Tuple

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12


def lstm_bound_s(B: int, T: int, D: int, H: int) -> Tuple[float, str]:
    """(least seconds, what bounds it) of one ``lstm_seq`` launch: each
    input read once and each output written once at the memory rate, or its
    gate multiply-adds and bias adds at the float32 rate, whichever is
    larger."""
    G = 4 * H
    n_bytes = 4 * (B * T * D + 2 * B * H + D * G + H * G + G + B * T + B * T * H + 2 * B * H)
    flops = 2 * B * T * (D + H) * G + B * T * G
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def policy_forward_flops(model: Mapping, obs: Mapping, actions: Mapping, value_head: bool = True) -> int:
    """Matrix-product FLOPs (2 a multiply-add) of one lane-step's forward:
    the unit MLP over every unit slot, the globals and trunk projections,
    one LSTM step, the heads and the target head's scores over the units.
    Element-wise work, pooling and the softmaxes are not counted."""
    E, H = model["unit_embed_dim"], model["hidden_dim"]
    U, F, Gl = obs["max_units"], obs["unit_features"], obs["global_features"]
    hero = model["hero_embed_dim"]
    macs = U * (F * E + E * E)                 # unit encoder
    macs += Gl * E                             # globals projection
    macs += (3 * E + hero) * H                 # trunk projection
    macs += (H + H) * 4 * H                    # LSTM gates, input and recurrent
    n_out = actions["n_action_types"] + 2 * actions["move_bins"] + actions["max_abilities"]
    macs += H * n_out                          # action-type, move and ability heads
    macs += H * E + E * U                      # target query and its scores
    if value_head:
        macs += H
    return 2 * macs
