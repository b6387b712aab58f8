"""The weights a run hands to the program and to the reference alike.

Made on the device from ``--seed`` by one generator in one call, cut into
the policy's leaves in name order: matrices scaled to unit variance over
their fan-in, the hero embedding over its width, biases zero. The names and
shapes come from the configuration; the harness refuses a program whose
parameters do not match them.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch


def param_shapes(model: Mapping, obs: Mapping, actions: Mapping, value_head: bool = True) -> Dict[str, Tuple[int, ...]]:
    """Leaf name -> shape of the LSTM policy (``Linear`` weights [out, in])."""
    E, H = model["unit_embed_dim"], model["hidden_dim"]
    hero = model["hero_embed_dim"]
    shapes = {
        "unit_encoder.dense0.weight": (E, obs["unit_features"]), "unit_encoder.dense0.bias": (E,),
        "unit_encoder.dense1.weight": (E, E), "unit_encoder.dense1.bias": (E,),
        "hero_embed.weight": (model["n_hero_ids"], hero),
        "globals_proj.weight": (E, obs["global_features"]), "globals_proj.bias": (E,),
        "trunk_proj.weight": (H, 3 * E + hero), "trunk_proj.bias": (H,),
        "core.wx": (H, 4 * H), "core.wh": (H, 4 * H), "core.b": (4 * H,),
        "head_action_type.weight": (actions["n_action_types"], H), "head_action_type.bias": (actions["n_action_types"],),
        "head_move_x.weight": (actions["move_bins"], H), "head_move_x.bias": (actions["move_bins"],),
        "head_move_y.weight": (actions["move_bins"], H), "head_move_y.bias": (actions["move_bins"],),
        "head_ability.weight": (actions["max_abilities"], H), "head_ability.bias": (actions["max_abilities"],),
        "target_query.weight": (E, H), "target_query.bias": (E,),
    }
    if value_head:
        shapes["head_value.weight"] = (1, H)
        shapes["head_value.bias"] = (1,)
    return shapes


def _scale(name: str, shape: Tuple[int, ...]) -> float:
    if name.endswith(".bias") or name == "core.b":
        return 0.0
    if name == "hero_embed.weight":
        return 1.0 / math.sqrt(shape[1])
    fan_in = shape[0] if name.startswith("core.") else shape[1]
    return 1.0 / math.sqrt(fan_in)


def make_weights(shapes: Mapping[str, Tuple[int, ...]], seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """float32 leaves from one draw of a generator on ``device``."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out = {}
    for name, part in zip(names, flat.split(sizes)):
        out[name] = part.view(shapes[name]) * _scale(name, shapes[name])
    return out
