"""The actor-critic policy written out: a two-layer unit MLP, masked mean
and max pooling, the globals projection and the hero embedding into one
projection, an LSTM core (gates i, f, g, o), and the heads: action type,
move x, move y, ability, a target head that scores each unit's embedding
against a query (scaled by the square root of the embedding width), and a
value head.

Parameters are a flat dict keyed as the port's state dict (``Linear``
weights [out, in]; the core's ``wx`` [D, 4H], ``wh`` [H, 4H], ``b`` [4H]).
Everything runs in float32, or in the control's float8 products.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch

from benchmark.reference.precision import Arith

HEADS = ("action_type", "move_x", "move_y", "target_unit", "ability")
A_NOOP, A_MOVE, A_ATTACK, A_CAST = 0, 1, 2, 3
NEG_INF = -1e9

Params = Mapping[str, torch.Tensor]


def _lin(ar: Arith, p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return ar.linear(x, p[f"{name}.weight"], p.get(f"{name}.bias"))


def encode(ar: Arith, p: Params, obs: Mapping[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """obs with leading axes [...] -> (core input [..., H], unit embeddings
    [..., U, E])."""
    units = obs["units"].float()
    mask = obs["unit_mask"].float()[..., None]
    emb = torch.relu(_lin(ar, p, "unit_encoder.dense1", torch.relu(_lin(ar, p, "unit_encoder.dense0", units))))
    emb = emb * mask
    count = mask.sum(dim=-2)
    mean = emb.sum(dim=-2) / torch.clamp(count, min=1.0)
    peak = torch.where(mask > 0, emb, NEG_INF).amax(dim=-2)
    peak = torch.where(count > 0, peak, 0.0)
    glob = torch.relu(_lin(ar, p, "globals_proj", obs["globals"].float()))
    hero = p["hero_embed.weight"][obs["hero_id"].long()]
    x = torch.cat([mean, peak, glob, hero], dim=-1)
    return torch.relu(_lin(ar, p, "trunk_proj", x)), emb


def lstm(ar: Arith, p: Params, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
         resets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, T, D], h and c [B, H], resets [B, T] (1 zeroes the state before
    that step) -> (hs [B, T, H], h, c)."""
    wx, wh, b = p["core.wx"], p["core.wh"], p["core.b"]
    hs = []
    for t in range(x.shape[1]):
        keep = (1.0 - resets[:, t].float())[:, None]
        h, c = h * keep, c * keep
        gates = ar.matmul(x[:, t], wx) + ar.matmul(h, wh) + b
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1), h, c


def heads(ar: Arith, p: Params, y: torch.Tensor, emb: torch.Tensor) -> Tuple[Dict[str, torch.Tensor], Optional[torch.Tensor]]:
    """Core output [..., H] -> (logits per head, value [...] or None when
    the parameters hold no value head)."""
    query = _lin(ar, p, "target_query", y)
    target = torch.einsum("...e,...ue->...u", ar.q(query), ar.q(emb)) / math.sqrt(query.shape[-1])
    logits = {
        "action_type": _lin(ar, p, "head_action_type", y),
        "move_x": _lin(ar, p, "head_move_x", y),
        "move_y": _lin(ar, p, "head_move_y", y),
        "target_unit": target,
        "ability": _lin(ar, p, "head_ability", y),
    }
    value = _lin(ar, p, "head_value", y)[..., 0] if "head_value.weight" in p else None
    return logits, value


def sequence(ar: Arith, p: Params, obs: Mapping[str, torch.Tensor], h: torch.Tensor, c: torch.Tensor,
             resets: torch.Tensor):
    """obs [B, T, ...] from the carry (h, c) -> (logits [B, T, n], value
    [B, T] or None, h, c)."""
    x, emb = encode(ar, p, obs)
    ys, h, c = lstm(ar, p, x, h, c, resets)
    logits, value = heads(ar, p, ys, emb)
    return logits, value, h, c


def step(ar: Arith, p: Params, obs: Mapping[str, torch.Tensor], h: torch.Tensor, c: torch.Tensor):
    """One step of obs [B, ...] -> (logits [B, n], value [B] or None, h, c)."""
    seq_obs = {k: v[:, None] for k, v in obs.items()}
    zeros = torch.zeros(h.shape[0], 1, device=h.device)
    logits, value, h, c = sequence(ar, p, seq_obs, h, c, zeros)
    return ({k: v[:, 0] for k, v in logits.items()}, None if value is None else value[:, 0], h, c)


# -- the masked multi-head distribution ------------------------------------


def _masked_log_softmax(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mask = mask.bool()
    mask = mask | ~mask.any(dim=-1, keepdim=True)   # a fully illegal row is never used
    return torch.log_softmax(torch.where(mask, logits, NEG_INF), dim=-1)


def head_logps(logits: Mapping[str, torch.Tensor], obs: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Normalised log-probs per head; the target head once under the attack
    mask and once under the cast mask."""
    return {
        "action_type": _masked_log_softmax(logits["action_type"], obs["mask_action_type"]),
        "move_x": torch.log_softmax(logits["move_x"], dim=-1),
        "move_y": torch.log_softmax(logits["move_y"], dim=-1),
        "target_attack": _masked_log_softmax(logits["target_unit"], obs["mask_target_unit"]),
        "target_cast": _masked_log_softmax(logits["target_unit"], obs["mask_cast_target"]),
        "ability": _masked_log_softmax(logits["ability"], obs["mask_ability"]),
    }


def per_head(lps: Mapping[str, torch.Tensor], action_type: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The five heads' log-probs, the target head under the mask the action
    type selects."""
    target = torch.where((action_type == A_CAST)[..., None], lps["target_cast"], lps["target_attack"])
    return {"action_type": lps["action_type"], "move_x": lps["move_x"], "move_y": lps["move_y"],
            "target_unit": target, "ability": lps["ability"]}


def joint_logp(lps: Mapping[str, torch.Tensor], actions: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The conditional joint log-prob: move bins count for MOVE, the target
    for ATTACK and CAST, the ability for CAST."""
    a = actions["action_type"].long()
    heads_lp = per_head(lps, a)

    def take(h: str) -> torch.Tensor:
        return heads_lp[h].gather(-1, actions[h].long()[..., None])[..., 0]

    move = (a == A_MOVE).float()
    target = ((a == A_ATTACK) | (a == A_CAST)).float()
    cast = (a == A_CAST).float()
    return (take("action_type") + move * (take("move_x") + take("move_y")) + target * take("target_unit")
            + cast * take("ability"))


def entropy(lps: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Exact entropy of the conditional factorisation."""

    def ent(lp: torch.Tensor) -> torch.Tensor:
        return -(lp.exp() * lp).sum(dim=-1)

    p_type = lps["action_type"].exp()
    return (ent(lps["action_type"]) + p_type[..., A_MOVE] * (ent(lps["move_x"]) + ent(lps["move_y"]))
            + p_type[..., A_ATTACK] * ent(lps["target_attack"])
            + p_type[..., A_CAST] * (ent(lps["target_cast"]) + ent(lps["ability"])))


def sample(lps: Mapping[str, torch.Tensor], noise: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """argmax(log-prob + Gumbel noise) per head, the action type first and
    the target under the mask it selects."""
    a = torch.argmax(lps["action_type"] + noise["action_type"], dim=-1)
    heads_lp = per_head(lps, a)
    out = {"action_type": a}
    for h in HEADS[1:]:
        out[h] = torch.argmax(heads_lp[h] + noise[h], dim=-1)
    return out


def action_gaps(lps: Mapping[str, torch.Tensor], noise: Mapping[str, torch.Tensor],
                actions: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """How far each given action's score (log-prob + noise) lies below the
    best score of its head, the widest head per row: 0 for the action the
    reference itself picks. [...]"""
    heads_lp = per_head(lps, actions["action_type"].long())
    worst = None
    for h in HEADS:
        score = heads_lp[h] + noise[h]
        gap = score.amax(dim=-1) - score.gather(-1, actions[h].long()[..., None])[..., 0]
        worst = gap if worst is None else torch.maximum(worst, gap)
    return worst
