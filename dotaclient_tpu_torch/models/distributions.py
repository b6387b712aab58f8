"""Masked multi-head categorical action distribution.

Counterpart of ``dotaclient_tpu/models/distributions.py``: one categorical
per head, illegal entries masked before the softmax, and a *conditional*
joint log-prob in which sub-heads count only when the action type uses them
(move bins for MOVE, the target slot for ATTACK/CAST, the ability for CAST).
The target head carries two masks, selected by the action type.

Sampling is argmax(logp + Gumbel noise), which is what JAX's
``random.categorical`` computes. The noise comes from a ``torch.Generator`` (drawn per
head in the order action_type, move_x, move_y, target_unit, ability) or is
injected per head, so a test can hand both packages the same noise.

All functions work over any leading axes (``[B, ...]`` and ``[B, T, ...]``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

# Action-type enum values; must match dota.proto ActionType.
A_NOOP, A_MOVE, A_ATTACK, A_CAST = 0, 1, 2, 3

# Large negative logit for illegal entries: finite, so fully masked rows
# still give a finite softmax.
NEG_INF = -1e9

HEADS = ("action_type", "move_x", "move_y", "target_unit", "ability")

Tensors = Mapping[str, torch.Tensor]


def _safe_mask(mask: torch.Tensor) -> torch.Tensor:
    """A mask with at least one legal entry per row: a fully illegal row
    (never used, since its action type is masked too) falls back to
    all-legal, so its log-softmax stays finite and ``0 * logp`` stays 0."""
    return mask | ~mask.any(dim=-1, keepdim=True)


def masked_log_softmax(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    masked = torch.where(_safe_mask(mask), logits, NEG_INF)
    return torch.log_softmax(masked, dim=-1)


def _head_logps(logits: Tensors, obs: Tensors) -> Dict[str, torch.Tensor]:
    """Masked, normalized log-probs per head; the target head appears once
    per conditioning action type."""
    return {
        "action_type": masked_log_softmax(logits["action_type"], obs["mask_action_type"]),
        # move heads are always fully legal
        "move_x": torch.log_softmax(logits["move_x"], dim=-1),
        "move_y": torch.log_softmax(logits["move_y"], dim=-1),
        "target_attack": masked_log_softmax(logits["target_unit"], obs["mask_target_unit"]),
        "target_cast": masked_log_softmax(logits["target_unit"], obs["mask_cast_target"]),
        "ability": masked_log_softmax(logits["ability"], obs["mask_ability"]),
    }


def _select_target_logps(logps: Tensors, action_type: torch.Tensor) -> torch.Tensor:
    """Per-row target-head log-softmax conditioned on the action type."""
    is_cast = (action_type == A_CAST)[..., None]
    return torch.where(is_cast, logps["target_cast"], logps["target_attack"])


def _gumbel(
    like: torch.Tensor, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """Standard Gumbel noise of ``like``'s shape: -log(-log(u)), with u
    uniform on [tiny, 1), as JAX's ``random.gumbel`` draws it."""
    return gumbel(like.shape, generator, like.device)


def gumbel(shape, generator: Optional[torch.Generator], device: torch.device) -> torch.Tensor:
    """:func:`_gumbel` of a shape: the same draw from ``generator``, so a
    caller that draws a whole batch ahead gets what ``sample`` would."""
    u = torch.rand(
        shape, generator=generator, device=device, dtype=torch.float32
    )
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample(
    logits: Tensors,
    obs: Tensors,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Tensors] = None,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Sample every head; return (actions, joint conditional log-prob).

    The action type is sampled first; the target head then samples under
    the mask that type implies, so every action is legal by construction.
    ``noise`` (Gumbel noise per head, keyed by ``HEADS``, each the shape of
    that head's logits) replaces the draws from ``generator``."""
    logps = _head_logps(logits, obs)

    def categorical(head: str, lp: torch.Tensor) -> torch.Tensor:
        g = noise[head].to(lp) if noise is not None else _gumbel(lp, generator)
        return torch.argmax(lp + g, dim=-1)

    a_type = categorical("action_type", logps["action_type"])
    target_logps = _select_target_logps(logps, a_type)
    actions = {
        "action_type": a_type,
        "move_x": categorical("move_x", logps["move_x"]),
        "move_y": categorical("move_y", logps["move_y"]),
        "target_unit": categorical("target_unit", target_logps),
        "ability": categorical("ability", logps["ability"]),
    }
    return actions, _joint_logp(logps, actions)


def log_prob(logits: Tensors, obs: Tensors, actions: Tensors) -> torch.Tensor:
    """Joint conditional log-prob of stored ``actions`` under ``logits``."""
    return _joint_logp(_head_logps(logits, obs), actions)


def _take(logp: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(logp, -1, idx[..., None].long())[..., 0]


def _joint_logp(logps: Tensors, actions: Tensors) -> torch.Tensor:
    a_type = actions["action_type"]
    move = (a_type == A_MOVE).float()
    target = ((a_type == A_ATTACK) | (a_type == A_CAST)).float()
    cast = (a_type == A_CAST).float()
    target_logps = _select_target_logps(logps, a_type)
    return (
        _take(logps["action_type"], a_type)
        + move * (_take(logps["move_x"], actions["move_x"])
                  + _take(logps["move_y"], actions["move_y"]))
        + target * _take(target_logps, actions["target_unit"])
        + cast * _take(logps["ability"], actions["ability"])
    )


def _kl_head(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.exp(a) * (a - b), dim=-1)


def _entropy_head(lp: torch.Tensor) -> torch.Tensor:
    return -torch.sum(torch.exp(lp) * lp, dim=-1)


def kl(logits_p: Tensors, logits_q: Tensors, obs: Tensors) -> torch.Tensor:
    """Exact KL(P || Q) of the conditional factorization at one state:
    per-head KLs, sub-heads weighted by P's probability of their action
    type."""
    lp = _head_logps(logits_p, obs)
    lq = _head_logps(logits_q, obs)
    p_type = torch.exp(lp["action_type"])
    return (
        _kl_head(lp["action_type"], lq["action_type"])
        + p_type[..., A_MOVE]
        * (_kl_head(lp["move_x"], lq["move_x"]) + _kl_head(lp["move_y"], lq["move_y"]))
        + p_type[..., A_ATTACK] * _kl_head(lp["target_attack"], lq["target_attack"])
        + p_type[..., A_CAST]
        * (_kl_head(lp["target_cast"], lq["target_cast"])
           + _kl_head(lp["ability"], lq["ability"]))
    )


def entropy(logits: Tensors, obs: Tensors) -> torch.Tensor:
    """Exact entropy of the conditional factorization: masked per-head
    entropies, sub-heads weighted by the probability of their action type."""
    logps = _head_logps(logits, obs)
    p_type = torch.exp(logps["action_type"])
    return (
        _entropy_head(logps["action_type"])
        + p_type[..., A_MOVE]
        * (_entropy_head(logps["move_x"]) + _entropy_head(logps["move_y"]))
        + p_type[..., A_ATTACK] * _entropy_head(logps["target_attack"])
        + p_type[..., A_CAST]
        * (_entropy_head(logps["target_cast"]) + _entropy_head(logps["ability"]))
    )
