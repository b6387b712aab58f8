"""Generalized Advantage Estimation and V-trace as reverse loops over T.

Counterpart of ``dotaclient_tpu/train/gae.py`` (``gae``, ``vtrace``), where
each is a reverse ``scan``; here each is a loop over the T steps on [B]
tensors, in f32, on whatever device the inputs lie. ``dones[:, t]`` (the
episode ended at step t) cuts both the TD target and the accumulation, so a
chunk that spans episodes is handled exactly.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _reverse_accumulate(deltas: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """acc_t = deltas_t + decay_t * acc_{t+1}, acc_T = 0, over [B, T]."""
    T = deltas.shape[1]
    acc = torch.zeros_like(deltas[:, 0])
    out = [None] * T
    for t in reversed(range(T)):
        acc = deltas[:, t] + decay[:, t] * acc
        out[t] = acc
    return torch.stack(out, dim=1)


def gae(
    rewards: torch.Tensor,      # f32 [B, T]
    values: torch.Tensor,       # f32 [B, T+1], the bootstrap value last
    dones: torch.Tensor,        # bool/f32 [B, T], episode ended AT step t
    gamma: float,
    lam: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (advantages [B, T], returns [B, T])."""
    not_done = 1.0 - dones.to(torch.float32)
    deltas = rewards + gamma * not_done * values[:, 1:] - values[:, :-1]
    advantages = _reverse_accumulate(deltas, gamma * lam * not_done)
    return advantages, advantages + values[:, :-1]


def vtrace(
    rewards: torch.Tensor,        # f32 [B, T]
    values: torch.Tensor,         # f32 [B, T+1], the bootstrap value last
    dones: torch.Tensor,          # bool/f32 [B, T]
    behavior_logp: torch.Tensor,  # f32 [B, T], mu(a|s) at collection
    target_logp: torch.Tensor,    # f32 [B, T], pi(a|s) under current params
    gamma: float,
    rho_clip: float = 1.0,
    c_clip: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """V-trace targets and policy-gradient advantages (IMPALA): returns
    ``(pg_advantages, vs)``. The importance weights are consumed as
    constants (callers pass detached log-probs)."""
    not_done = 1.0 - dones.to(torch.float32)
    rho = torch.clamp(torch.exp(target_logp - behavior_logp), max=rho_clip)
    c = torch.clamp(torch.exp(target_logp - behavior_logp), max=c_clip)
    deltas = rho * (rewards + gamma * not_done * values[:, 1:] - values[:, :-1])
    corr = _reverse_accumulate(deltas, gamma * c * not_done)      # vs_t - V(s_t)
    vs = corr + values[:, :-1]
    # vs_{t+1}: the next step's target, the bootstrap V(s_T) at the end
    vs_next = torch.cat([vs[:, 1:], values[:, -1:]], dim=1)
    pg_adv = rho * (rewards + gamma * not_done * vs_next - values[:, :-1])
    return pg_adv, vs
