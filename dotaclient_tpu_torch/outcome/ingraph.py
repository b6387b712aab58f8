"""Episode-outcome reductions done on the device, inside the rollout.

Counterpart of ``dotaclient_tpu/outcome/ingraph.py``. The rollout never
synchronises with the host per chunk, so outcomes are done-masked
reductions over the chunk's step axis, accumulated in the actor's
device-resident stats as per-game partials and read only when the stats are
drained. Every accumulated value is an exact small-integer count or length
in f32, so summing the game axis later is exact in any order.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from dotaclient_tpu_torch.outcome.records import BUCKETS, N_LEN_BUCKETS


def bucket_masks(
    n_games: int, opponent: str, n_anchor_games: int, device: torch.device
) -> Dict[str, torch.Tensor]:
    """Static per-game opponent-bucket masks [N] for one pool config:
    every game vs_scripted for the scripted modes, the mirror in self-play,
    and in a league the first ``n_anchor_games`` games scripted and the
    rest vs snapshots."""
    idx = torch.arange(n_games, device=device)
    zeros = torch.zeros(n_games, dtype=torch.bool, device=device)
    if opponent == "selfplay":
        scripted, league, selfplay = zeros, zeros, ~zeros
    elif opponent == "league":
        scripted = idx < n_anchor_games
        league, selfplay = ~scripted, zeros
    else:
        scripted, league, selfplay = ~zeros, zeros, zeros
    return {"vs_scripted": scripted, "vs_league": league, "vs_selfplay": selfplay}


def zero_outcome_stats(n_games: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The outcome slice of the actor's stats accumulator: per-game [N]
    counters and an [N, N_LEN_BUCKETS] length histogram."""
    z = torch.zeros((n_games,), dtype=torch.float32, device=device)
    out: Dict[str, torch.Tensor] = {}
    for bucket in BUCKETS:
        out[f"out_eps_{bucket}"] = z
        out[f"out_wins_{bucket}"] = z
    out["out_ep_len_sum"] = z
    out["out_ep_len_hist"] = torch.zeros((n_games, N_LEN_BUCKETS), dtype=torch.float32, device=device)
    return out


def chunk_outcome_partials(
    ep_done: torch.Tensor,
    win: torch.Tensor,
    ep_len: torch.Tensor,
    masks: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Done-masked per-game outcome reductions over one chunk.

    ``ep_done``/``win`` are bool ``[..., N]`` (leading step axes),
    ``ep_len`` the episode length in env steps where done (0 elsewhere),
    ``masks`` the per-game bucket masks (``None`` buckets every game
    vs_scripted). Only the leading axes are reduced: counters come out
    [N], the length histogram [N, N_LEN_BUCKETS]."""
    done_f = ep_done.to(torch.float32)
    win_f = (win & ep_done).to(torch.float32)
    lead = tuple(range(done_f.dim() - 1))
    n = ep_done.shape[-1]
    out: Dict[str, torch.Tensor] = {}
    for bucket in BUCKETS:
        if masks is None:
            fill = 1.0 if bucket == "vs_scripted" else 0.0
            mf = torch.full((n,), fill, dtype=torch.float32, device=ep_done.device)
        else:
            mf = masks[bucket].to(torch.float32)
        out[f"out_eps_{bucket}"] = (done_f * mf).sum(dim=lead)
        out[f"out_wins_{bucket}"] = (win_f * mf).sum(dim=lead)
    out["out_ep_len_sum"] = (ep_len.to(torch.float32) * done_f).sum(dim=lead)
    # power-of-two bucket index by exact integer compares:
    # idx = #{i >= 1 : len >= 2^i}, the host's bit_length - 1, clipped
    safe = torch.clamp(ep_len, min=1).to(torch.int32)
    idx = sum((safe >= (1 << i)).to(torch.int32) for i in range(1, N_LEN_BUCKETS))
    onehot = (idx[..., None] == torch.arange(N_LEN_BUCKETS, device=ep_len.device)).to(torch.float32)
    out["out_ep_len_hist"] = (onehot * done_f[..., None]).sum(dim=lead)
    return out
