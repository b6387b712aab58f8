"""Episode-outcome counters: the schema the device rollout's drained stats
fold into.

A copy of the names of ``dotaclient_tpu/outcome/records.py`` that the
device rollout, the host actor pool and the learner use: the buckets,
``REWARD_TERMS``, ``N_LEN_BUCKETS``, ``opponent_bucket``, ``len_bucket``,
``ensure_actor_metrics``, ``record_episode`` (a host pool's episode end),
``fold_device_stats`` (with ``add_reward_terms``), and ``counter_totals``, which the learner's
``OutcomeAggregator`` (``outcome/aggregator.py``) reads. Counters live under ``outcome/`` in the telemetry
registry with the reference's names. Episode length is counted in env steps
and histogrammed into power-of-two buckets (bucket i covers [2^i, 2^(i+1)),
the last one open-ended).
"""

from __future__ import annotations

from typing import Dict, Mapping

from dotaclient_tpu_torch.config import RewardConfig
from dotaclient_tpu_torch.utils import telemetry

# Who the learner's side played: a scripted bot, a frozen league snapshot,
# or its own mirror.
BUCKETS = ("vs_scripted", "vs_league", "vs_selfplay")

SIDES = ("radiant", "dire")

# Reward shaping terms: the RewardConfig field set, in table order.
REWARD_TERMS = tuple(RewardConfig().as_dict())

# 12 buckets reach 2^11 = 2048+ steps, past any configured horizon.
N_LEN_BUCKETS = 12


def opponent_bucket(opponent: str) -> str:
    """The bucket of a pool's games that are not anchor games, from the env
    opponent mode."""
    if opponent in ("scripted_easy", "scripted_hard"):
        return "vs_scripted"
    if opponent == "selfplay":
        return "vs_selfplay"
    return "vs_league"


def len_bucket(ep_len_steps: float) -> int:
    """The histogram bucket of one episode length (env steps)."""
    # host-sync-ok: a host int from the episode record
    n = max(int(ep_len_steps), 1)
    return min(n.bit_length() - 1, N_LEN_BUCKETS - 1)


def ensure_actor_metrics(reg: telemetry.Registry) -> None:
    """Create every actor-side outcome counter up front, so a snapshot
    carries the full (zeroed) set from the first one."""
    for bucket in BUCKETS:
        reg.counter(f"outcome/episodes/{bucket}")
        reg.counter(f"outcome/wins/{bucket}")
    for side in SIDES:
        reg.counter(f"outcome/episodes_side/{side}")
    reg.counter("outcome/ep_len_sum")
    for i in range(N_LEN_BUCKETS):
        reg.counter(f"outcome/ep_len_hist/{i:02d}")
    for term in REWARD_TERMS:
        reg.counter(f"outcome/reward_sum/{term}")


def record_episode(reg: telemetry.Registry, bucket: str, won: bool, ep_len_steps: float,
                   side: str = "radiant") -> None:
    """One finished episode into the counters (once a game, the owner
    lane's)."""
    reg.counter(f"outcome/episodes/{bucket}").inc()
    if won:
        reg.counter(f"outcome/wins/{bucket}").inc()
    reg.counter(f"outcome/episodes_side/{side}").inc()
    # host-sync-ok: a host float from the episode record
    reg.counter("outcome/ep_len_sum").inc(float(max(ep_len_steps, 0.0)))
    reg.counter(f"outcome/ep_len_hist/{len_bucket(ep_len_steps):02d}").inc()


def add_reward_terms(reg: telemetry.Registry, term_sums: Mapping[str, float]) -> None:
    """Accumulate weighted per-term reward sums into the decomposition
    counters."""
    for term, v in term_sums.items():
        if v:
            # host-sync-ok: host floats from the episode record
            reg.counter(f"outcome/reward_sum/{term}").inc(float(v))


def fold_device_stats(
    reg: telemetry.Registry,
    stats: Mapping[str, object],
    owner_side: str = "radiant",
) -> None:
    """Fold one drained window of the device rollout's stats (already on
    the host, game axis summed) into the outcome counters. Host arithmetic
    only."""
    episodes = 0.0
    for bucket in BUCKETS:
        # host-sync-ok: the drained stats are already on the host (the snapshot engine's one batched transfer)
        eps = float(stats.get(f"out_eps_{bucket}", 0.0))
        # host-sync-ok: the drained stats are already on the host
        wins = float(stats.get(f"out_wins_{bucket}", 0.0))
        if eps:
            reg.counter(f"outcome/episodes/{bucket}").inc(eps)
            episodes += eps
        if wins:
            reg.counter(f"outcome/wins/{bucket}").inc(wins)
    if episodes:
        # the device actor's episodes are all owner-side games
        reg.counter(f"outcome/episodes_side/{owner_side}").inc(episodes)
    # host-sync-ok: the drained stats are already on the host
    len_sum = float(stats.get("out_ep_len_sum", 0.0))
    if len_sum:
        reg.counter("outcome/ep_len_sum").inc(len_sum)
    hist = stats.get("out_ep_len_hist")
    if hist is not None:
        for i in range(N_LEN_BUCKETS):
            # host-sync-ok: the drained stats are already on the host
            v = float(hist[i])
            if v:
                reg.counter(f"outcome/ep_len_hist/{i:02d}").inc(v)
    terms = stats.get("out_reward_terms")
    if isinstance(terms, Mapping):
        # host-sync-ok: the drained stats are already on the host
        add_reward_terms(reg, {t: float(v) for t, v in terms.items()})


def counter_totals(counters: Mapping[str, float]) -> Dict[str, float]:
    """The outcome totals of a registry's counters: the process's own
    ``outcome/...`` counters plus every fleet peer's mirror
    (``fleet/<peer>/outcome/...``, already merged per peer, so the sum
    survives a peer's restart)."""
    totals: Dict[str, float] = {}
    for name, v in counters.items():
        if name.startswith("outcome/"):
            totals[name] = totals.get(name, 0.0) + v
        elif name.startswith("fleet/") and "/outcome/" in name:
            key = "outcome/" + name.split("/outcome/", 1)[1]
            totals[key] = totals.get(key, 0.0) + v
    return totals
