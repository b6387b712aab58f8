"""The learner's outcome curves: counter totals into windowed gauges.

Copy of ``dotaclient_tpu/outcome/aggregator.py``. ``OutcomeAggregator.tick``
is a host pass over the telemetry registry: it collapses the outcome
counter totals (the process's own ``outcome/`` counters, which the device
actor's stat drains fold into, and every ``fleet/<peer>/outcome/...``
mirror) into a sliding window and publishes the curves as gauges. It has
no thread and reads nothing from the device. The in-process learner ticks
it at log boundaries (after the stat drain, so a line's curves match its
counters); in the external mode the fleet aggregator's thread ticks it.
Both callers go through one lock.

Gauges, created at construction so every learner record carries them:

* ``outcome/win_rate/{vs_scripted,vs_league,overall}``: windowed win
  rates, starting at the neutral prior 0.5 and moved only once a window
  holds ``min_episodes`` episodes of that bucket;
* ``outcome/episode_len_p50``: the window's median episode length (env
  steps) from the power-of-two histogram, 0 until armed;
* ``outcome/episode_len_anomaly``: 1 while the armed p50 sits below
  ``ep_len_floor`` (instant-reset episodes);
* ``outcome/reward/<term>``: the window's mean per episode of each
  weighted shaping term;
* ``outcome/episodes_total``, ``outcome/episodes_recent``;
* ``outcome/stream_age_s``: seconds since the episode total last moved,
  -1 until the first episode.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, Optional, Tuple

from dotaclient_tpu_torch.outcome.records import BUCKETS, N_LEN_BUCKETS, REWARD_TERMS, counter_totals
from dotaclient_tpu_torch.utils import telemetry

__all__ = ["OutcomeAggregator"]

# the two attributable buckets and the overall rate (vs_selfplay alone is
# ~0.5 by construction and reads from "overall")
_RATE_BUCKETS = ("vs_scripted", "vs_league", "overall")


class OutcomeAggregator:
    """Windowed outcome curves over the registry's outcome counters."""

    def __init__(
        self,
        registry: Optional[telemetry.Registry] = None,
        window_s: float = 120.0,
        min_episodes: int = 8,
        # the histogram p50 is a bucket's upper bound, at least 2: a
        # bucket-0 median (one-step episodes) is the degenerate reset
        ep_len_floor: float = 4.0,
    ) -> None:
        self._reg = registry if registry is not None else telemetry.get_registry()
        self.window_s = float(window_s)
        self.min_episodes = int(min_episodes)
        self.ep_len_floor = float(ep_len_floor)
        self._lock = threading.Lock()
        # (t, totals) samples spanning the window; the oldest is the base
        self._samples: Deque[Tuple[float, Dict[str, float]]] = deque()
        self._armed = False
        self._last_total_eps = 0.0
        self._last_episode_t = 0.0
        for bucket in _RATE_BUCKETS:
            self._reg.gauge(f"outcome/win_rate/{bucket}").set(0.5)
        self._reg.gauge("outcome/episode_len_p50")
        self._reg.gauge("outcome/episode_len_anomaly")
        self._reg.gauge("outcome/stream_age_s").set(-1.0)
        self._reg.gauge("outcome/episodes_total")
        self._reg.gauge("outcome/episodes_recent")
        for term in REWARD_TERMS:
            self._reg.gauge(f"outcome/reward/{term}")

    def tick(self, now: Optional[float] = None) -> None:
        """One pass: sample the totals, slide the window, publish."""
        if now is None:
            now = time.monotonic()
        counters, _ = self._reg.counters_and_gauges()
        totals = counter_totals(counters)
        with self._lock:
            if not self._samples:
                # an empty base: the first window covers every episode
                # since construction
                self._samples.append((now, {}))
            self._samples.append((now, totals))
            while len(self._samples) > 2 and now - self._samples[0][0] > self.window_s:
                self._samples.popleft()
            base = self._samples[0][1]
            delta = {k: totals.get(k, 0.0) - base.get(k, 0.0) for k in totals}
            self._publish(now, totals, delta)

    @staticmethod
    def _total_eps(d: Dict[str, float]) -> float:
        return sum(d.get(f"outcome/episodes/{b}", 0.0) for b in BUCKETS)

    def _publish(self, now: float, totals: Dict[str, float], delta: Dict[str, float]) -> None:
        total_eps = self._total_eps(totals)
        d_eps = self._total_eps(delta)
        self._reg.gauge("outcome/episodes_total").set(total_eps)
        self._reg.gauge("outcome/episodes_recent").set(d_eps)
        # armed at the first episode; the age runs from the last tick that
        # saw the total move
        if total_eps > self._last_total_eps or (total_eps > 0 and not self._armed):
            self._armed = True
            self._last_episode_t = now
        self._last_total_eps = total_eps
        self._reg.gauge("outcome/stream_age_s").set(now - self._last_episode_t if self._armed else -1.0)
        for bucket in _RATE_BUCKETS:
            if bucket == "overall":
                eps, wins = d_eps, sum(delta.get(f"outcome/wins/{b}", 0.0) for b in BUCKETS)
            else:
                eps = delta.get(f"outcome/episodes/{bucket}", 0.0)
                wins = delta.get(f"outcome/wins/{bucket}", 0.0)
            if eps >= self.min_episodes:
                self._reg.gauge(f"outcome/win_rate/{bucket}").set(wins / eps)
        if d_eps >= self.min_episodes:
            p50 = self._hist_p50(delta)
            self._reg.gauge("outcome/episode_len_p50").set(p50)
            self._reg.gauge("outcome/episode_len_anomaly").set(1.0 if p50 < self.ep_len_floor else 0.0)
        if d_eps > 0:
            for term in REWARD_TERMS:
                self._reg.gauge(f"outcome/reward/{term}").set(delta.get(f"outcome/reward_sum/{term}", 0.0) / d_eps)

    @staticmethod
    def _hist_p50(delta: Dict[str, float]) -> float:
        counts = [delta.get(f"outcome/ep_len_hist/{i:02d}", 0.0) for i in range(N_LEN_BUCKETS)]
        total = sum(counts)
        if total <= 0:
            return 0.0
        seen = 0.0
        for i, c in enumerate(counts):
            seen += c
            if seen >= total / 2.0:
                # host-sync-ok: host ints
                return float(2 ** (i + 1))   # the bucket's upper bound
        # host-sync-ok: host ints
        return float(2 ** N_LEN_BUCKETS)
