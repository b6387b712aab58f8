"""Utilization plane: phase accounting of the learner's, the actor pools' and
the batcher's threads.

Copy of ``dotaclient_tpu/utils/utilization.py``. Every wall-clock second of a thread goes to one phase of a closed set, from
intervals measured at the boundaries the code already has, and a fold
turns the window into fraction gauges that sum to 1.0 by construction (the
residual phase takes what the others did not claim):

* the learner's train thread: ``dispatch_inflight``, ``ingest_wait``,
  ``gather``, ``advantage_pass``, ``publish_stall``, ``checkpoint_stall``
  and the residual ``host_other``, folded at log boundaries
  (``util/phase/*``). The fold also keeps a steps/s EMA against a slow,
  warm-up-armed baseline: ``util/throughput_regression`` is 1 while the
  EMA sits below ``REGRESSION_RATIO`` x the baseline;
* the actor pools (the vec and the scalar one): ``env_step``,
  ``featurize``, ``encode``, ``ship_wait`` and the residual ``other``
  (``util/actor/*``), folded at a cadence at the pools' weights refreshes;
  an actor process ships them to the learner in its fleet snapshot
  (``fleet/<peer>/util/actor/*``);
* the serve batcher: ``window_wait``, ``dispatch``, ``reply`` and the
  residual ``other`` (``util/serve/*``), folded at a cadence.

Every phase is host wall clock, as in the reference. On the card the
learner issues its work asynchronously, so ``dispatch_inflight`` is the
host's time issuing an update (a host that runs ahead of the card waits
only when the allocator or a copy makes it), and ``util/duty_cycle``, its
share of the window, is the train thread's issue share, not the card's
busy share, which ``chip_smoke.py`` reads from a profiler window
(``PERF.md`` section 5).

The factories create their gauges first, so a record carries them from its
first line (``util/duty_cycle`` starts at the neutral 1.0, ``util/armed``
at 0). The reference's module knob ``enabled``, which turns the accountants
off for its overhead A/B, waits for a port benchmark that measures that
overhead (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional, Tuple

from dotaclient_tpu_torch.utils import telemetry

# steps/s smoothing: time-constant weighted EMAs (alpha = 1 - exp(-window /
# tau)), both seeded during warm-up with the cumulative rate over the whole
# warm-up span; the sentinel arms after WARMUP_WINDOWS folds
EMA_TAU_S = 30.0
BASELINE_TAU_S = 600.0
WARMUP_WINDOWS = 3
REGRESSION_RATIO = 0.7

LEARNER_PHASES = (
    "dispatch_inflight",
    "ingest_wait",
    "gather",
    "advantage_pass",
    "publish_stall",
    "checkpoint_stall",
    "host_other",
)
ACTOR_PHASES = ("env_step", "featurize", "encode", "ship_wait", "other")
SERVE_PHASES = ("window_wait", "dispatch", "reply", "other")


def ensure_learner_keys(reg: telemetry.Registry) -> Dict[str, telemetry.Gauge]:
    """Create the learner's ``util/*`` gauges; returns their handles."""
    handles = {key: reg.gauge(key) for key in (
        "util/armed",
        "util/duty_cycle",
        "util/steps_per_sec_ema",
        "util/steps_per_sec_baseline",
        "util/throughput_regression",
        # LEARNER_PHASES, spelled out so the telemetry-drift lint sees
        # every key (tests/test_torch_lint.py holds the two equal)
        "util/phase/dispatch_inflight",
        "util/phase/ingest_wait",
        "util/phase/gather",
        "util/phase/advantage_pass",
        "util/phase/publish_stall",
        "util/phase/checkpoint_stall",
        "util/phase/host_other",
    )}
    # neutral until the first fold
    if handles["util/armed"].value == 0.0:
        handles["util/duty_cycle"].set(1.0)
    return handles


def ensure_actor_keys(reg: telemetry.Registry) -> Dict[str, telemetry.Gauge]:
    """Eager-create the actor pools' ``util/actor/*`` phase gauges."""
    return {f"util/actor/{p}": reg.gauge(f"util/actor/{p}") for p in ACTOR_PHASES}


def ensure_serve_keys(reg: telemetry.Registry) -> Dict[str, telemetry.Gauge]:
    """Eager-create the serve-side ``util/serve/*`` phase gauges."""
    return {f"util/serve/{p}": reg.gauge(f"util/serve/{p}") for p in SERVE_PHASES}


class PhaseAccountant:
    """Monotonic interval accumulator over a closed phase set, owned by one
    thread. ``fold`` normalizes the window into per-phase fractions (the
    residual phase takes what the others did not claim) and resets it; the
    denominator is ``max(window, accounted)``, so clock noise shrinks the
    residual to 0 instead of pushing the sum past 1."""

    def __init__(
        self,
        gauges: Dict[str, telemetry.Gauge],
        phases: Tuple[str, ...],
        residual: str,
        now: Optional[float] = None,
    ) -> None:
        self._gauges = gauges
        self._phases = phases
        self._residual = residual
        self._acc: Dict[str, float] = {p: 0.0 for p in phases}
        self._window_start = time.perf_counter() if now is None else now

    def phase(self, name: str, seconds: float) -> None:
        if seconds > 0.0:
            self._acc[name] += seconds

    def fold(self, now: Optional[float] = None) -> Tuple[Dict[str, float], float]:
        """-> (phase fractions, window seconds); resets the window."""
        now = time.perf_counter() if now is None else now
        window = now - self._window_start
        if window <= 0.0:
            return {}, 0.0
        accounted = sum(self._acc.values())
        residual_s = max(0.0, window - accounted)
        denom = max(window, accounted)
        fractions: Dict[str, float] = {}
        for name in self._phases:
            v = residual_s if name == self._residual else self._acc[name]
            frac = v / denom
            self._gauges[name].set(frac)
            fractions[name] = frac
            self._acc[name] = 0.0
        self._window_start = now
        return fractions, window


class LearnerUtilization:
    """The learner's accountant and the throughput sentinel's state.
    ``fold(step)`` runs at log boundaries and at the end of ``train``."""

    def __init__(self, handles: Dict[str, telemetry.Gauge]) -> None:
        phase_gauges = {p: handles[f"util/phase/{p}"] for p in LEARNER_PHASES}
        self._acct = PhaseAccountant(phase_gauges, LEARNER_PHASES, residual="host_other")
        self._armed = handles["util/armed"]
        self._duty = handles["util/duty_cycle"]
        self._ema = handles["util/steps_per_sec_ema"]
        self._baseline = handles["util/steps_per_sec_baseline"]
        self._regression = handles["util/throughput_regression"]
        self._last_step: Optional[int] = None
        self._ema_v = 0.0
        self._baseline_v = 0.0
        self._windows = 0
        self._warm_steps = 0
        self._warm_span = 0.0

    def phase(self, name: str, seconds: float) -> None:
        self._acct.phase(name, seconds)

    def fold(self, step: int, now: Optional[float] = None) -> Dict[str, float]:
        fractions, window = self._acct.fold(now)
        if not fractions:
            return {}
        self._duty.set(fractions["dispatch_inflight"])
        self._armed.set(1.0)
        # a window in which the step did not move (the end of train
        # folding again at the final step) gives no rate sample
        if self._last_step is not None and step > self._last_step:
            rate = (step - self._last_step) / window
            self._windows += 1
            if self._windows <= WARMUP_WINDOWS:
                self._warm_steps += step - self._last_step
                self._warm_span += window
                self._ema_v = self._warm_steps / self._warm_span
                self._baseline_v = self._ema_v
            else:
                self._ema_v += (1.0 - math.exp(-window / EMA_TAU_S)) * (rate - self._ema_v)
                self._baseline_v += (1.0 - math.exp(-window / BASELINE_TAU_S)) * (rate - self._baseline_v)
            self._ema.set(self._ema_v)
            self._baseline.set(self._baseline_v)
            regressed = (self._windows > WARMUP_WINDOWS and self._baseline_v > 0.0
                         and self._ema_v < REGRESSION_RATIO * self._baseline_v)
            self._regression.set(1.0 if regressed else 0.0)
        self._last_step = step
        return fractions


class PoolUtilization:
    """Phase fractions with a cadence-gated fold."""

    def __init__(
        self,
        gauges: Dict[str, telemetry.Gauge],
        phases: Tuple[str, ...],
        prefix: str,
        interval_s: float,
    ) -> None:
        phase_gauges = {p: gauges[f"{prefix}{p}"] for p in phases}
        self._acct = PhaseAccountant(phase_gauges, phases, residual="other")
        # host-sync-ok: a host config float
        self._interval = max(0.25, float(interval_s))
        self._last_fold = time.perf_counter()

    def phase(self, name: str, seconds: float) -> None:
        self._acct.phase(name, seconds)

    def maybe_fold(self, now: Optional[float] = None) -> Optional[Dict[str, float]]:
        now = time.perf_counter() if now is None else now
        if now - self._last_fold < self._interval:
            return None
        self._last_fold = now
        fractions, _ = self._acct.fold(now)
        return fractions or None


def make_learner(registry: Optional[telemetry.Registry] = None) -> LearnerUtilization:
    """The learner's accountant, its gauges created first."""
    reg = registry if registry is not None else telemetry.get_registry()
    return LearnerUtilization(ensure_learner_keys(reg))


def make_actor(registry: Optional[telemetry.Registry] = None) -> PoolUtilization:
    """An actor pool's accountant, folding every ``telemetry.fleet_interval_s``."""
    reg = registry if registry is not None else telemetry.get_registry()
    return PoolUtilization(
        ensure_actor_keys(reg), ACTOR_PHASES, "util/actor/", telemetry.fleet_interval_s
    )


def make_serve(registry: Optional[telemetry.Registry] = None) -> PoolUtilization:
    """The batcher's accountant, folding every ``telemetry.fleet_interval_s``."""
    reg = registry if registry is not None else telemetry.get_registry()
    return PoolUtilization(
        ensure_serve_keys(reg), SERVE_PHASES, "util/serve/", telemetry.fleet_interval_s
    )
