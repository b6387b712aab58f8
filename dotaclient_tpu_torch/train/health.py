"""Training health monitor: divergence verdicts off the hot path.

Counterpart of ``dotaclient_tpu/train/health.py``, the detect stage of the
guardian's detect -> contain -> recover loop:

* probe (``train/ppo.py``): every update computes ``health_ok`` =
  ``isfinite(loss) & isfinite(grad_norm)`` on the device; a run of updates
  folds it with a minimum (``fold_scan_metrics``);
* submit (train thread, no read of the device): :meth:`HealthMonitor.submit`
  appends one batch's verdict tensors to a pending deque;
* fold (snapshot thread, one batched copy a boundary): the learner hands
  the deque to the snapshot engine's never-coalesced stats backlog, which
  runs before the same cycle's publish and checkpoint jobs, so a version-V
  publish sees every verdict for steps <= V. With ``--sync-snapshots`` the
  learner folds the boundary's already-read scalars with
  :meth:`fold_host` instead.

The verdict latches: once unhealthy, the publish and checkpoint gates stay
closed until the learner's rollback calls :meth:`clear`, which bumps a
generation so that verdicts of the abandoned timeline are dropped.

Telemetry (eager-created): ``health/nonfinite_steps_total``,
``health/rollbacks_total``, ``health/last_good_step``,
``health/publish_blocked_total``, ``health/checkpoints_blocked_total``,
``health/ema_breaches_total`` and ``buffer/stale_rejected_total``.
"""

from __future__ import annotations

import logging
import math
import threading
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

from dotaclient_tpu_torch.config import HealthConfig
from dotaclient_tpu_torch.utils import telemetry

logger = logging.getLogger(__name__)

# Verdict scalars the probe ships per optimizer batch. grad_norm is the
# PRE-clip global norm (train/ppo.py) — the explosion band must see the
# raw magnitude, not the clipped one.
VERDICT_KEYS = ("loss", "grad_norm", "health_ok")

# Pending-verdict cap: between boundaries the deque holds one entry of
# three device scalars per consumed batch. A run configured with no
# boundaries in range (log_every=inf benches) must not grow it unboundedly;
# dropping the OLDEST entries is safe because non-finite params persist —
# every later verdict re-detects them (a transient EMA breach can be lost,
# which only delays band detection by one window).
_PENDING_CAP = 2048


class HealthEvent(NamedTuple):
    step: int
    version: int
    reason: str     # "nonfinite" | "explosion"
    value: float    # the offending scalar (loss or grad_norm)


class HealthMonitor:
    """Latching divergence detector fed by the in-graph probe."""

    def __init__(
        self,
        cfg: HealthConfig,
        registry: Optional[telemetry.Registry] = None,
    ) -> None:
        self.cfg = cfg
        self._tel = registry if registry is not None else telemetry.get_registry()
        self._lock = threading.Lock()
        self._pending: deque = deque(maxlen=_PENDING_CAP)
        self._gen = 0
        self._ema_grad: Optional[float] = None
        self._healthy_folds = 0
        self._unhealthy: Optional[HealthEvent] = None
        self._unrecoverable_warned = False
        # eager-created: a clean run reports zeros
        self._tel.counter("health/nonfinite_steps_total")
        self._tel.counter("health/rollbacks_total")
        self._tel.counter("health/ema_breaches_total")
        self._tel.counter("health/publish_blocked_total")
        self._tel.counter("health/checkpoints_blocked_total")
        self._tel.gauge("health/last_good_step")
        # owned by TrajectoryBuffer, created here too for fused runs,
        # which have no buffer
        self._tel.counter("buffer/stale_rejected_total")

    # -- train thread (no device traffic) -----------------------------------

    def submit(self, step: int, version: int, metrics: Any) -> None:
        """Queue one optimizer batch's verdict scalars (device arrays —
        program outputs; holding them is donation-safe). No fetch."""
        tree = {k: metrics[k] for k in VERDICT_KEYS if k in metrics}
        with self._lock:
            self._pending.append((self._gen, step, version, tree))

    def take_pending(self) -> List[Tuple[int, int, int, Any]]:
        """Drain the pending entries for one batched boundary fetch."""
        with self._lock:
            out = list(self._pending)
            self._pending.clear()
        return out

    @property
    def unhealthy(self) -> Optional[HealthEvent]:
        # lint-ok: thread-ownership(lock-free latch read: the event only
        # goes None -> set under the lock and stays until clear(); a stale
        # None delays the gate by one fold)
        return self._unhealthy

    def note_unrecoverable(self) -> bool:
        """First-call latch for the no-checkpoint degrade warning (a run
        without a checkpoint dir can contain — publishes stay blocked —
        but never recover). True exactly once."""
        if self._unrecoverable_warned:
            return False
        self._unrecoverable_warned = True
        return True

    def clear(self) -> None:
        """Rollback epilogue: unlatch and discard verdicts of the
        abandoned timeline (generation bump — folds of entries submitted
        before this call become no-ops). The EMA restarts its warmup: the
        restored run's gradient scale is re-learned, not inherited from
        the diverged one."""
        with self._lock:
            self._gen += 1
            self._pending.clear()
            self._unhealthy = None
            self._ema_grad = None
            self._healthy_folds = 0

    # -- fold side (snapshot thread, or train thread in sync mode) ----------

    def fold_batch(self, host_entries: List[Tuple[int, int, int, Any]]) -> None:
        """Fold one fetched batch of (gen, step, version, scalars) entries
        in submission order — the snapshot engine's stats-job entry point
        (the engine already did the one batched device-to-host copy)."""
        for gen, step, version, tree in host_entries:
            self._fold_one(gen, step, version, tree)

    def fold_host(self, step: int, version: int, scalars: Dict[str, Any]) -> None:
        """Fold already-fetched host scalars (the --sync-snapshots path:
        the boundary metrics fetch carries the verdict keys — no second
        transfer). Always folds with the CURRENT generation (``gen=None``
        below) — reading ``self._gen`` here would race ``clear()``, and
        sync-mode callers are by definition post-rollback callers of the
        live timeline (train/learner.py clears ``_last_verdict_m`` at
        rollback so no stale verdict can reach this path)."""
        if all(k in scalars for k in ("loss", "grad_norm")):
            self._fold_one(None, step, version, scalars)

    def _fold_one(
        self, gen: Optional[int], step: int, version: int, tree: Any
    ) -> None:
        """``gen=None`` means "the current generation" (the fold_host
        path); a concrete gen is compared against the latest clear()."""
        with self._lock:
            if (
                gen is not None and gen != self._gen
            ) or self._unhealthy is not None:
                return  # abandoned timeline, or already latched
            # host-sync-ok: the verdict tree arrives already fetched (the snapshot engine's one batched transfer)
            loss = float(tree["loss"])
            # host-sync-ok: already fetched host scalars
            gn = float(tree["grad_norm"])
            # host-sync-ok: already fetched host scalars
            ok = float(tree.get("health_ok", 1.0)) >= 0.5
            if not ok or not math.isfinite(loss) or not math.isfinite(gn):
                self._tel.counter("health/nonfinite_steps_total").inc()
                self._unhealthy = HealthEvent(
                    step, version, "nonfinite",
                    gn if not math.isfinite(gn) else loss,
                )
            elif (
                self._ema_grad is not None
                and self._healthy_folds >= self.cfg.warmup_steps
                and gn > self.cfg.explosion_band * max(self._ema_grad, 1e-8)
            ):
                self._tel.counter("health/ema_breaches_total").inc()
                self._unhealthy = HealthEvent(step, version, "explosion", gn)
            else:
                a = self.cfg.ema_alpha
                self._ema_grad = (
                    gn if self._ema_grad is None
                    else (1.0 - a) * self._ema_grad + a * gn
                )
                self._healthy_folds += 1
                return
        logger.warning(
            "health: divergence latched at step %d (version %d): %s "
            "(value %r) — weight publishes and periodic checkpoints are "
            "blocked until rollback",
            # lint-ok: thread-ownership(only reached by the thread that just
            # latched the event; latched values are immutable until clear)
            step, version, self._unhealthy.reason, self._unhealthy.value,
        )
