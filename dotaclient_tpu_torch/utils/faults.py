"""Fault-injection registry: deterministic chaos for the pipeline's hot paths.

Copy of ``dotaclient_tpu/utils/faults.py`` (the port imports nothing of
the JAX package). Spec grammar (env var ``DOTA_FAULTS`` or
:func:`configure`): a comma-separated list of entries, each one of

* ``site@N``  -- trigger fault ``site`` on its Nth event (1-based, one-shot);
* ``site@N+M`` -- trigger on the Nth event and every Mth after it;
* ``site=V``  -- a value fault, read with :meth:`FaultRegistry.value`.

Sites wired in the port (grep for the literal to find the hook):

* ``learner.fail_train_step`` -- ``Learner._optimize`` raises on its Nth call;
* ``learner.nan_grad`` -- ``Learner._optimize`` poisons its Nth batch's
  rewards (and staged advantages) with NaN before the update: the
  divergence the health guardian (``train/health.py``) must detect,
  contain and roll back;
* ``checkpoint.fail_write`` -- ``CheckpointManager.save_host`` raises an
  injected ``OSError`` (a full disk) on its Nth call;
* ``checkpoint.corrupt_manifest`` -- the Nth manifest verification at
  restore fails as if the save were corrupt on disk (the walk-back path);
* ``transport.corrupt_frame`` -- ``SocketTransport.publish_rollout_bytes``
  writes its Nth frame with a wrong CRC trailer;
* ``transport.drop_conn`` -- ``SocketTransport.publish_rollout_bytes``
  closes its socket at its Nth frame (a lost connection: that send raises
  and the actor's reconnect takes over);
* ``transport.delay_send`` -- a value fault: seconds slept before every
  rollout frame is sent;
* ``actor.nonfinite_payload`` -- ``VecActorPool`` ships its Nth chunk with
  a NaN reward (the learner ring's admission check must drop it).

The registry is None when disabled: hot paths cache ``faults.get()`` once
at construction and pay one ``is not None`` test. Every firing is counted
in ``faults/injected_total``.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

_ENV = "DOTA_FAULTS"


class FaultSpecError(ValueError):
    pass


class FaultRegistry:
    """Parsed fault spec + per-site event counters (thread-safe)."""

    def __init__(self, spec: str) -> None:
        self.spec = spec
        self._at: Dict[str, int] = {}        # site -> first event that fires
        self._every: Dict[str, int] = {}     # site -> repeat period (0 = once)
        self._values: Dict[str, float] = {}  # site -> value fault
        self._counts: Dict[str, int] = {}    # site -> events observed
        self._fired: Dict[str, int] = {}     # site -> times actually fired
        self._lock = threading.Lock()
        for entry in spec.split(","):
            entry = entry.strip()
            if not entry:
                continue
            if "=" in entry:
                site, _, raw = entry.partition("=")
                try:
                    self._values[site.strip()] = float(raw)
                except ValueError as e:
                    raise FaultSpecError(
                        f"bad value fault {entry!r}: {e}"
                    ) from e
            elif "@" in entry:
                site, _, raw = entry.partition("@")
                raw, _, period = raw.partition("+")
                try:
                    at = int(raw)
                    every = int(period) if period else 0
                except ValueError as e:
                    raise FaultSpecError(
                        f"bad trigger fault {entry!r}: {e}"
                    ) from e
                if at < 1 or every < 0:
                    raise FaultSpecError(
                        f"bad trigger fault {entry!r}: N must be >= 1"
                    )
                self._at[site.strip()] = at
                self._every[site.strip()] = every
            else:
                raise FaultSpecError(
                    f"fault entry {entry!r} is neither site@N nor site=V"
                )

    def fire(self, site: str) -> bool:
        """Record one event at ``site``; True when the spec says to inject.

        Sites absent from the spec never fire (and cost one dict miss)."""
        at = self._at.get(site)
        if at is None:
            return False
        with self._lock:
            self._counts[site] = n = self._counts.get(site, 0) + 1
            every = self._every[site]
            hit = n == at or (every > 0 and n > at and (n - at) % every == 0)
            if hit:
                self._fired[site] = self._fired.get(site, 0) + 1
        if hit:
            from dotaclient_tpu_torch.utils import telemetry

            telemetry.get_registry().counter("faults/injected_total").inc()
        return hit

    def value(self, site: str, default: float = 0.0) -> float:
        """Value faults (``site=V``): the configured V, or ``default``."""
        return self._values.get(site, default)

    def fired(self, site: str) -> int:
        with self._lock:
            return self._fired.get(site, 0)


# Disabled == None: hot paths cache the result of get() and pay one
# ``is not None`` per event. Parsed lazily so importing this module costs
# nothing and subprocesses pick the spec up from their own environment.
_ACTIVE: Optional[FaultRegistry] = None
_LOADED = False
_LOAD_LOCK = threading.Lock()


def get() -> Optional[FaultRegistry]:
    """The process-wide registry, or None when fault injection is off."""
    global _ACTIVE, _LOADED
    if not _LOADED:
        with _LOAD_LOCK:
            if not _LOADED:
                spec = os.environ.get(_ENV, "")
                _ACTIVE = FaultRegistry(spec) if spec.strip() else None
                _LOADED = True
    return _ACTIVE


def configure(spec: Optional[str]) -> Optional[FaultRegistry]:
    """Install a spec programmatically (tests; None disables). Overrides the
    environment. NOTE: components cache ``get()`` at construction, so
    configure BEFORE building the transports/learner under test."""
    global _ACTIVE, _LOADED
    with _LOAD_LOCK:
        _ACTIVE = FaultRegistry(spec) if spec and spec.strip() else None
        _LOADED = True
    return _ACTIVE
