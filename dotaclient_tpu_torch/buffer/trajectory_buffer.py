"""The trajectory ring: rollout chunks in device memory, consumed oldest first.

Counterpart of ``dotaclient_tpu/buffer/trajectory_buffer.py``, its device
path. One slot holds one rollout chunk laid out as a row of
``train.ppo.example_batch`` (obs ``[T+1, ...]``, actions, rewards, ...
``[T]``, ``carry0`` ``([H], [H])``), so a consumed batch of B slots is a
train batch. The store is one tensor a leaf on the learner's device.

The bookkeeping is host-side and reads only host ints: the consumption
order is a deque of slot ids, beside a free list, a per-slot producer
version (staleness is re-checked when a batch is taken: a chunk fresh at
ingest can go stale in the ring) and held batches (the prefetch lane's
tickets, out of both the order and the free list until released or
requeued). Ingest (``add_device``) is one device-to-device ``index_copy_``
a leaf, and a take is one ``index_select`` a leaf; their slot indices
reach the device through pinned memory (``device.host_index``), so neither
reads the device from the host.

The staleness limit is counted in optimizer steps: ``max_staleness x
steps_per_batch``, or ``buffer.max_weight_staleness`` when it is >= 0.

Not ported here: the host-row ``add`` of the ``vec`` and ``external``
modes, with its staging lanes and its admission checks (non-finite payloads,
integer bounds, config skew), and the narrow (bf16) ring of
``transport.rollout_wire_dtype``; both come with ROADMAP queue 1, item 4b.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from dotaclient_tpu_torch.actor.device_rollout import tree_map
from dotaclient_tpu_torch.config import RunConfig
from dotaclient_tpu_torch.device import DeviceLike, host_index, resolve_device
from dotaclient_tpu_torch.train.ppo import example_batch
from dotaclient_tpu_torch.utils import telemetry

_NOT_PORTED = "ROADMAP queue 1, item 4b (external actors and the learner's transports)"
_N_COUNTERS = 7   # warmed, stale, overflow, ingested, skew, nonfinite, bounds


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, tuple):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


class TrajectoryBuffer:
    """FIFO ring of rollout chunks in device memory, consumed once each,
    with version-based staleness checks."""

    def __init__(self, config: RunConfig, device: DeviceLike = None,
                 registry: Optional[telemetry.Registry] = None) -> None:
        if config.transport.rollout_wire_dtype != "float32":
            raise NotImplementedError(
                f"a narrow ring (rollout_wire_dtype={config.transport.rollout_wire_dtype!r}) is not ported "
                f"yet: {_NOT_PORTED}"
            )
        self.config = config
        self.device = resolve_device(device)
        self._tel = registry if registry is not None else telemetry.get_registry()
        cap = config.buffer.capacity_rollouts
        self.capacity = cap
        self._staleness_limit = (
            config.buffer.max_weight_staleness
            if config.buffer.max_weight_staleness >= 0
            else config.ppo.max_staleness * config.ppo.steps_per_batch
        )
        for key in ("buffer/stale_rejected_total", "buffer/nonfinite_rejected_total",
                    "buffer/poison_dropped_total", "buffer/intbound_rejected_total"):
            self._tel.counter(key)
        self._store = example_batch(config, cap, device=self.device)
        self._tel.gauge("buffer/shard_bytes").set(
            float(sum(t.numel() * t.element_size() for t in tree_leaves(self._store))))
        self._order: Deque[int] = deque()
        self._free: List[int] = list(range(cap - 1, -1, -1))
        self._held: Dict[int, List[int]] = {}
        self._next_ticket = 0
        self._warmed = False       # min_fill reached at least once
        self._slot_version = np.zeros((cap,), np.int64)
        self.dropped_stale = 0
        self.dropped_overflow = 0
        self.dropped_skew = 0
        self.dropped_nonfinite = 0
        self.dropped_bounds = 0
        self.ingested = 0

    @property
    def size(self) -> int:
        return len(self._order)

    @property
    def ready(self) -> bool:
        return self.size >= max(self.config.buffer.min_fill, self.config.ppo.batch_rollouts)

    # -- ingest ------------------------------------------------------------

    def add(self, rollouts, current_version: int) -> int:
        """The host-row ingest of decoded rollouts (``vec`` and ``external``
        modes): not ported yet."""
        raise NotImplementedError(f"TrajectoryBuffer.add (host rows) is not ported yet: {_NOT_PORTED}")

    def _alloc_slots(self, n: int) -> List[int]:
        """Up to ``n`` writable slots: free slots first, then the oldest
        unconsumed (counted in ``dropped_overflow``). Held slots are in
        neither pool, so when both run dry the rest is dropped (counted)."""
        slots: List[int] = []
        for k in range(n):
            if self._free:
                slots.append(self._free.pop())
            elif self._order:
                slots.append(self._order.popleft())
                self.dropped_overflow += 1
            else:
                self.dropped_overflow += n - k
                break
        return slots

    def add_device(self, chunk: Dict[str, Any], version: int) -> int:
        """Ingest a device-resident chunk batch (``[L, T, ...]``, the
        device rollout's output) with one device-to-device copy a leaf.
        The chunks were made with the current params, so no staleness
        filter runs here; the slots are version-tagged for the checks at
        take. Returns the number of rows kept."""
        with self._tel.span("buffer/insert"):
            L = chunk["valid"].shape[0]
            take = min(L, self.capacity)
            if take < L:
                self.dropped_overflow += L - take
            slots = self._alloc_slots(take)
            take = len(slots)
            if not take:
                self._publish_telemetry()
                return 0
            idx = host_index(slots, self.device)
            tree_map(lambda s, r: s.index_copy_(0, idx, r[:take].to(s.dtype)), self._store, chunk)
            self._slot_version[slots] = version
            self._order.extend(slots)
            self.ingested += take
        self._publish_telemetry()
        return take

    # -- consume -----------------------------------------------------------

    def take(self, batch_size: Optional[int] = None, current_version: Optional[int] = None,
             hold: bool = False) -> Optional[Any]:
        """The oldest ``batch_size`` chunks as a train batch (device
        tensors), or None when underfilled or before ``min_fill`` was first
        reached. With ``current_version`` every unconsumed slot more than
        the staleness limit behind is dropped first (all slots are scanned:
        ship order is not version order). With ``hold`` the return is
        ``(batch, ticket)`` and the slots are parked until :meth:`release`
        (trained on) or :meth:`requeue` (returned untrained to the front)."""
        b = batch_size or self.config.ppo.batch_rollouts
        if current_version is not None:
            max_st = self._staleness_limit
            stale = [s for s in self._order if current_version - self._slot_version[s] > max_st]
            if stale:
                stale_set = set(stale)
                self._order = deque(s for s in self._order if s not in stale_set)
                self._free.extend(stale)
                self.dropped_stale += len(stale)
                self._tel.counter("buffer/stale_rejected_total").inc(len(stale))
        if not self._warmed:
            if not self.ready:
                return None
            self._warmed = True
        if self.size < b:
            return None
        with self._tel.span("buffer/sample"):
            slots = [self._order.popleft() for _ in range(b)]
            idx = host_index(slots, self.device)
            batch = tree_map(lambda s: s.index_select(0, idx), self._store)
            if hold:
                ticket = self._next_ticket
                self._next_ticket += 1
                self._held[ticket] = slots
            else:
                self._free.extend(slots)
        if current_version is not None:
            # how far behind the optimizer the batch's experience is, in
            # optimizer steps (host ints)
            self._tel.gauge("buffer/batch_staleness").set(
                float(current_version - self._slot_version[slots].mean()))
        self._publish_telemetry()
        return (batch, ticket) if hold else batch

    def release(self, ticket: int) -> None:
        """The held batch was trained on: its slots become reusable. An
        already-cleared ticket is a no-op."""
        self._free.extend(self._held.pop(ticket, ()))

    def requeue(self, ticket: int) -> None:
        """The held batch was not trained on: its slots return to the front
        of the order in their original order."""
        self._order.extendleft(reversed(self._held.pop(ticket, ())))

    def drop_newer_than(self, version: int) -> int:
        """Rollback hygiene: drop every unconsumed slot whose producer
        version is newer than ``version`` (experience of the abandoned,
        poisoned timeline), counted in ``buffer/poison_dropped_total``.
        Held slots must be requeued by the caller first."""
        bad = [s for s in self._order if self._slot_version[s] > version]
        if bad:
            bad_set = set(bad)
            self._order = deque(s for s in self._order if s not in bad_set)
            self._free.extend(bad)
            self._tel.counter("buffer/poison_dropped_total").inc(len(bad))
            self._publish_telemetry()
        return len(bad)

    def requeue_all_held(self) -> None:
        """Park nothing across a snapshot: newest tickets first, so the
        oldest held batch ends up at the very front."""
        for ticket in sorted(self._held, reverse=True):
            self.requeue(ticket)

    # -- checkpointing -----------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        """The ring's contents and bookkeeping as CPU tensors (a read of
        the device). Held batches are folded back into the order first."""
        def padded(vals) -> torch.Tensor:
            out = torch.full((self.capacity,), -1, dtype=torch.int64)
            vals = list(vals)
            out[: len(vals)] = torch.as_tensor(vals, dtype=torch.int64)
            return out

        self.requeue_all_held()
        return {
            "store": tree_map(lambda t: t.detach().cpu().clone(), self._store),
            "order": padded(self._order),
            "free": padded(self._free),
            "slot_version": torch.from_numpy(self._slot_version.copy()),
            "counters": torch.as_tensor(
                [int(self._warmed), self.dropped_stale, self.dropped_overflow, self.ingested,
                 self.dropped_skew, self.dropped_nonfinite, self.dropped_bounds], dtype=torch.int64),
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self._store = tree_map(lambda s, x: torch.as_tensor(x).to(device=self.device, dtype=s.dtype).clone(),
                               self._store, state["store"])
        self._order = deque(int(s) for s in np.asarray(state["order"]) if s >= 0)
        self._free = [int(s) for s in np.asarray(state["free"]) if s >= 0]
        self._held = {}
        self._slot_version = np.asarray(state["slot_version"], dtype=np.int64).copy()
        counters = [int(v) for v in np.asarray(state["counters"])]
        counters += [0] * (_N_COUNTERS - len(counters))
        (warmed, self.dropped_stale, self.dropped_overflow, self.ingested, self.dropped_skew,
         self.dropped_nonfinite, self.dropped_bounds) = counters[:_N_COUNTERS]
        self._warmed = bool(warmed)
        self._publish_telemetry()

    def _publish_telemetry(self) -> None:
        """Mirror the host bookkeeping into the registry (host writes)."""
        for key, value in (("occupancy", self.size), ("capacity", self.capacity), ("ingested", self.ingested),
                           ("dropped_stale", self.dropped_stale), ("dropped_overflow", self.dropped_overflow),
                           ("dropped_skew", self.dropped_skew), ("dropped_nonfinite", self.dropped_nonfinite),
                           ("dropped_bounds", self.dropped_bounds)):
            self._tel.gauge(f"buffer/{key}").set(float(value))

    def metrics(self) -> Dict[str, float]:
        return {
            "buffer_size": float(self.size),
            "buffer_ingested": float(self.ingested),
            "buffer_dropped_stale": float(self.dropped_stale),
            "buffer_dropped_overflow": float(self.dropped_overflow),
            "buffer_dropped_skew": float(self.dropped_skew),
            "buffer_dropped_nonfinite": float(self.dropped_nonfinite),
            "buffer_dropped_bounds": float(self.dropped_bounds),
        }


__all__ = ["TrajectoryBuffer", "tree_leaves"]
