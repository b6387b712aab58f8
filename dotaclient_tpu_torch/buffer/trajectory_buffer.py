"""The trajectory ring: rollout chunks in device memory, consumed oldest first.

Counterpart of ``dotaclient_tpu/buffer/trajectory_buffer.py``, its device
path. One slot holds one rollout chunk laid out as a row of
``train.ppo.example_batch`` (obs ``[T+1, ...]``, actions, rewards, ...
``[T]``, and ``carry0`` in f32: ``([H], [H])`` for the LSTM core, ``([W],
(([W, H], [W, H]),) x n_layers)`` for the transformer core), so a consumed
batch of B slots is a train batch. The store is one tensor a leaf on the
learner's device.

With ``transport.rollout_wire_dtype="bfloat16"`` the ring stores the wire
dtypes (``serialize.rollout_cast_plan``: bf16 for the f32 leaves off the
pinned list, int8 or int16 for the bounded int leaves), about half the
resident bytes, and ``take`` widens each leaf on the device right after its
``index_select``, so the train step sees f32 and int32 bit for bit what
decoding the wire with ``upcast`` gives (bf16 -> f32 and int8 -> int32 are
exact).

The bookkeeping is host-side and reads only host ints: the consumption
order is a deque of slot ids, beside a free list, a per-slot producer
version (staleness is re-checked when a batch is taken: a chunk fresh at
ingest can go stale in the ring) and held batches (the prefetch lane's
tickets, out of both the order and the free list until released or
requeued). A take is one ``index_select`` a leaf; its slot indices reach
the device through pinned memory (``device.host_index``), so it never reads
the device from the host.

Two ingests. ``add_device`` (the ``device`` mode) puts a device-resident
chunk batch in with one device-to-device ``index_copy_`` a leaf. ``add``
(the ``vec`` and ``external`` modes) takes decoded host rows ``(meta,
arrays)`` through the admission door, in the reference's order: stale
(``model_version`` past the limit), skew (another tree, shape or dtype:
an actor with another config; warned once; a leaf may arrive at its full
width or at its bf16 wire's narrow one, whatever the ring stores), bounds
(a full-width int row into a narrow ring whose values do not fit the
narrow dtype, which the cast would wrap; warned once) and non-finite (a NaN
or Inf in a float leaf, bf16 ones scanned as they are, with
``buffer.reject_nonfinite``); each drop is counted. The rows that pass are
copied into the next of ``buffer.staging_slots`` preallocated host lanes
of the store's dtypes (pinned on CUDA; a full-width row into a narrow lane
rounds as the wire does) and cross to the card in one non-blocking copy a
leaf, then one ``index_copy_`` a leaf; a lane is reused only after its
copy's event has completed.

The staleness limit is counted in optimizer steps: ``max_staleness x
steps_per_batch``, or ``buffer.max_weight_staleness`` when it is >= 0.

Tracing (``utils/tracing.py``): with a tracer configured when the ring is
built, a traced row's record (``meta["trace"]``) gets its ``admit`` hop at
insertion and stays with its slot; ``take`` stamps ``gather`` and parks
the records until the learner's ``drain_traces`` stamps ``dispatch``. An
untraced row, a device chunk and a restore clear the slots they write, so
a reused slot never carries an evicted chunk's record. A requeued batch's
records go with the next dispatch, as in the reference.

``state_dict`` holds the store at its dtypes; ``load_state_dict`` restores
a snapshot of either wire dtype into this ring's (floats rounded as a fresh
ingest), and frees, counted in ``dropped_bounds``, the slots whose int
values would wrap in a narrow ring.

Data parallelism (``mesh`` with more than one batch shard): each rank's
ring is its shard, ``capacity_rollouts / n`` slots, and a take is its
``batch_rollouts / n`` oldest chunks (both must divide, with the
reference's messages); ``buffer/shard_bytes`` is the rank's resident bytes.
``state_dict`` is then the whole ring's, gathered over the host group
(gloo; every rank calls it): the ranks' slots end to end, and an order that
takes each rank's next batch share in rank order, so a ring of one rank
restoring it takes the same batches. ``load_state_dict`` cuts such a
snapshot back: order positions go to ranks a batch share at a time, and
each rank copies its chunks into its own slots, oldest first (a snapshot
whose chunks do not split evenly drops the newest few, counted in
``dropped_overflow``).

The single door (``host_fed`` on a mesh of more than one rank: the
``external``, ``vec`` and ``scalar`` modes). Host rows arrive one by one
with their own versions, so per-rank FIFOs would let one rank's stale drop
or eviction shift which rows form the next global batch. The reference has
one ring, one door and one FIFO, and so does this mode: rank 0 alone runs
the door and the whole ring's bookkeeping (order, versions, free slots,
held tickets, every counter) over the global slots ``[0, capacity)``,
exactly as a world-1 ring does, drops included; a global slot ``g`` lives
on batch shard ``g // (capacity / n)`` (on every model rank of that
shard), so each rank's device holds ``capacity / n`` slots
(``buffer/shard_bytes``). An admitted row takes a free slot on the shard
whose batch share its order position falls in (position ``p`` goes to
shard ``(p // (B/n)) % n``; a take moves every position by whole batches,
so the choice holds until a stale drop or an eviction shifts it), and its
bytes go from rank 0 to that shard's ranks alone (a gloo scatter of
packed rows). A take is one decision on rank 0, broadcast with the slots
it gathers (every rank learns whether there is a batch, and the prefetch
lane's holds, releases and requeues stay rank 0's); a rank gathers its
share from its own slots, and a row whose position has moved to another
shard crosses through the host (a copy to the host, a gloo send, a copy
to the card). Every rank calls ``add``, ``take`` and ``state_dict`` at the
same point (the others' rows are ignored), from the train thread. A
snapshot is the whole ring's in the world-1 layout (the global slots end
to end), so any world size restores it.
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from dotaclient_tpu_torch.config import RunConfig
from dotaclient_tpu_torch.device import DeviceLike, host_index, resolve_device
from dotaclient_tpu_torch.parallel.collectives import (
    all_gather_rows, broadcast_host, exchange_host, scatter_host,
)
from dotaclient_tpu_torch.parallel.mesh import Mesh, batch_index, batch_shard_count
from dotaclient_tpu_torch.train.ppo import example_batch
from dotaclient_tpu_torch.transport.serialize import (
    BF16, _dtype_name, _to_f32, apply_cast_plan, bf16_tensor_to_bits, f32_to_bf16_bits, flatten_tree,
    rollout_cast_plan, rollout_int_bounds, unflatten_tree,
)
from dotaclient_tpu_torch.utils import telemetry, tracing
from dotaclient_tpu_torch.utils.tree import tree_leaves, tree_map

logger = logging.getLogger(__name__)

_N_COUNTERS = 7   # warmed, stale, overflow, ingested, skew, nonfinite, bounds
_FINITE_SLICE = 1 << 16   # elements a bf16 leaf's finiteness scan takes at once


class TrajectoryBuffer:
    """FIFO ring of rollout chunks in device memory, consumed once each,
    with version-based staleness checks."""

    def __init__(self, config: RunConfig, device: DeviceLike = None,
                 registry: Optional[telemetry.Registry] = None, mesh: Optional[Mesh] = None,
                 host_fed: bool = False) -> None:
        self.config = config
        self.device = resolve_device(device)
        self._tel = registry if registry is not None else telemetry.get_registry()
        cap = config.buffer.capacity_rollouts
        n = batch_shard_count(mesh, config.mesh) if mesh is not None else 1
        # the single door: host rows on a mesh of more than one rank
        self._door = host_fed and mesh is not None and mesh.size > 1
        if n > 1:
            desc = "×".join(f"{a}={mesh.shape[a]}" for a in mesh.batch_axis_names)
            if cap % n:
                raise ValueError(f"buffer capacity {cap} not divisible by the batch shard count {n} ({desc})")
            if config.ppo.batch_rollouts % n:
                raise ValueError(
                    f"batch_rollouts {config.ppo.batch_rollouts} not divisible by the batch shard count {n} "
                    f"({desc}; batches are sharded over these axes)")
        self._n_shards = n
        self._shard = batch_index(mesh, config.mesh) if n > 1 else 0
        self._host_group = mesh.batch_host_group if n > 1 else None
        self._local_cap = cap // n                            # this rank's slots
        self._share = config.ppo.batch_rollouts // n          # this rank's share of a batch
        # rank 0 keeps the bookkeeping of the door's whole ring; elsewhere it
        # stays empty
        self._leader = not self._door or mesh.rank == 0
        if self._door:
            self._all_group = mesh.all_host_group
            self._rank = mesh.rank
            self._model_ranks = mesh.size // n                # the ranks of one batch shard
            self.capacity = cap                               # the ledger's slots
            self.batch_size = config.ppo.batch_rollouts
            self._min_fill = config.buffer.min_fill
        else:
            self.capacity = self._local_cap
            self.batch_size = self._share
            self._min_fill = -(-config.buffer.min_fill // n)
        cap = self.capacity
        self._staleness_limit = (
            config.buffer.max_weight_staleness
            if config.buffer.max_weight_staleness >= 0
            else config.ppo.max_staleness * config.ppo.steps_per_batch
        )
        for key in ("buffer/stale_rejected_total", "buffer/nonfinite_rejected_total",
                    "buffer/poison_dropped_total", "buffer/intbound_rejected_total"):
            self._tel.counter(key)
        # the train batch's layout and dtypes (take's widening targets), and
        # the wire's cast plan: empty for a full-width ring
        template = example_batch(config, self._local_cap, device=self.device)
        flat = flatten_tree(template)
        names = {n: _dtype_name(t) for n, t in flat.items()}
        int_bounds = rollout_int_bounds(config)
        self._wire_plan = rollout_cast_plan(names, config.transport.rollout_wire_dtype, int_bounds)
        self._consume_dtypes = tree_map(lambda t: t.dtype, template)
        self._store = unflatten_tree(apply_cast_plan(flat, self._wire_plan)) if self._wire_plan else template
        self._tel.gauge("buffer/shard_bytes").set(
            float(sum(t.numel() * t.element_size() for t in tree_leaves(self._store))))
        self._order: Deque[int] = deque()
        self._free: List[int] = list(range(cap - 1, -1, -1)) if self._leader else []
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
        # the single door: rows that crossed shards at a take (every rank's
        # count of the job's)
        self.rows_moved = 0
        # the host-row door: each leaf's name, row shape and the widths it
        # may arrive at (its full width, or the bf16 wire's narrowing of it)
        narrow = self._wire_plan or rollout_cast_plan(names, "bfloat16", int_bounds)
        self._tmpl: Dict[str, Tuple[Tuple[int, ...], frozenset]] = {
            n: (tuple(t.shape[1:]), frozenset({names[n], narrow.get(n, names[n])})) for n, t in flat.items()
        }
        # the bounds door: each int leaf the ring stores narrow, with the
        # range of its narrow dtype
        self._int_guards: Dict[str, np.iinfo] = {n: np.iinfo(d) for n, d in self._wire_plan.items() if d != BF16}
        self._reject_nonfinite = config.buffer.reject_nonfinite
        self._skew_warned = False
        self._bounds_warned = False
        # staging lanes, made at the first host-row ingest (the device
        # path never stages); each with the event of its last copy
        self._staging_lanes = max(1, config.buffer.staging_slots)
        self._staging: Optional[List[Dict[str, torch.Tensor]]] = None
        self._staging_events: List[Optional[torch.cuda.Event]] = [None] * self._staging_lanes
        self._staging_idx = 0
        # captured once: with tracing off every ingest and take pays one
        # pointer test
        self._tracer = tracing.get()
        self._slot_trace: Optional[List[Optional[dict]]] = [None] * cap if self._tracer is not None else None
        self._pending_traces: List[dict] = []
        # a row's packed bytes (the door's scatter and moves): each leaf's
        # name, row shape, dtype and bytes, in the store's leaf order
        self._row_layout = [(name, tuple(t.shape[1:]), t.dtype, t[0].numel() * t.element_size())
                            for name, t in flatten_tree(self._store).items()]
        self._row_bytes = sum(nb for *_, nb in self._row_layout)

    @property
    def size(self) -> int:
        return len(self._order)

    @property
    def ready(self) -> bool:
        return self.size >= max(self._min_fill, self.batch_size)

    # -- ingest ------------------------------------------------------------

    def add(self, rollouts: List[Tuple[Dict[str, Any], Any]], current_version: int) -> int:
        """Ingest decoded host rows ``(meta, arrays)`` through the door
        (stale, skew, non-finite, each counted); returns the number
        kept. One staging copy a row, one host-to-device copy and one
        ``index_copy_`` a leaf. Through the single door every rank calls
        it; rank 0's rows are the ones ingested."""
        if self._door:
            return self._door_add(rollouts, current_version)
        fresh = self._admit(rollouts, current_version)
        if not fresh:
            self._publish_telemetry()
            return 0
        with self._tel.span("buffer/insert"):
            slots = self._alloc_slots(len(fresh))
            fresh = fresh[: len(slots)]
            if not fresh:
                self._publish_telemetry()
                return 0
            self._copy_in(self._stage_rows([flat for _, flat in fresh]), slots)
            self._book_rows(fresh, slots)
        self._publish_telemetry()
        return len(fresh)

    def _admit(self, rollouts: List[Tuple[Dict[str, Any], Any]], current_version: int) -> List[Tuple[Dict, Dict]]:
        """The door, in the reference's order: the rows that pass as ``(meta,
        leaves by name)``, at most a ring's worth (the newest), each drop
        counted."""
        fresh = []
        for meta, arrays in rollouts:
            if current_version - meta["model_version"] > self._staleness_limit:
                self.dropped_stale += 1
                self._tel.counter("buffer/stale_rejected_total").inc()
                continue
            flat = self._matches_slot(arrays)
            if flat is None:
                self.dropped_skew += 1
                self._tel.counter("buffer/skew_drops_total").inc()
                if not self._skew_warned:
                    self._skew_warned = True
                    logger.warning("trajectory_buffer: dropping a rollout whose tree, shapes or dtypes do not "
                                   "match this learner's config (an actor with another rollout_len, obs or "
                                   "model config?): align the actor's and the learner's configs")
                continue
            if self._int_guards and not self._payload_in_bounds(flat):
                self.dropped_bounds += 1
                self._tel.counter("buffer/intbound_rejected_total").inc()
                if not self._bounds_warned:
                    self._bounds_warned = True
                    logger.warning("trajectory_buffer: dropping a full-width rollout whose int leaves do not fit "
                                   "this learner's narrow ring (an actor breaking rollout_int_bounds?): fix the "
                                   "actor or widen the bounds")
                continue
            if self._reject_nonfinite and not self._payload_finite(flat):
                self.dropped_nonfinite += 1
                self._tel.counter("buffer/nonfinite_rejected_total").inc()
                continue
            fresh.append((meta, flat))
        if len(fresh) > self.capacity:
            # one ingest never names a slot twice: keep the newest
            self.dropped_overflow += len(fresh) - self.capacity
            fresh = fresh[-self.capacity:]
        return fresh

    def _book_rows(self, fresh: List[Tuple[Dict, Dict]], slots: List[int]) -> None:
        """The bookkeeping of rows written into ``slots``: versions, the
        trace records' admit hop, the order, the count."""
        self._slot_version[slots] = [m["model_version"] for m, _ in fresh]
        if self._tracer is not None:
            # the admit hop: the row passed the door and owns a slot
            ts = tracing.now()
            for (m, _), s in zip(fresh, slots):
                rec = m.get("trace")
                if rec is not None:
                    rec["hops"].append(["admit", ts])
                self._slot_trace[s] = rec
        self._order.extend(slots)
        self.ingested += len(slots)

    def _copy_in(self, lane: Dict[str, torch.Tensor], slots: List[int]) -> None:
        """The lane's first ``len(slots)`` rows into this rank's store slots
        ``slots``: one non-blocking host-to-device copy and one
        ``index_copy_`` a leaf, the lane's event recorded after them."""
        n = len(slots)
        idx = host_index(slots, self.device)
        for name, dst in flatten_tree(self._store).items():
            dst.index_copy_(0, idx, lane[name][:n].to(self.device, non_blocking=True))
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            self._staging_events[(self._staging_idx - 1) % self._staging_lanes] = ev

    # -- the single door ------------------------------------------------------

    def _shard_of(self, slot: int) -> int:
        return slot // self._local_cap

    def _door_add(self, rollouts: List[Tuple[Dict[str, Any], Any]], current_version: int) -> int:
        """Rank 0 admits and places the rows; its plan (the global slots, in
        admission order) is broadcast and each shard's rows scattered to its
        ranks, which stage them into their own slots."""
        plan = torch.full((1 + self.capacity,), -1, dtype=torch.int64)
        fresh: List[Tuple[Dict, Dict]] = []
        if self._leader:
            fresh = self._admit(rollouts, current_version)
            slots = self._alloc_slots(len(fresh), placed=True) if fresh else []
            fresh = fresh[: len(slots)]
            plan[0] = len(slots)
            plan[1:1 + len(slots)] = torch.as_tensor(slots, dtype=torch.int64)
        broadcast_host(plan, self._all_group)
        k = int(plan[0])
        if not k:
            self._publish_telemetry()
            return 0
        with self._tel.span("buffer/insert"):
            slots = plan[1:1 + k].tolist()
            by_shard = [[j for j, g in enumerate(slots) if self._shard_of(g) == s] for s in range(self._n_shards)]
            width = max(len(x) for x in by_shard)
            parts = None
            if self._leader:
                host = {name: torch.empty((k,) + shape, dtype=dtype) for name, shape, dtype, _ in self._row_layout}
                self._fill(host, [flat for _, flat in fresh])
                packed = [self._pack(host, rows, width) for rows in by_shard]
                parts = [packed[r // self._model_ranks] for r in range(self._n_shards * self._model_ranks)]
            got = scatter_host(parts, (width, self._row_bytes), torch.uint8, self._all_group)
            mine = by_shard[self._shard]
            if mine:
                lane = self._next_lane()
                for name, t in self._unpack(got[:len(mine)]).items():
                    lane[name][:len(mine)].copy_(t)
                self._copy_in(lane, [slots[j] % self._local_cap for j in mine])
            if self._leader:
                self._book_rows(fresh, slots)
        self._publish_telemetry()
        return k

    def _pack(self, host: Dict[str, torch.Tensor], rows: List[int], width: int) -> torch.Tensor:
        """Rows ``rows`` of host leaves as ``[width, row bytes]`` uint8, the
        leaves end to end in the store's order, zero-padded to ``width``."""
        out = torch.zeros((width, self._row_bytes), dtype=torch.uint8)
        if rows:
            idx = torch.as_tensor(rows, dtype=torch.int64)
            out[:len(rows)] = torch.cat([host[name].index_select(0, idx).reshape(len(rows), -1).view(torch.uint8)
                                         for name, *_ in self._row_layout], dim=1)
        return out

    def _unpack(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``_pack``'s inverse: host leaves of ``buf``'s rows."""
        out, off = {}, 0
        for name, shape, dtype, nb in self._row_layout:
            out[name] = buf[:, off:off + nb].contiguous().view(dtype).reshape((buf.shape[0],) + shape)
            off += nb
        return out

    def _door_take(self, b: int, current_version: Optional[int], hold: bool) -> Optional[Any]:
        """Rank 0 decides (``_take_slots``) and broadcasts the batch's global
        slots; every rank gathers its share."""
        plan = torch.full((1 + b,), -1, dtype=torch.int64)
        plan[0] = 0
        ticket = -1
        if self._leader:
            slots = self._take_slots(b, current_version)
            if slots is not None:
                plan[0] = 1
                plan[1:] = torch.as_tensor(slots, dtype=torch.int64)
                ticket = self._hold_or_free(slots, hold)
        broadcast_host(plan, self._all_group)
        if not int(plan[0]):
            self._publish_telemetry()
            return None
        slots = plan[1:].tolist()
        with self._tel.span("buffer/sample"):
            batch = self._gather_share(slots)
            if self._leader:
                self._trace_gather(slots)
        if self._leader:
            self._staleness_gauge(slots, current_version)
        self._publish_telemetry()
        return (batch, ticket) if hold else batch

    def _gather_share(self, slots: List[int]) -> Any:
        """This rank's share of the batch at global slots ``slots``: its own
        slots gathered on the device, and the rows whose slots lie on
        another shard received from that shard's rank of this rank's model
        coordinate (a copy to the host there, a gloo send, a copy to the
        card here), one message a (home, target) shard pair."""
        lcap, share, me, M = self._local_cap, self._share, self._shard, self._model_ranks
        m = self._rank % M
        target = [i // share for i in range(len(slots))]
        home = [self._shard_of(g) for g in slots]
        moved = [i for i in range(len(slots)) if home[i] != target[i]]
        self.rows_moved += len(moved)
        pairs = sorted({(home[i], target[i]) for i in moved})
        moves, sends, where = [], {}, {}
        for h, t in pairs:
            pos = [i for i in moved if (home[i], target[i]) == (h, t)]
            for mm in range(M):
                moves.append(((h, t, mm), h * M + mm, t * M + mm))
            if h == me:
                sends[(h, t, m)] = [slots[i] % lcap for i in pos]
            if t == me:
                where[(h, t, m)] = [i - me * share for i in pos]
        got = self._move_rows(moves, sends, {k: len(v) for k, v in where.items()}) if moves else {}
        mine = range(me * share, (me + 1) * share)
        idx = host_index([slots[i] % lcap if home[i] == me else 0 for i in mine], self.device)
        flat = {name: leaf.index_select(0, idx) for name, leaf in flatten_tree(self._store).items()}
        for key, rows in got.items():
            at = host_index(where[key], self.device)
            for name, leaf in rows.items():
                flat[name].index_copy_(0, at, leaf)
        # the one widening of a narrow ring, on the device
        return tree_map(lambda t, d: t.to(d), unflatten_tree(flat), self._consume_dtypes)

    def _move_rows(self, moves: List[Tuple[Any, int, int]], sends: Dict[Any, List[int]],
                   recv_counts: Dict[Any, int]) -> Dict[Any, Dict[str, torch.Tensor]]:
        """The rows that cross shards at a take: this rank's store rows
        ``sends[key]`` copied to the host and sent, and ``recv_counts[key]``
        rows received and copied to the card (device leaves by key). The
        door's one read of the device and its one copy to the card outside
        the staging lanes."""
        packed = {}
        for key, local_slots in sends.items():
            idx = host_index(local_slots, self.device)
            host = {name: leaf.index_select(0, idx).cpu() for name, leaf in flatten_tree(self._store).items()}
            packed[key] = self._pack(host, list(range(len(local_slots))), len(local_slots))
        like = {key: ((n, self._row_bytes), torch.uint8) for key, n in recv_counts.items()}
        got = exchange_host(moves, packed, like, self._all_group)
        return {key: {name: t.to(self.device) for name, t in self._unpack(buf).items()} for key, buf in got.items()}

    def _matches_slot(self, arrays: Any) -> Optional[Dict[str, Any]]:
        """The payload's leaves by name when it has exactly the slot's tree
        and shapes, every leaf at one of its admissible widths; else None
        (config skew)."""
        try:
            flat = flatten_tree(arrays)
        except (TypeError, ValueError, AttributeError):
            return None
        if flat.keys() != self._tmpl.keys():
            return None
        for name, leaf in flat.items():
            shape, accept = self._tmpl[name]
            try:
                if tuple(leaf.shape) != shape or _dtype_name(leaf) not in accept:
                    return None
            except (TypeError, AttributeError):
                return None
        return flat

    def _payload_in_bounds(self, flat: Dict[str, Any]) -> bool:
        """True iff every int leaf arriving wider than its narrow store
        dtype fits that dtype's range (a row at the narrow width fits by
        its dtype)."""
        for name, info in self._int_guards.items():
            a = np.asarray(flat[name])
            if a.dtype.itemsize > info.bits // 8 and a.size and (a.min() < info.min or a.max() > info.max):
                return False
        return True

    def _payload_finite(self, flat: Dict[str, Any]) -> bool:
        """True iff every float leaf is finite. A bf16 wire leaf (a CPU
        tensor) is scanned at its own width, never widened."""
        for leaf in flat.values():
            if isinstance(leaf, torch.Tensor):
                if leaf.dtype == torch.bfloat16:
                    # in slices: the scan's temporaries stay small beside
                    # the leaf, and nothing is widened to f32
                    flat_leaf = leaf.reshape(-1)
                    for i in range(0, flat_leaf.numel(), _FINITE_SLICE):
                        if not bool(torch.isfinite(flat_leaf[i:i + _FINITE_SLICE]).all()):
                            return False
                elif leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
                    return False
            elif leaf.dtype.kind == "f" and not np.isfinite(leaf).all():
                return False
        return True

    def _stage_rows(self, rows: List[Dict[str, Any]]) -> Dict[str, torch.Tensor]:
        """Copy the rows into the next staging lane and return it."""
        lane = self._next_lane()
        self._fill(lane, rows)
        return lane

    def _next_lane(self) -> Dict[str, torch.Tensor]:
        """The next staging lane (host tensors of this rank's slot count,
        pinned on CUDA), rewritten only after the copy that last read it
        has completed."""
        if self._staging is None:
            pin = self.device.type == "cuda"
            self._staging = [
                {name: torch.empty((self._local_cap,) + tuple(t.shape[1:]), dtype=t.dtype, pin_memory=pin)
                 for name, t in flatten_tree(self._store).items()}
                for _ in range(self._staging_lanes)
            ]
        k = self._staging_idx
        self._staging_idx = (k + 1) % self._staging_lanes
        if self._staging_events[k] is not None:
            self._staging_events[k].synchronize()
            self._staging_events[k] = None
        return self._staging[k]

    def _fill(self, lane: Dict[str, torch.Tensor], rows: List[Dict[str, Any]]) -> None:
        """Rows (leaves by name, at either admissible width) into host
        tensors of the store's dtypes."""
        with self._tel.span("buffer/stage"):
            for name, dst in lane.items():
                if dst.dtype == torch.bfloat16:
                    # a bf16 lane by its bits: a bf16 row copies them, a
                    # full-width row rounds as the wire would
                    view = dst.view(torch.int16).numpy().view(np.uint16)
                    for i, flat in enumerate(rows):
                        src = flat[name]
                        view[i] = bf16_tensor_to_bits(src) if _dtype_name(src) == BF16 else f32_to_bf16_bits(src)
                else:
                    view = dst.numpy()
                    for i, flat in enumerate(rows):
                        src = flat[name]
                        view[i] = _to_f32(src) if _dtype_name(src) == BF16 else src

    def _alloc_slots(self, n: int, placed: bool = False) -> List[int]:
        """Up to ``n`` writable slots: free slots first, then the oldest
        unconsumed (counted in ``dropped_overflow``). Held slots are in
        neither pool, so when both run dry the rest is dropped (counted).
        With ``placed`` (the single door) a free slot is taken, where there
        is one, on the shard whose batch share the row's order position
        falls in; which free slot is taken changes no drop."""
        slots: List[int] = []
        if placed:
            # the order position the first row will take (after the evictions)
            first = len(self._order) - min(max(0, n - len(self._free)), len(self._order))
        for k in range(n):
            if self._free:
                at = len(self._free) - 1
                if placed:
                    want = ((first + k) // self._share) % self._n_shards
                    at = next((i for i in range(len(self._free) - 1, -1, -1)
                               if self._shard_of(self._free[i]) == want), at)
                slots.append(self._free.pop(at))
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
            if self._slot_trace is not None:
                # device chunks carry no record, but their slots may have
                # held a traced row's
                for s in slots:
                    self._slot_trace[s] = None
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
        (trained on) or :meth:`requeue` (returned untrained to the front).
        Through the single door every rank calls it and gets its share of
        rank 0's batch."""
        b = batch_size or self.batch_size
        if self._door:
            return self._door_take(b, current_version, hold)
        slots = self._take_slots(b, current_version)
        if slots is None:
            return None
        with self._tel.span("buffer/sample"):
            idx = host_index(slots, self.device)
            # the one widening of a narrow ring, on the device (a no-op .to
            # for a leaf already at its train dtype)
            batch = tree_map(lambda s, d: s.index_select(0, idx).to(d), self._store, self._consume_dtypes)
            ticket = self._hold_or_free(slots, hold)
            self._trace_gather(slots)
        self._staleness_gauge(slots, current_version)
        self._publish_telemetry()
        return (batch, ticket) if hold else batch

    def _take_slots(self, b: int, current_version: Optional[int]) -> Optional[List[int]]:
        """The take's bookkeeping: the stale scan, the warm-up, and the
        oldest ``b`` slots out of the order (None when there is no
        batch)."""
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
        return [self._order.popleft() for _ in range(b)]

    def _hold_or_free(self, slots: List[int], hold: bool) -> int:
        """Park the taken slots under a new ticket (returned), or free them
        (-1)."""
        if not hold:
            self._free.extend(slots)
            return -1
        ticket = self._next_ticket
        self._next_ticket += 1
        self._held[ticket] = slots
        return ticket

    def _trace_gather(self, slots: List[int]) -> None:
        """The gather hop (ring residency = gather - admit); the records
        wait for the dispatch that consumes the batch."""
        if self._tracer is None:
            return
        ts = tracing.now()
        for s in slots:
            rec = self._slot_trace[s]
            if rec is not None:
                self._slot_trace[s] = None
                rec["hops"].append(["gather", ts])
                self._pending_traces.append(rec)

    def _staleness_gauge(self, slots: List[int], current_version: Optional[int]) -> None:
        if current_version is not None:
            # how far behind the optimizer the batch's experience is, in
            # optimizer steps (host ints)
            self._tel.gauge("buffer/batch_staleness").set(
                float(current_version - self._slot_version[slots].mean()))

    def drain_traces(self) -> List[dict]:
        """The records of every batch taken since the last call, for the
        learner to stamp ``dispatch`` on; empty when tracing is off."""
        if not self._pending_traces:
            return self._pending_traces
        out, self._pending_traces = self._pending_traces, []
        return out

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
        the device). Held batches are folded back into the order first. A
        sharded ring's is the whole ring's (a collective)."""
        local = self._local_state_dict()
        if self._door:
            return self._door_state(local)
        return self._gather_state(local) if self._n_shards > 1 else local

    def _local_state_dict(self) -> Dict[str, Any]:
        self.requeue_all_held()
        return {
            "store": tree_map(lambda t: t.detach().cpu().clone(), self._store),
            "order": self._padded(self._order, self.capacity),
            "free": self._padded(self._free, self.capacity),
            "slot_version": torch.from_numpy(self._slot_version.copy()),
            "counters": torch.as_tensor(
                [int(self._warmed), self.dropped_stale, self.dropped_overflow, self.ingested,
                 self.dropped_skew, self.dropped_nonfinite, self.dropped_bounds], dtype=torch.int64),
        }

    def _gather_state(self, local: Dict[str, Any]) -> Dict[str, Any]:
        """The ranks' snapshots as one ring's: slots end to end, the order
        a batch share of each rank in turn."""
        n, cap, b, g = self._n_shards, self.capacity, self.batch_size, self._host_group
        store = tree_map(lambda t: all_gather_rows(t, g), local["store"])
        orders = all_gather_rows(local["order"][None], g)          # [n, cap], -1 padded
        frees = all_gather_rows(local["free"][None], g)
        versions = all_gather_rows(local["slot_version"], g)
        counters = all_gather_rows(local["counters"][None], g)
        per_rank = [[int(x) + r * cap for x in orders[r] if x >= 0] for r in range(n)]
        order: List[int] = []
        for lo in range(0, max(len(o) for o in per_rank), b):
            for o in per_rank:
                order.extend(o[lo:lo + b])
        free = [int(x) + r * cap for r in range(n) for x in frees[r] if x >= 0]
        total = counters.sum(dim=0)
        total[0] = counters[:, 0].max()                           # warmed: any rank's
        return {"store": store, "order": self._padded(order, n * cap), "free": self._padded(free, n * cap),
                "slot_version": versions, "counters": total}

    def _door_state(self, local: Dict[str, Any]) -> Dict[str, Any]:
        """The single door's snapshot: the shards' slots end to end (the
        global slots in order) and rank 0's bookkeeping, on every rank."""
        store = tree_map(lambda t: all_gather_rows(t, self._host_group), local["store"])
        books = {k: broadcast_host(local[k], self._all_group) for k in ("order", "free", "slot_version", "counters")}
        return {"store": store, **books}

    @staticmethod
    def _padded(vals, size: int) -> torch.Tensor:
        out = torch.full((size,), -1, dtype=torch.int64)
        vals = list(vals)
        out[: len(vals)] = torch.as_tensor(vals, dtype=torch.int64)
        return out

    def _cut_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's part of a whole ring's snapshot, in its own slots:
        order position p belongs to rank ``(p // share) % n``; the ranks
        keep as many chunks each as the fewest holds (at most a ring's
        worth), oldest first."""
        n, r, cap, b = self._n_shards, self._shard, self.capacity, self.batch_size
        order = [int(x) for x in np.asarray(state["order"]) if x >= 0]
        mine = [[] for _ in range(n)]
        for p, slot in enumerate(order):
            mine[(p // b) % n].append(slot)
        keep = min(min(len(m) for m in mine), cap)
        dropped = len(order) - n * keep
        rows = mine[r][:keep]
        idx = torch.as_tensor(rows + [0] * (cap - keep), dtype=torch.int64)
        counters = torch.as_tensor(state["counters"], dtype=torch.int64).clone()
        if r != 0:
            counters[1:] = 0                                      # the totals stay with rank 0
        elif dropped:
            counters[2] += dropped
        return {
            "store": tree_map(lambda t: torch.as_tensor(t)[idx], state["store"]),
            "order": self._padded(range(keep), cap),
            "free": self._padded(range(cap - 1, keep - 1, -1), cap),
            "slot_version": torch.as_tensor(np.asarray(state["slot_version"])[rows + [0] * (cap - keep)]),
            "counters": counters,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore a ``state_dict``, written under either wire dtype: the
        store is cast to this ring's dtypes (exact upward, rounded as a
        fresh ingest downward), and a slot whose int values would wrap in
        this ring's narrow dtype is freed and counted in ``dropped_bounds``
        instead. A sharded ring takes its part of a whole ring's snapshot
        (:meth:`_cut_state`), whatever world size wrote it."""
        if self._n_shards > 1 and not self._door:
            state = self._cut_state(state)
        saved = flatten_tree(state["store"])
        bad = np.zeros((self.capacity,), bool)
        for name, info in self._int_guards.items():
            a = np.asarray(torch.as_tensor(saved[name]))
            if a.dtype.itemsize > info.bits // 8:
                bad |= ((a < info.min) | (a > info.max)).reshape(self.capacity, -1).any(axis=1)
        store = flatten_tree(self._store)
        # the single door: this shard's slots of the whole ring; its
        # bookkeeping stays rank 0's
        lo = self._shard * self._local_cap if self._door else 0
        self._store = unflatten_tree({
            n: self._restored_leaf(torch.as_tensor(saved[n])[lo:lo + self._local_cap], s.dtype).to(self.device)
            for n, s in store.items()})
        lead = self._leader
        self._order = deque(int(s) for s in np.asarray(state["order"]) if s >= 0 and lead)
        self._free = [int(s) for s in np.asarray(state["free"]) if s >= 0 and lead]
        self._held = {}
        self._slot_version = np.asarray(state["slot_version"], dtype=np.int64).copy()
        counters = [int(v) * lead for v in np.asarray(state["counters"])]
        counters += [0] * (_N_COUNTERS - len(counters))
        (warmed, self.dropped_stale, self.dropped_overflow, self.ingested, self.dropped_skew,
         self.dropped_nonfinite, self.dropped_bounds) = counters[:_N_COUNTERS]
        self._warmed = bool(warmed)
        if self._slot_trace is not None:
            # restored slots carry no live record
            self._slot_trace = [None] * self.capacity
            self._pending_traces = []
        dropped = [s for s in self._order if bad[s]]
        if dropped:
            self._order = deque(s for s in self._order if not bad[s])
            self._free.extend(dropped)
            self.dropped_bounds += len(dropped)
            self._tel.counter("buffer/intbound_rejected_total").inc(len(dropped))
            logger.warning("trajectory_buffer: freed %d restored slot(s) whose int values do not fit this ring's "
                           "narrow dtypes (a snapshot of a full-width ring?): casting them would wrap", len(dropped))
        self._publish_telemetry()

    @staticmethod
    def _restored_leaf(x: Any, dtype: torch.dtype) -> torch.Tensor:
        """A saved store leaf (a CPU tensor or array) as a CPU tensor of
        ``dtype``: f32 into bf16 rounds as the wire does."""
        t = torch.as_tensor(x).detach().cpu()
        if dtype == torch.bfloat16 and t.dtype != torch.bfloat16:
            return torch.from_numpy(f32_to_bf16_bits(_to_f32(t)).view(np.int16)).view(torch.bfloat16)
        return t.to(dtype).clone()

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


__all__ = ["TrajectoryBuffer"]
