"""The same-host shared-memory lane: experience and weights with no syscall.

Counterpart of ``dotaclient_tpu/transport/shm_transport.py``; the segment
layout below is the wire contract, so a port actor attaches to a JAX
learner's lane and a JAX actor to the port's. Actor processes on the
learner's host skip loopback TCP (two kernel copies, a syscall a frame, a
reader thread a connection) and write into shared memory instead:

* **rollout lane**: one single-producer single-consumer byte ring a slot.
  The actor writes ``u32 length + payload + u32 crc32`` frames (the trailer
  is ``frame_crc32``; the length word's high bit marks a fleet metrics
  snapshot, routed to ``metrics_handler``) and bumps a cumulative ``tail``;
  the learner copies frames out on its own thread and bumps ``head``. No
  locks: each 8-byte counter has one writer. A full ring drops the new
  frame (counted in the ring's header): an actor never blocks on a slow
  learner. The drain checks each frame's CRC: a mismatch drops and counts
  it (``transport/frames_corrupt_total``), an implausible length word means
  the framing is lost and the ring is resynced to its tail, and
  ``poison_frame_limit`` bad frames in a row quarantine the slot
  (``transport/peers_quarantined``) until its claimant is gone and the slot
  is reaped.
* **weights lane**: one seqlocked slab. ``publish_weights`` makes the
  sequence word odd, writes the version and payload and makes it even;
  a reader retries a torn read. Writers never wait for readers and readers
  never wait for writers: the latest version wins.

Segment layout (the name is the lane's address, given to both sides)::

    <name>-w                weights slab:
        [0..8)   seq     u64  (odd while the server writes)
        [8..16)  version i64
        [16..24) length  u64
        [24..32) server pid (the liveness beacon)
        [32..40) payload crc32 (low 4 bytes used)
        [40..)   payload
    <name>-r<i>  i in [0, slots)   rollout ring of actor slot i:
        [0..8)   head    u64  cumulative bytes consumed  (learner-owned)
        [8..16)  tail    u64  cumulative bytes written   (actor-owned)
        [16..24) frames  u64  cumulative frames written  (actor-owned)
        [24..32) dropped u64  frames dropped ring-full  (actor-owned)
        [32..40) claim   u64  owning actor pid, 0 = free
        [64..)   data (ring_bytes)

An actor claims a free slot through an ``O_CREAT|O_EXCL`` lockfile beside
the segments (one winner on a race), then writes its pid into the ring's
claim word. Both are released on close; the server reaps slots whose
claiming pid is gone, so a restarted fleet cannot leak slots. Actors and
learner share ``/dev/shm``: same host, the lane's whole point.

``SharedMemory`` registers attachments with the resource tracker as if it
owned them, which would unlink a live learner's segments when an actor
exits; attachments here are unregistered (the server, the creator, is the
only unlinker).

The slab carries any weights frame, a bf16 one (``transport.wire_dtype``)
as well: its ``__wire_cast__`` entry rides inside the frame, and the
actor's ``decode_weights`` widens the leaves it names.
"""

from __future__ import annotations

import os
import struct
import time
from multiprocessing import resource_tracker, shared_memory
from typing import List, Optional, Tuple

from dotaclient_tpu_torch.protos import dota_pb2 as pb
from dotaclient_tpu_torch.transport.socket_transport import frame_crc32
from dotaclient_tpu_torch.utils import faults, telemetry, tracing

_U64 = struct.Struct("<Q")
_I64 = struct.Struct("<q")
_U32 = struct.Struct("<I")
_TAIL_FRAMES = struct.Struct("<QQ")   # adjacent tail+frames header words

_OFF_HEAD = 0
_OFF_TAIL = 8
_OFF_FRAMES = 16
_OFF_DROPPED = 24
_OFF_CLAIM = 32
_RING_HDR = 64

_OFF_SEQ = 0
_OFF_VERSION = 8
_OFF_LENGTH = 16
_OFF_SERVER_PID = 24   # liveness beacon: actors probe it (same host)
_OFF_CRC = 32          # the weights payload's crc32
_SLAB_HDR = 40

_FRAME_OVERHEAD = 8    # u32 length prefix + u32 crc32 trailer per ring frame

# Ring frames carry no kind byte; the length word's high bit marks a fleet
# metrics snapshot. Ring capacities are far below 2^31, so the bit is free,
# the length check masks it off first, and both kinds of frame get the
# same CRC and quarantine.
_METRICS_FLAG = 0x80000000
_LEN_MASK = 0x7FFFFFFF

# Slot-claim lockfiles live next to the segments. SharedMemory maps names
# into /dev/shm on Linux; the lockfile's O_CREAT|O_EXCL creation is the
# atomic mutex the claim-word write alone cannot provide.
_SHM_DIR = "/dev/shm"


def _lock_path(name: str, slot: int) -> str:
    return os.path.join(_SHM_DIR, f"{name}-claim{slot}")


def _try_lock_slot(name: str, slot: int) -> bool:
    """Atomically claim slot ``slot`` (O_EXCL). False if already claimed.
    The claimant's pid is written INTO the lockfile so the server's reaper
    can recognize a claimant that died before (or after) publishing its
    pid in the ring's claim word."""
    try:
        fd = os.open(
            _lock_path(name, slot),
            os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644,
        )
    except FileExistsError:
        return False
    try:
        os.write(fd, str(os.getpid()).encode())
    finally:
        os.close(fd)
    return True


def _lockfile_pid(name: str, slot: int) -> "int | None":
    """Pid recorded in the slot's lockfile; None if unreadable/empty."""
    try:
        with open(_lock_path(name, slot), "rb") as f:
            return int(f.read().strip() or b"0") or None
    except (OSError, ValueError):
        return None


def _unlock_slot(name: str, slot: int) -> None:
    try:
        os.unlink(_lock_path(name, slot))
    except FileNotFoundError:
        pass


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:  # pragma: no cover - exists under another uid
        return True
    return True


def _reclaim_stale_lane(name: str) -> None:
    """Unlink lane ``name``'s segments iff its server pid beacon is dead.

    Raises FileExistsError when a LIVE server still owns the lane — the
    caller must not steal it."""
    try:
        slab = _attach(f"{name}-w")
    except FileNotFoundError:
        return   # only rings/locks linger: fall through to ring reclaim
    else:
        pid = _U64.unpack_from(slab.buf, _OFF_SERVER_PID)[0]
        alive = bool(pid) and _pid_alive(int(pid))
        try:
            if not alive:
                slab.unlink()
            slab.close()
        except (OSError, BufferError):  # pragma: no cover
            pass
        if alive:
            raise FileExistsError(
                f"shm lane {name!r} is owned by live learner pid {pid}"
            )
    i = 0
    while True:
        try:
            seg = _attach(f"{name}-r{i}")
        except FileNotFoundError:
            break
        try:
            seg.unlink()
            seg.close()
        except (OSError, BufferError):  # pragma: no cover
            pass
        _unlock_slot(name, i)
        i += 1


# Segment names created by THIS process's servers: a same-process attach
# (tests, single-process topologies) shares the creator's tracker cache
# entry, and unregistering it would make the creator's unlink double-free.
_OWNED_BY_THIS_PROCESS: set = set()


def _attach(name: str) -> shared_memory.SharedMemory:
    try:
        shm = shared_memory.SharedMemory(name=name)
    except ValueError as e:
        # its server has created it and not yet sized it (``shm_open``
        # before ``ftruncate``): refused like a TCP connect, so the actor's
        # reconnect loop tries again
        raise ConnectionError(f"shm segment {name!r} is not sized yet") from e
    if name not in _OWNED_BY_THIS_PROCESS:
        try:
            # attachments are registered like creations; without this
            # the attaching process unlinks live segments at exit
            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:  # pragma: no cover - tracker internals shifted
            pass
    return shm


def _ring_write(mv: memoryview, ring_bytes: int, pos: int, data) -> None:
    """Copy ``data`` into the ring data region at logical position ``pos``
    (mod ring_bytes), splitting across the wrap edge when needed."""
    pos %= ring_bytes
    end = pos + len(data)
    if end <= ring_bytes:
        mv[_RING_HDR + pos:_RING_HDR + end] = data
    else:
        k = ring_bytes - pos
        mv[_RING_HDR + pos:_RING_HDR + ring_bytes] = data[:k]
        mv[_RING_HDR:_RING_HDR + end - ring_bytes] = data[k:]


def _ring_read(mv: memoryview, ring_bytes: int, pos: int, n: int) -> bytes:
    pos %= ring_bytes
    end = pos + n
    if end <= ring_bytes:
        return bytes(mv[_RING_HDR + pos:_RING_HDR + end])
    k = ring_bytes - pos
    return bytes(mv[_RING_HDR + pos:_RING_HDR + ring_bytes]) + bytes(
        mv[_RING_HDR:_RING_HDR + end - ring_bytes]
    )


class ShmTransportServer:
    """Learner side: create the segments, drain every claimed ring."""

    def __init__(
        self,
        name: Optional[str] = None,
        slots: int = 16,
        ring_bytes: int = 8 * 1024 * 1024,
        weights_bytes: int = 32 * 1024 * 1024,
        poison_frame_limit: int = 8,
        registry: Optional[telemetry.Registry] = None,
    ) -> None:
        if slots < 1:
            raise ValueError("shm transport needs at least one actor slot")
        self._poison_frame_limit = max(1, poison_frame_limit)
        self.name = name or f"tpu-dota-{os.getpid()}"
        self.address = self.name
        self.slots = slots
        self.ring_bytes = ring_bytes
        try:
            self._weights = shared_memory.SharedMemory(
                name=f"{self.name}-w", create=True,
                size=_SLAB_HDR + weights_bytes,
            )
        except FileExistsError:
            # fixed --shm-name + a SIGKILL'd previous learner leaves stale
            # segments: reclaim them iff their pid beacon is dead — a
            # supervisor restart must not crash-loop on its own leftovers
            _reclaim_stale_lane(self.name)
            self._weights = shared_memory.SharedMemory(
                name=f"{self.name}-w", create=True,
                size=_SLAB_HDR + weights_bytes,
            )
        _OWNED_BY_THIS_PROCESS.add(f"{self.name}-w")
        self._rings = []
        try:
            for i in range(slots):
                self._rings.append(
                    shared_memory.SharedMemory(
                        name=f"{self.name}-r{i}", create=True,
                        size=_RING_HDR + ring_bytes,
                    )
                )
                _OWNED_BY_THIS_PROCESS.add(f"{self.name}-r{i}")
        except OSError:
            # partial creation (ENOSPC on a tight /dev/shm, stale ring):
            # unlink what was created — a failed constructor must not
            # poison the name or leak tmpfs pages until reboot
            for seg in (self._weights, *self._rings):
                try:
                    seg.unlink()
                    seg.close()
                except (OSError, FileNotFoundError):
                    pass
            _OWNED_BY_THIS_PROCESS.discard(f"{self.name}-w")
            for k in range(slots):
                _OWNED_BY_THIS_PROCESS.discard(f"{self.name}-r{k}")
            raise
        for seg in (self._weights, *self._rings):
            seg.buf[:_RING_HDR] = bytes(_RING_HDR)  # zeroed headers
        # liveness beacon: shm has no connection to break, so actors probe
        # this pid to notice a dead/restarted learner (and then reconnect
        # with backoff or exit for the supervisor — actor/__main__.py)
        _U64.pack_into(self._weights.buf, _OFF_SERVER_PID, os.getpid())
        for i in range(slots):
            # fresh lane (segment creation above proved no live server owns
            # this name): any same-name lockfile is a crashed run's leftover
            _unlock_slot(self.name, i)
        self._consumed = [0] * slots      # frames drained per ring
        self._next_ring = 0               # round-robin drain fairness
        self._last_telemetry = 0.0        # ring-scan gauges are time-gated
        # Deferred release (the zero-copy contract): a drain hands back
        # memoryview slices INTO the rings; the freed space is published to
        # the producers only at the NEXT drain call, by which point the
        # caller has decoded/staged the previous batch (the learner's
        # ingest copies rows into the buffer's staging lanes before it
        # polls again).
        self._pending_head: List[Optional[int]] = [None] * slots
        self._latest_weights: Optional[pb.ModelWeights] = None
        self.bad_payloads = 0
        self._closed = False
        # Poison-frame quarantine state: consecutive corrupt
        # frames per slot, and the quarantine flag that stops draining a
        # slot whose producer ships garbage (the slot returns to service
        # when its dead claimant is reaped and a new actor claims it).
        self._bad_streak = [0] * slots
        self._quarantined = [False] * slots
        self._tel = registry if registry is not None else telemetry.get_registry()
        # created up front, so the record's keys do not depend on traffic
        self._tel.gauge("shm/ring_occupancy")
        self._tel.gauge("shm/ring_dropped_total")
        self._tel.gauge("transport/queue_depth")
        self._tel.counter("transport/frames_corrupt_total")
        self._tel.counter("transport/peers_quarantined")
        # the wire byte accounting (check_telemetry_schema.py --require-wire)
        self._tel.counter("transport/rollout_bytes_total")
        self._tel.counter("transport/malformed_payloads_total")
        self._tel.counter("transport/rollout_raw_bytes_total")
        self._tel.gauge("transport/rollout_compression_ratio").set(1.0)
        self._rollout_totals = [0, 0]   # [wire bytes, raw bytes] consumed
        # the fleet snapshot sink: the learner's FleetAggregator assigns
        # its `ingest` here; the drain hands it every CRC-verified metrics
        # frame (the length word's high bit)
        self.metrics_handler = None

    # -- rollout lane ------------------------------------------------------

    def _release_pending(self) -> None:
        """Publish the head positions of the previous drain's frames: their
        views are consumed by now, so the producers may reuse the space."""
        for i, h in enumerate(self._pending_head):
            if h is not None:
                _U64.pack_into(self._rings[i].buf, _OFF_HEAD, h)
                self._pending_head[i] = None

    def _poison_slot(self, i: int) -> None:
        """One corrupt frame from slot ``i``'s producer: count, bump the
        streak, and quarantine the slot at ``poison_frame_limit`` — it is
        skipped by every later drain until its claimant is reaped and a
        fresh actor claims the ring."""
        self._tel.counter("transport/frames_corrupt_total").inc()
        self._bad_streak[i] += 1
        if self._bad_streak[i] >= self._poison_frame_limit:
            self._quarantined[i] = True
            self._tel.counter("transport/peers_quarantined").inc()

    def _resync_ring(self, i: int, mv: memoryview, tail: int) -> None:
        """Framing lost (implausible length word): discard everything
        buffered by fast-forwarding ``head`` to the snapshot ``tail`` —
        the next intact frame the producer writes re-establishes framing."""
        self._pending_head[i] = tail
        # everything written so far counts as consumed (discarded), so the
        # pending_rollouts gauge doesn't drift on the skipped frames
        self._consumed[i] = _U64.unpack_from(mv, _OFF_FRAMES)[0]

    def _drain_ring(
        self, i: int, budget: int, out: List[memoryview]
    ) -> None:
        """Collect every complete frame from ring ``i`` (up to ``budget``
        total frames in ``out``) as ZERO-COPY memoryview slices into the
        ring itself — per frame: one length unpack, one slice, and the CRC
        fold (serialize.frame_crc32 — memory-bandwidth speed; the ONLY
        per-frame integrity cost, there is no fault-injection branch in
        this loop). No payload copy at all (only a frame that physically
        wraps the ring edge is copied, at most one per lap). The consumed
        space is not released here — ``head`` advances at the next drain
        (``_release_pending``), after the caller has decoded/staged these
        frames; until then the producer cannot overwrite them."""
        if self._quarantined[i]:
            return
        mv = self._rings[i].buf
        N = self.ring_bytes
        # the consume position this CALL has already reached: the shm head
        # word lags by one drain (deferred release), so a second pass within
        # the same drain — the empty-result spin, or a post-resync retry —
        # must continue from the pending position, not re-read stale frames
        head = self._pending_head[i]
        if head is None:
            head = _U64.unpack_from(mv, _OFF_HEAD)[0]
        tail = _U64.unpack_from(mv, _OFF_TAIL)[0]
        if head == tail:
            return
        consumed = 0
        while head < tail and len(out) < budget:
            pos = head % N
            if pos + 4 <= N:
                word = _U32.unpack_from(mv, _RING_HDR + pos)[0]
            else:
                word = _U32.unpack(_ring_read(mv, N, pos, 4))[0]
            # high bit: a fleet metrics snapshot; the masked length takes
            # the same plausibility, CRC and quarantine path
            is_metrics = bool(word & _METRICS_FLAG)
            length = word & _LEN_MASK
            if (
                length > N - _FRAME_OVERHEAD
                or _FRAME_OVERHEAD + length > tail - head
            ):
                # length word itself is garbage: framing is unrecoverable,
                # resync to the producer's tail and count the event
                self._poison_slot(i)
                self._resync_ring(i, mv, tail)
                return
            dpos = (pos + 4) % N
            if dpos + length <= N:     # common case: contiguous → view
                base = _RING_HDR + dpos
                payload = mv[base:base + length]
            else:                      # wraps the edge: one stitch copy
                payload = memoryview(_ring_read(mv, N, dpos, length))
            cpos = (dpos + length) % N
            if cpos + 4 <= N:
                crc = _U32.unpack_from(mv, _RING_HDR + cpos)[0]
            else:
                crc = _U32.unpack(_ring_read(mv, N, cpos, 4))[0]
            head += _FRAME_OVERHEAD + length
            consumed += 1
            if crc != frame_crc32(payload):
                self._poison_slot(i)   # dropped + counted, not delivered
                if self._quarantined[i]:
                    break
                continue
            self._bad_streak[i] = 0
            if is_metrics:
                # copied out (small frames) before the view's deferred
                # release; never delivered to the rollout consume path
                handler = self.metrics_handler
                if handler is not None:
                    try:
                        handler(bytes(payload))
                    except Exception:  # noqa: BLE001
                        pass   # a broken sink must never break the drain
                continue
            out.append(payload)
        if consumed:
            self._consumed[i] += consumed
            self._pending_head[i] = head

    def _drain(
        self, max_count: int, timeout: Optional[float]
    ) -> "List[Tuple[float, memoryview]]":
        """Drain complete frames as ``(recv_ts, view)`` pairs. On the shm
        lane the drain is the receive (there is no reader thread), so one
        stamp a drain call, taken after the CRC folds, serves every frame
        it collected."""
        views: List[memoryview] = []
        t0 = time.perf_counter()
        deadline = None if timeout is None else t0 + timeout
        self._release_pending()
        while True:
            start = self._next_ring
            for k in range(self.slots):
                self._drain_ring((start + k) % self.slots, max_count, views)
            self._next_ring = (start + 1) % self.slots
            if views or self._closed:
                break
            if deadline is not None and time.perf_counter() >= deadline:
                break
            time.sleep(0.0005)
        recv_ts = tracing.now()   # the recv hop
        out = [(recv_ts, v) for v in views]
        if out:
            self._tel.timer("span/transport/consume").observe(
                time.perf_counter() - t0
            )
            self._tel.counter("transport/experience_consumed").inc(len(out))
        now = time.perf_counter()
        if now - self._last_telemetry > 0.05:
            # the full ring scan costs ~a frame of time on slow hosts —
            # gauges refresh at human cadence, not per drain call
            self._last_telemetry = now
            self._publish_ring_telemetry()
        return out

    def _publish_ring_telemetry(self) -> None:
        occ = 0.0
        dropped = 0
        pending = 0
        for i, seg in enumerate(self._rings):
            mv = seg.buf
            head = _U64.unpack_from(mv, _OFF_HEAD)[0]
            tail = _U64.unpack_from(mv, _OFF_TAIL)[0]
            frames = _U64.unpack_from(mv, _OFF_FRAMES)[0]
            dropped += _U64.unpack_from(mv, _OFF_DROPPED)[0]
            occ = max(occ, (tail - head) / self.ring_bytes)
            pending += frames - self._consumed[i]
            # reap: a crashed actor never runs close(), so its slot would
            # stay claimed forever and a supervisor-restarted fleet would
            # exhaust slots. Claiming pids are same-host by construction,
            # so liveness is one signal-0 probe. (Re-check the claim word
            # right before unlocking: a fresh claimant may have raced in.)
            claim = _U64.unpack_from(mv, _OFF_CLAIM)[0]
            if claim and not _pid_alive(int(claim)):
                if _U64.unpack_from(mv, _OFF_CLAIM)[0] == claim:
                    _U64.pack_into(mv, _OFF_CLAIM, 0)
                    _unlock_slot(self.name, i)
                    self._tel.counter("shm/slots_reaped").inc()
                    # a quarantined slot returns to service with its next
                    # (fresh) claimant: discard the poisoned backlog and
                    # clear the flag — the garbage producer is gone
                    if self._quarantined[i]:
                        self._quarantined[i] = False
                        self._bad_streak[i] = 0
                        self._resync_ring(
                            i, mv, _U64.unpack_from(mv, _OFF_TAIL)[0]
                        )
            elif not claim and os.path.exists(_lock_path(self.name, i)):
                # claimant died in the window between creating its lockfile
                # and publishing its pid in the claim word — the lockfile's
                # own pid record covers it (an unreadable/empty file gets a
                # grace period: a LIVE claimant may be mid-write)
                pid = _lockfile_pid(self.name, i)
                if pid is not None:
                    if not _pid_alive(pid):
                        _unlock_slot(self.name, i)
                        self._tel.counter("shm/slots_reaped").inc()
                else:
                    try:
                        age = time.time() - os.path.getmtime(
                            _lock_path(self.name, i)
                        )
                    except OSError:
                        age = 0.0
                    if age > 5.0:
                        _unlock_slot(self.name, i)
                        self._tel.counter("shm/slots_reaped").inc()
        self._tel.gauge("shm/ring_occupancy").set(occ)
        self._tel.gauge("shm/ring_dropped_total").set(float(dropped))
        self._tel.gauge("transport/queue_depth").set(float(pending))

    def consume_rollouts(
        self, max_count: int, timeout: Optional[float] = None
    ) -> List[pb.Rollout]:
        protos = []
        for _recv_ts, payload in self._drain(max_count, timeout):
            r = pb.Rollout()
            try:
                r.ParseFromString(payload)
            except Exception:
                self.bad_payloads += 1
                continue
            protos.append(r)
        return protos

    def consume_decoded(self, max_count: int, timeout: Optional[float] = None):
        """The drain decoded into ``(meta, arrays)`` pairs (the learner's
        ingest), with the wire byte accounting shared with the socket lane
        (``serialize.decode_drained_payloads``); malformed payloads are
        counted in ``bad_payloads`` and ``transport/malformed_payloads_total``
        and dropped."""
        from dotaclient_tpu_torch.transport.serialize import decode_drained_payloads

        out, bad = decode_drained_payloads(self._drain(max_count, timeout), self._tel, self._rollout_totals)
        if bad:
            self.bad_payloads += bad
            self._tel.counter("transport/malformed_payloads_total").inc(bad)
        return out

    # -- weights lane ------------------------------------------------------

    def publish_weights(self, weights: pb.ModelWeights) -> None:
        """The seqlocked slab write (one writer by contract: the snapshot
        engine's thread, or with ``--sync-snapshots`` the train thread,
        never both)."""
        payload = weights.SerializeToString()
        mv = self._weights.buf
        cap = self._weights.size - _SLAB_HDR
        if len(payload) > cap:
            raise ValueError(
                f"encoded weights ({len(payload)} bytes) exceed the shm "
                f"slab ({cap} bytes) — raise transport.shm_weights_bytes"
            )
        seq = _U64.unpack_from(mv, _OFF_SEQ)[0]
        _U64.pack_into(mv, _OFF_SEQ, seq + 1)            # odd: write begins
        _I64.pack_into(mv, _OFF_VERSION, weights.version)
        _U64.pack_into(mv, _OFF_LENGTH, len(payload))
        _U64.pack_into(mv, _OFF_CRC, frame_crc32(payload))
        mv[_SLAB_HDR:_SLAB_HDR + len(payload)] = payload
        _U64.pack_into(mv, _OFF_SEQ, seq + 2)            # even: stable
        self._latest_weights = weights
        self._tel.counter("transport/weights_published").inc()
        self._tel.gauge("transport/weights_version").set(weights.version)
        self._tel.gauge("transport/actors_connected").set(self.n_connected)

    def latest_weights(self) -> Optional[pb.ModelWeights]:
        return self._latest_weights

    def publish_rollout(self, rollout: pb.Rollout) -> None:
        raise RuntimeError(
            "ShmTransportServer is the learner side; actors publish"
        )

    # -- bookkeeping -------------------------------------------------------

    @property
    def n_connected(self) -> int:
        n = 0
        for seg in self._rings:
            if _U64.unpack_from(seg.buf, _OFF_CLAIM)[0]:
                n += 1
        return n

    @property
    def pending_rollouts(self) -> int:
        pending = 0
        for i, seg in enumerate(self._rings):
            frames = _U64.unpack_from(seg.buf, _OFF_FRAMES)[0]
            pending += frames - self._consumed[i]
        return pending

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for seg in (self._weights, *self._rings):
            try:
                seg.unlink()
            except (OSError, FileNotFoundError):
                pass
            try:
                seg.close()
            except OSError:
                pass
            except BufferError:
                # a caller still holds zero-copy frame views: the mapping
                # must outlive them (unlink above already removed the
                # name). Disarm the destructor's re-close so GC does not
                # print "Exception ignored" noise at teardown.
                seg.close = lambda: None
        _OWNED_BY_THIS_PROCESS.discard(f"{self.name}-w")
        for i in range(self.slots):
            _OWNED_BY_THIS_PROCESS.discard(f"{self.name}-r{i}")
            _unlock_slot(self.name, i)   # lane is gone: clear stale locks


class ShmTransport:
    """Actor side: claim a ring slot, publish rollouts, read weights."""

    def __init__(self, name: str, slots: Optional[int] = None,
                 registry: Optional[telemetry.Registry] = None) -> None:
        """Attach to lane ``name``; probe every existing ring segment (the
        server decides how many exist — ``slots`` only bounds the probe for
        tests) and claim the first free one via its O_EXCL lockfile."""
        self.name = name
        self._weights_shm = _attach(f"{name}-w")
        # a SIGKILL'd learner leaves its segments behind: attaching them
        # must fail like a refused TCP connect, or the reconnect loop in
        # actor/__main__.py would succeed against a dead lane forever
        server_pid = _U64.unpack_from(self._weights_shm.buf, _OFF_SERVER_PID)[0]
        if server_pid and not _pid_alive(int(server_pid)):
            self._weights_shm.close()
            raise ConnectionError(
                f"shm lane {name!r}: learner process {server_pid} is gone"
            )
        self._ring: Optional[shared_memory.SharedMemory] = None
        self.slot = -1
        pid = os.getpid()
        i = 0
        while slots is None or i < slots:
            try:
                seg = _attach(f"{name}-r{i}")
            except FileNotFoundError:
                break   # past the last ring the server created
            if _try_lock_slot(name, i):   # atomic: a race has ONE winner
                _U64.pack_into(seg.buf, _OFF_CLAIM, pid)
                self._ring = seg
                self.slot = i
                break
            seg.close()
            i += 1
        if self._ring is None:
            self._weights_shm.close()
            raise ConnectionError(
                f"no free shm actor slot on lane {name!r} (all claimed)"
            )
        self.ring_bytes = self._ring.size - _RING_HDR
        self._mv = self._ring.buf          # cached: .buf re-wraps per access
        self._seen_version: Optional[int] = None
        self._corrupt_version: Optional[int] = None
        self._cached: Optional[pb.ModelWeights] = None
        self._last_liveness = time.monotonic()
        self._tel = registry if registry is not None else telemetry.get_registry()
        # Producer-owned header words mirrored as host ints: the producer is
        # the only writer of tail/frames/dropped, so the hot path never
        # re-reads them from shared memory (a struct.unpack_from costs µs on
        # slow hosts — per frame, that is the difference between winning
        # and losing to loopback TCP).
        mv = self._ring.buf
        self._tail = _U64.unpack_from(mv, _OFF_TAIL)[0]
        self._frames = _U64.unpack_from(mv, _OFF_FRAMES)[0]
        self._dropped = _U64.unpack_from(mv, _OFF_DROPPED)[0]
        self._faults = faults.get()   # None unless fault injection is on
        self._pub_counter = self._tel.counter("transport/experience_published")
        self._drop_counter = self._tel.counter("transport/experience_dropped")

    def _check_learner_alive(self) -> None:
        """Shared memory has no connection to break: probe the server's pid
        beacon (time-gated — one signal-0 every couple of seconds) so a
        dead/restarted learner surfaces as ConnectionError and the actor's
        reconnect-with-backoff / exit-for-supervisor machinery engages."""
        now = time.monotonic()
        if now - self._last_liveness < 2.0:
            return
        self._last_liveness = now
        pid = _U64.unpack_from(self._weights_shm.buf, _OFF_SERVER_PID)[0]
        if pid and not _pid_alive(int(pid)):
            raise ConnectionError(
                f"shm lane {self.name!r}: learner process {pid} is gone"
            )

    # -- rollouts ----------------------------------------------------------

    def publish_rollout(self, rollout: pb.Rollout) -> None:
        self.publish_rollout_bytes(rollout.SerializeToString())

    def publish_metrics_bytes(self, payload) -> bool:
        """One fleet snapshot frame: the ring's framing with the length
        word's high bit set, the same CRC trailer, drop when full and
        quarantine on the drain side."""
        return self.publish_rollout_bytes(payload, _word_flag=_METRICS_FLAG)

    def publish_rollout_bytes(self, payload, _word_flag: int = 0) -> bool:
        """One frame into the SPSC ring; returns False (counted drop) when
        full — the actor never blocks on a slow learner.

        Hot path: ONE shared-memory read (the consumer-owned ``head``), one
        payload memcpy, one combined tail+frames header write. Everything
        the producer owns lives in host ints."""
        self._check_learner_alive()
        mv = self._mv
        N = self.ring_bytes
        n = len(payload)
        need = _FRAME_OVERHEAD + n
        if need > N:
            raise ValueError(
                f"rollout frame ({need} bytes) exceeds the shm ring "
                f"({N} bytes) — raise transport.shm_ring_bytes"
            )
        tail = self._tail
        head = _U64.unpack_from(mv, _OFF_HEAD)[0]
        if need > N - (tail - head):
            self._dropped += 1
            _U64.pack_into(mv, _OFF_DROPPED, self._dropped)
            self._drop_counter.inc()
            return False
        crc = frame_crc32(payload)
        f = self._faults
        if f is not None:  # fault sites; one None test when faults are off
            delay = f.value("transport.delay_send")
            if delay:
                time.sleep(delay)
            if f.fire("transport.corrupt_frame"):
                crc ^= 0xDEADBEEF
        word = n | _word_flag
        pos = tail % N
        if pos + need <= N:        # common case: no wrap, three direct writes
            base = _RING_HDR + pos
            _U32.pack_into(mv, base, word)
            mv[base + 4:base + 4 + n] = payload
            _U32.pack_into(mv, base + 4 + n, crc)
        else:
            _ring_write(mv, N, pos, _U32.pack(word))
            _ring_write(mv, N, pos + 4, payload)
            _ring_write(mv, N, pos + 4 + n, _U32.pack(crc))
        # tail moves only after the payload is in place: the consumer never
        # sees a half-written frame (tail and frames are adjacent — one
        # packed write publishes both)
        self._tail = tail + need
        self._frames += 1
        _TAIL_FRAMES.pack_into(mv, _OFF_TAIL, self._tail, self._frames)
        self._pub_counter.inc()
        return True

    # -- weights -----------------------------------------------------------

    def latest_weights(self) -> Optional[pb.ModelWeights]:
        self._check_learner_alive()
        mv = self._weights_shm.buf
        for _ in range(64):   # seqlock retry budget; writes are µs-scale
            s1 = _U64.unpack_from(mv, _OFF_SEQ)[0]
            if s1 == 0:
                return None          # nothing published yet
            if s1 & 1:
                time.sleep(0.0002)   # server mid-write
                continue
            version = _I64.unpack_from(mv, _OFF_VERSION)[0]
            if version == self._seen_version:
                return self._cached  # no re-parse for an unchanged slab
            if version == self._corrupt_version:
                # known-corrupt slab: counted ONCE when discovered; skip
                # the multi-MB copy + CRC fold on every poll until the
                # server publishes a new version over it
                return self._cached
            length = _U64.unpack_from(mv, _OFF_LENGTH)[0]
            crc = _U64.unpack_from(mv, _OFF_CRC)[0]
            payload = bytes(mv[_SLAB_HDR:_SLAB_HDR + length])
            if _U64.unpack_from(mv, _OFF_SEQ)[0] != s1:
                continue             # torn read: writer raced us, retry
            if frame_crc32(payload) != crc:
                # stable seq + bad CRC = real corruption, not a torn read:
                # count it and keep serving the last good weights
                self._tel.counter("transport/frames_corrupt_total").inc()
                self._corrupt_version = version
                return self._cached
            msg = pb.ModelWeights()
            msg.ParseFromString(payload)
            self._seen_version = version
            self._cached = msg
            return msg
        return self._cached

    def consume_rollouts(
        self, max_count: int, timeout: Optional[float] = None
    ) -> List[pb.Rollout]:
        raise RuntimeError("ShmTransport is the actor side; learner consumes")

    def publish_weights(self, weights: pb.ModelWeights) -> None:
        raise RuntimeError("actors do not publish weights")

    def close(self) -> None:
        if self._ring is not None:
            try:
                _U64.pack_into(self._ring.buf, _OFF_CLAIM, 0)  # release slot
                self._mv = None
                self._ring.close()
            except (OSError, ValueError, BufferError):
                pass
            _unlock_slot(self.name, self.slot)
            self._ring = None
        try:
            self._weights_shm.close()
        except (OSError, ValueError):
            pass
