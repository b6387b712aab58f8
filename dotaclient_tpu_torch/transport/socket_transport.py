"""The framed TCP lane: the wire framing and the weights-receiving client.

Counterpart of ``dotaclient_tpu/transport/socket_transport.py``; the framing
is copied exactly, so a port process and a JAX process read each other's
frames. One frame: 1 byte kind + 4 bytes big-endian payload length + 4 bytes
CRC32 of those 5 header bytes, then the payload, then a 4-byte big-endian
``frame_crc32`` trailer over the payload. A corrupt trailer (header intact)
drops that frame alone (``FrameCorrupt``); a corrupt header makes every later
byte boundary untrustworthy and the stream is lost (``FramingLost``).

The frame CRC (``frame_crc32``) lives here, with no torch import, so the
session router (``serve/router.py``) frames its control lane without
loading torch.

Kinds 0-2 are the training transport's (rollout, weights, heartbeat), 3-4
the serve lane's request and reply (``serve/server.py``), 5 a fleet metrics
snapshot.

``TransportServer`` is the learner's side. It owns the listening socket;
every connected actor's rollouts funnel into one drop-oldest deque (a work
queue), and ``publish_weights`` fans out to every connection without ever
writing a socket itself: it serializes once, folds the CRC once, and puts
the payload in each connection's latest-wins slot, which that connection's
writer thread drains (a publish landing on an unsent one overwrites it,
``transport/weights_coalesced``). A connection still more than
``fanout_max_lag`` publishes behind is dropped, never waited on
(``transport/fanout_conns_dropped``). Each connection's reader thread
``recv_into``s a preallocated buffer, parses every complete frame of a
wakeup and hands the batch over under one lock; a corrupt trailer counts
toward the peer's quarantine (``poison_frame_limit`` in a row, or at once
for a corrupt header: ``transport/peers_quarantined``). The writer
interleaves heartbeats every ``heartbeat_interval_s`` and drops a
connection silent for ``idle_timeout_s`` (``transport/conn_idle_drops``).
Actors are disposable: a dead connection is dropped with its in-flight
rollouts. Kind-5 frames (fleet snapshots) go to ``metrics_handler``.

``SocketTransport`` is the actor's side (and the serve CLI's
``--subscribe host:port``): it connects, ships rollout and metrics frames,
keeps the newest ``ModelWeights`` frame, echoes liveness, and declares
itself dead after ``idle_timeout_s`` of silence or ``poison_frame_limit``
corrupt frames in a row. Its rollout send carries the fault sites
``transport.delay_send``, ``transport.corrupt_frame`` and
``transport.drop_conn`` (``utils/faults.py``).
"""

from __future__ import annotations

import socket
import struct
import threading
import time
import zlib
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np

from dotaclient_tpu_torch.protos import dota_pb2 as pb
from dotaclient_tpu_torch.utils import faults, telemetry, tracing

# -- wire-frame integrity ----------------------------------------------------
#
# The frames' CRC32 trailer, exactly the JAX package's: a frame above
# _CRC_FOLD_THRESHOLD bytes is first XOR-folded over 8-byte lanes to a 64-bit
# digest, and the CRC32 (seeded with the length) covers the digest and the
# unaligned tail. A JAX peer rejects every large frame whose trailer differs.

_CRC_FOLD_THRESHOLD = 4096


def frame_crc32(payload) -> int:
    """32-bit integrity trailer for one wire frame (bytes-like; memoryview
    slices fold in place)."""
    n = len(payload)
    if n <= _CRC_FOLD_THRESHOLD:
        return zlib.crc32(payload) & 0xFFFFFFFF
    m = n & ~7
    fold = int(np.bitwise_xor.reduce(np.frombuffer(payload, "<u8", count=m >> 3)))
    c = zlib.crc32(fold.to_bytes(8, "little"), n & 0xFFFFFFFF)
    if m != n:
        c = zlib.crc32(payload[m:], c)
    return c & 0xFFFFFFFF


_KIND_ROLLOUT = 0
_KIND_WEIGHTS = 1
_KIND_HEARTBEAT = 2
_KIND_METRICS = 5
_HEADER = struct.Struct(">BI")
_CRC = struct.Struct(">I")
_WIRE_HDR = _HEADER.size + _CRC.size
MAX_FRAME = 512 * 1024 * 1024
_RECV_CHUNK = 256 * 1024
# at most one liveness echo a second, however fast frames arrive
_ECHO_MIN_INTERVAL_S = 1.0


def _pack_header(kind: int, length: int) -> bytes:
    head = _HEADER.pack(kind, length)
    return head + _CRC.pack(frame_crc32(head))


_HEARTBEAT_FRAME = _pack_header(_KIND_HEARTBEAT, 0) + _CRC.pack(frame_crc32(b""))


class FrameCorrupt(ValueError):
    """A frame whose payload CRC trailer does not match (header intact: the
    stream stays in sync, the frame alone is dropped)."""


class FramingLost(ConnectionError):
    """A frame whose header failed its CRC: the length word cannot be
    trusted, and the connection must be torn down."""


def _send_frame(sock: socket.socket, kind: int, payload, crc: Optional[int] = None) -> None:
    """One frame as a gather write. ``crc`` overrides the trailer (a test
    writes a deliberately wrong one)."""
    header = _pack_header(kind, len(payload))
    trailer = _CRC.pack(frame_crc32(payload) if crc is None else crc)
    parts = [header, payload, trailer]
    total = len(header) + len(payload) + len(trailer)
    sent = sock.sendmsg(parts)
    if sent < total:  # a partial send: finish each part's tail
        rem = sent
        for part in parts:
            if rem >= len(part):
                rem -= len(part)
                continue
            sock.sendall(memoryview(part)[rem:] if rem else part)
            rem = 0


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket) -> Optional[Tuple[int, bytes]]:
    """The next frame as ``(kind, payload)``; None on a clean close."""
    head = _recv_exact(sock, _WIRE_HDR)
    if head is None:
        return None
    kind, length = _HEADER.unpack_from(head)
    if _CRC.unpack_from(head, _HEADER.size)[0] != frame_crc32(head[: _HEADER.size]):
        raise FramingLost("frame header corrupt — length untrustworthy")
    if length > MAX_FRAME:
        raise ValueError(f"frame of {length} bytes exceeds MAX_FRAME")
    payload = _recv_exact(sock, length)
    if payload is None:
        return None
    trailer = _recv_exact(sock, _CRC.size)
    if trailer is None:
        return None
    if _CRC.unpack(trailer)[0] != frame_crc32(payload):
        raise FrameCorrupt(f"frame CRC mismatch ({length} byte payload)")
    return kind, payload


class _Conn:
    """One actor connection: its socket and the latest-wins weights slot
    its writer drains. ``sent_seq`` trails ``pending_seq`` while a send is
    in flight (the connection's fanout lag); ``last_seen`` (monotonic, any
    inbound bytes) drives the idle drop; ``bad_streak`` counts corrupt
    frames in a row toward the quarantine."""

    __slots__ = ("sock", "cond", "pending", "pending_crc", "pending_seq", "sent_seq", "dead", "last_seen",
                 "bad_streak")

    def __init__(self, sock: socket.socket, seq: int) -> None:
        self.sock = sock
        self.cond = threading.Condition()
        self.pending: Optional[bytes] = None
        self.pending_crc = 0
        self.pending_seq = seq
        self.sent_seq = seq
        self.dead = False
        self.last_seen = time.monotonic()
        self.bad_streak = 0


class TransportServer:
    """The learner's side: accept actors, merge their experience, fan the
    weights out. ``address`` is the bound ``(host, port)``."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        max_rollouts: int = 4096,
        fanout_max_lag: int = 8,
        poison_frame_limit: int = 8,
        heartbeat_interval_s: float = 5.0,
        idle_timeout_s: float = 30.0,
        registry: Optional[telemetry.Registry] = None,
    ) -> None:
        self._listener = socket.create_server((host, port))
        self.address = self._listener.getsockname()
        self._max_rollouts = max_rollouts
        self._fanout_max_lag = max(1, fanout_max_lag)
        self._poison_frame_limit = max(1, poison_frame_limit)
        self._heartbeat_s = max(0.0, heartbeat_interval_s)
        self._idle_timeout_s = max(0.0, idle_timeout_s)
        # the writer's wake period: fine enough for short heartbeat and
        # idle windows, at most 0.5 s
        windows = [v / 4 for v in (self._heartbeat_s, self._idle_timeout_s) if v]
        self._tick_s = min(0.5, *windows) if windows else 0.5
        self._rollouts: Deque[Tuple[float, bytes]] = deque()
        self._roll_cond = threading.Condition()
        self._conns: List[_Conn] = []
        self._conns_lock = threading.Lock()
        self.bad_payloads = 0
        self._latest_weights: Optional[pb.ModelWeights] = None
        self._latest_payload: Optional[bytes] = None
        self._latest_crc = 0
        self._publish_seq = 0
        self._weights_lock = threading.Lock()
        self._closed = threading.Event()
        self.dropped = 0
        self._tel = registry if registry is not None else telemetry.get_registry()
        for name in ("transport/weights_coalesced", "transport/fanout_conns_dropped", "transport/weights_sent",
                     "transport/frames_corrupt_total", "transport/peers_quarantined", "transport/conn_idle_drops",
                     "transport/heartbeats_sent", "transport/reader_exits", "transport/rollout_bytes_total",
                     "transport/rollout_raw_bytes_total", "transport/malformed_payloads_total"):
            self._tel.counter(name)
        for name in ("transport/fanout_lag_max", "transport/fanout_queue_depth", "transport/actors_connected"):
            self._tel.gauge(name)
        # 1.0 until the first payload: no data, no compression claim
        self._tel.gauge("transport/rollout_compression_ratio").set(1.0)
        self._rollout_totals = [0, 0]   # [wire bytes, raw bytes] consumed
        # the fleet snapshot sink (the learner's FleetAggregator.ingest);
        # None drops kind-5 frames
        self.metrics_handler = None
        self._accept_thread = threading.Thread(target=self._accept_loop, name="transport-accept", daemon=True)
        self._accept_thread.start()

    # -- connections -----------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return  # the listener closed
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._weights_lock:
                # the baseline is the current publish: a placeholder of 0
                # would read as that many publishes of lag
                conn = _Conn(sock, self._publish_seq)
            # append before reading the latest payload: publish_weights
            # writes the payload before it snapshots the list, so either it
            # assigns this connection's slot or the read below sees it
            with self._conns_lock:
                self._conns.append(conn)
            with self._weights_lock:
                payload, payload_crc, seq = self._latest_payload, self._latest_crc, self._publish_seq
            with conn.cond:
                if payload is not None and (conn.pending is None or conn.pending_seq < seq):
                    # a late joiner gets the current weights through its own
                    # writer; a newer assignment by a racing publish stands
                    conn.pending, conn.pending_crc, conn.pending_seq = payload, payload_crc, seq
                    conn.sent_seq = seq - 1
                    conn.cond.notify()
            threading.Thread(target=self._reader_loop, args=(conn,), name="transport-reader", daemon=True).start()
            threading.Thread(target=self._writer_loop, args=(conn,), name="transport-writer", daemon=True).start()

    def _poison(self, conn: _Conn, fatal: bool = False) -> None:
        """One corrupt frame from ``conn``: count it and quarantine the peer
        (raise, which drops the connection) at ``poison_frame_limit`` in a
        row, or at once when the header, so the framing, is lost."""
        self._tel.counter("transport/frames_corrupt_total").inc()
        conn.bad_streak += 1
        if fatal or conn.bad_streak >= self._poison_frame_limit:
            self._tel.counter("transport/peers_quarantined").inc()
            raise FrameCorrupt(f"peer quarantined after {conn.bad_streak} consecutive corrupt frames")

    def _reader_loop(self, conn: _Conn) -> None:
        """Batched ingest: every complete frame of a wakeup, handed over
        under one lock. A malformed peer is quarantined, never kills the
        thread; a reader's end is counted (``transport/reader_exits``)."""
        recv_buf = bytearray(_RECV_CHUNK)
        recv_view = memoryview(recv_buf)
        acc = bytearray()   # partial frames across recvs
        try:
            while not self._closed.is_set():
                n = conn.sock.recv_into(recv_view)
                if n == 0:
                    break
                conn.last_seen = time.monotonic()
                acc += recv_view[:n]
                frames: List[bytes] = []
                metrics: List[bytes] = []
                off = 0
                # slices of the view are free; bytes() is the one copy a
                # frame (released before the del: an export blocks resizing)
                acc_view = memoryview(acc)
                try:
                    while len(acc) - off >= _WIRE_HDR:
                        kind, length = _HEADER.unpack_from(acc, off)
                        if (_CRC.unpack_from(acc, off + _HEADER.size)[0]
                                != frame_crc32(acc_view[off:off + _HEADER.size]) or length > MAX_FRAME):
                            # the length word is untrustworthy: quarantine
                            # before buffering a phantom payload
                            self._poison(conn, fatal=True)
                        if len(acc) - off - _WIRE_HDR < length + _CRC.size:
                            break   # an incomplete tail: wait for more bytes
                        start = off + _WIRE_HDR
                        off += _WIRE_HDR + length + _CRC.size
                        if _CRC.unpack_from(acc, start + length)[0] != frame_crc32(acc_view[start:start + length]):
                            self._poison(conn)   # dropped and counted
                            continue
                        conn.bad_streak = 0
                        if kind == _KIND_ROLLOUT:
                            frames.append(bytes(acc_view[start:start + length]))
                        elif kind == _KIND_METRICS and self.metrics_handler is not None:
                            metrics.append(bytes(acc_view[start:start + length]))
                        # weights and heartbeat kinds from an actor are
                        # liveness alone
                finally:
                    acc_view.release()
                if off:
                    del acc[:off]
                if frames:
                    self._enqueue_rollouts(frames)
                if metrics:
                    handler = self.metrics_handler
                    for m in metrics:
                        try:
                            handler(m)
                        except Exception:  # noqa: BLE001 - a broken sink never kills a reader
                            pass
        except (OSError, ValueError):
            pass  # a dead or poisoned actor: dropped, it is disposable
        finally:
            if not self._closed.is_set():
                # the connection went away (not the learner's close)
                self._tel.counter("transport/reader_exits").inc()
            self._drop(conn)

    def _enqueue_rollouts(self, frames: List[bytes]) -> None:
        ts = tracing.now()   # one receive stamp a parse batch (the recv hop)
        with self._roll_cond:
            self._rollouts.extend((ts, f) for f in frames)
            over = len(self._rollouts) - self._max_rollouts
            if over > 0:   # drop-oldest backpressure
                for _ in range(over):
                    self._rollouts.popleft()
                self.dropped += over
                self._tel.counter("transport/experience_dropped").inc(over)
            depth = len(self._rollouts)
            self._roll_cond.notify()
        self._tel.counter("transport/experience_published").inc(len(frames))
        self._tel.gauge("transport/queue_depth").set(depth)

    def _writer_loop(self, conn: _Conn) -> None:
        """The connection's one writer: drain the latest-wins slot; between
        publishes send heartbeats every ``heartbeat_interval_s`` and drop
        the connection after ``idle_timeout_s`` without inbound bytes (the
        actor echoes heartbeats, so only a half-open connection trips it)."""
        last_sent = time.monotonic()
        while True:
            heartbeat = idle_drop = False
            payload = None
            with conn.cond:
                while conn.pending is None and not conn.dead and not self._closed.is_set():
                    now = time.monotonic()
                    if self._idle_timeout_s and now - conn.last_seen > self._idle_timeout_s:
                        idle_drop = True
                        break
                    if self._heartbeat_s and now - last_sent >= self._heartbeat_s:
                        heartbeat = True
                        break
                    conn.cond.wait(self._tick_s)
                if conn.dead or self._closed.is_set():
                    return
                if conn.pending is not None:
                    payload, seq, payload_crc = conn.pending, conn.pending_seq, conn.pending_crc
                    conn.pending = None
            if idle_drop:
                self._tel.counter("transport/conn_idle_drops").inc()
                self._drop(conn)
                return
            try:
                if payload is not None:
                    # the CRC was folded once by publish_weights
                    _send_frame(conn.sock, _KIND_WEIGHTS, payload, crc=payload_crc)
                elif heartbeat:
                    conn.sock.sendall(_HEARTBEAT_FRAME)
            except (OSError, ValueError):
                self._drop(conn)
                return
            last_sent = time.monotonic()
            if payload is not None:
                conn.sent_seq = seq
                self._tel.counter("transport/weights_sent").inc()
            elif heartbeat:
                self._tel.counter("transport/heartbeats_sent").inc()

    def _drop(self, conn: _Conn) -> None:
        with self._conns_lock:
            if conn in self._conns:
                self._conns.remove(conn)
        with conn.cond:
            conn.dead = True
            conn.pending = None
            conn.cond.notify_all()
        try:
            # shutdown, not just close, frees a writer stuck in sendall
            conn.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            conn.sock.close()
        except OSError:
            pass

    # -- the transport protocol, learner side -------------------------------------

    def publish_rollout(self, rollout) -> None:
        raise RuntimeError("TransportServer is the learner side; actors publish")

    def _drain(self, max_count: int, timeout: Optional[float]) -> List[Tuple[float, bytes]]:
        """Up to ``max_count`` ``(recv_ts, payload)`` pairs, waiting at most
        ``timeout`` for the first; timed only when something drained."""
        out: List[Tuple[float, bytes]] = []
        t0 = time.perf_counter()
        deadline = None if timeout is None else t0 + timeout
        with self._roll_cond:
            while not self._rollouts:
                if self._closed.is_set():
                    return out
                remaining = None if deadline is None else deadline - time.perf_counter()
                if remaining is not None and remaining <= 0:
                    return out
                # bounded even without a timeout: a close between the check
                # and the wait must not park the caller forever
                self._roll_cond.wait(0.5 if remaining is None else min(remaining, 0.5))
            while self._rollouts and len(out) < max_count:
                out.append(self._rollouts.popleft())
            depth = len(self._rollouts)
        self._tel.timer("span/transport/consume").observe(time.perf_counter() - t0)
        self._tel.counter("transport/experience_consumed").inc(len(out))
        self._tel.gauge("transport/queue_depth").set(depth)
        return out

    def consume_rollouts(self, max_count: int, timeout: Optional[float] = None) -> List["pb.Rollout"]:
        protos = []
        for _recv_ts, payload in self._drain(max_count, timeout):
            r = pb.Rollout()
            try:
                r.ParseFromString(payload)
            except Exception:  # noqa: BLE001 - a malformed sender is dropped
                self.bad_payloads += 1
                continue
            protos.append(r)
        return protos

    def consume_decoded(self, max_count: int, timeout: Optional[float] = None):
        """Drain as decoded ``(meta, arrays)`` pairs (the learner's ingest),
        with the wire byte accounting; malformed payloads are counted in
        ``bad_payloads`` (and ``transport/malformed_payloads_total``, a key the
        reference does not have) and dropped."""
        from dotaclient_tpu_torch.transport.serialize import decode_drained_payloads

        out, bad = decode_drained_payloads(self._drain(max_count, timeout), self._tel, self._rollout_totals)
        if bad:
            self.bad_payloads += bad
            self._tel.counter("transport/malformed_payloads_total").inc(bad)
        return out

    def publish_weights(self, weights: "pb.ModelWeights") -> None:
        """The non-blocking fanout: serialize and fold the CRC once, put the
        payload in every connection's latest-wins slot, drop connections
        past the lag budget. Never writes a socket."""
        payload = weights.SerializeToString()
        payload_crc = frame_crc32(payload)
        with self._weights_lock:
            self._latest_weights = weights
            self._latest_payload = payload
            self._latest_crc = payload_crc
            self._publish_seq += 1
            seq = self._publish_seq
        with self._conns_lock:
            conns = list(self._conns)
        over_budget: List[_Conn] = []
        max_lag = pending_depth = 0
        for conn in conns:
            with conn.cond:
                if conn.pending is not None:
                    # an unsent older version became worthless: latest wins
                    self._tel.counter("transport/weights_coalesced").inc()
                    pending_depth += 1
                conn.pending, conn.pending_crc, conn.pending_seq = payload, payload_crc, seq
                conn.cond.notify()
            lag = seq - conn.sent_seq
            max_lag = max(max_lag, lag)
            if lag > self._fanout_max_lag:
                over_budget.append(conn)
        for conn in over_budget:
            self._tel.counter("transport/fanout_conns_dropped").inc()
            self._drop(conn)
        self._tel.counter("transport/weights_published").inc()
        self._tel.gauge("transport/weights_version").set(weights.version)
        self._tel.gauge("transport/fanout_lag_max").set(float(max_lag))
        self._tel.gauge("transport/fanout_queue_depth").set(float(pending_depth))
        self._tel.gauge("transport/actors_connected").set(self.n_connected)

    def latest_weights(self) -> Optional["pb.ModelWeights"]:
        with self._weights_lock:
            return self._latest_weights

    @property
    def n_connected(self) -> int:
        with self._conns_lock:
            return len(self._conns)

    @property
    def pending_rollouts(self) -> int:
        with self._roll_cond:
            return len(self._rollouts)

    def close(self) -> None:
        self._closed.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for conn in conns:
            with conn.cond:
                conn.dead = True
                conn.cond.notify_all()
            try:
                conn.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.sock.close()
            except OSError:
                pass
        with self._roll_cond:
            self._roll_cond.notify_all()


class SocketTransport:
    """The actor's side: connect to a learner's ``TransportServer``, ship
    rollout and metrics frames, track the newest weights frame it fans
    out."""

    def __init__(
        self,
        host: str,
        port: int,
        timeout: float = 30.0,
        idle_timeout_s: float = 30.0,
        poison_frame_limit: int = 8,
    ) -> None:
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # the socket timeout is the idle detector: a live learner heartbeats
        # far more often than idle_timeout_s
        self._sock.settimeout(idle_timeout_s if idle_timeout_s > 0 else None)
        self._poison_frame_limit = max(1, poison_frame_limit)
        self._send_lock = threading.Lock()
        self._weights_lock = threading.Lock()
        self._latest_weights: Optional[pb.ModelWeights] = None
        self._dead: Optional[BaseException] = None
        self._faults = faults.get()
        self._tel = telemetry.get_registry()
        self._reader = threading.Thread(target=self._reader_loop, name="weights-reader", daemon=True)
        self._reader.start()

    def _reader_loop(self) -> None:
        bad_streak = 0
        last_echo = 0.0
        try:
            while True:
                try:
                    frame = _recv_frame(self._sock)
                except FramingLost:
                    raise   # a ConnectionError: a reconnect gets a fresh stream
                except FrameCorrupt:
                    self._tel.counter("transport/frames_corrupt_total").inc()
                    bad_streak += 1
                    if bad_streak >= self._poison_frame_limit:
                        raise ConnectionError(
                            f"stream unusable after {bad_streak} consecutive corrupt frames"
                        )
                    continue
                except socket.timeout:
                    raise ConnectionError(
                        "learner silent past the idle timeout — half-open connection"
                    ) from None
                if frame is None:
                    raise ConnectionError("learner closed the connection")
                bad_streak = 0
                # echo liveness on any inbound frame (heartbeats one for
                # one, other frames rate-limited), so the learner's idle
                # drop sees this peer alive
                kind, payload = frame
                now = time.monotonic()
                if kind == _KIND_HEARTBEAT or now - last_echo >= _ECHO_MIN_INTERVAL_S:
                    last_echo = now
                    with self._send_lock:
                        self._sock.sendall(_HEARTBEAT_FRAME)
                if kind != _KIND_WEIGHTS:
                    continue
                msg = pb.ModelWeights()
                msg.ParseFromString(payload)
                with self._weights_lock:
                    self._latest_weights = msg
        except BaseException as e:  # noqa: BLE001 - surfaced by _check on the caller's thread
            self._dead = e

    def _check(self) -> None:
        if self._dead is not None:
            raise ConnectionError("transport connection lost") from self._dead

    def latest_weights(self) -> Optional["pb.ModelWeights"]:
        """The newest weights frame received (None before the first);
        raises ``ConnectionError`` once the connection is lost."""
        self._check()
        with self._weights_lock:
            return self._latest_weights

    def publish_rollout(self, rollout: "pb.Rollout") -> None:
        self.publish_rollout_bytes(rollout.SerializeToString())

    def publish_rollout_bytes(self, payload) -> None:
        """Ship one serialized rollout (bytes-like). Raises
        ``ConnectionError`` or ``OSError`` once the connection is gone."""
        self._check()
        crc = None
        f = self._faults
        if f is not None:
            delay = f.value("transport.delay_send")
            if delay:
                time.sleep(delay)
            if f.fire("transport.corrupt_frame"):
                crc = frame_crc32(payload) ^ 0xDEADBEEF
            if f.fire("transport.drop_conn"):
                self._sock.close()   # this send raises: the reconnect takes over
        with self._send_lock:
            _send_frame(self._sock, _KIND_ROLLOUT, payload, crc=crc)

    def publish_metrics_bytes(self, payload) -> None:
        """Ship one fleet snapshot frame (kind 5), framed like a rollout."""
        self._check()
        with self._send_lock:
            _send_frame(self._sock, _KIND_METRICS, payload)

    def consume_rollouts(self, max_count: int, timeout: Optional[float] = None):
        raise RuntimeError("SocketTransport is the actor side; the learner consumes")

    def publish_weights(self, weights) -> None:
        raise RuntimeError("actors do not publish weights")

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
