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

``SocketTransport`` is the receiving half of the learner's weights fanout
(the serve CLI's ``--subscribe host:port``): it connects, keeps the newest
``ModelWeights`` frame, echoes liveness, and declares itself dead after
``idle_timeout_s`` of silence or ``poison_frame_limit`` corrupt frames in a
row. Publishing rollouts and metrics from the port, and the learner-side
``TransportServer``, wait for ROADMAP queue 1, item 4.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
import zlib
from typing import Optional, Tuple

import numpy as np

from dotaclient_tpu_torch.protos import dota_pb2 as pb
from dotaclient_tpu_torch.utils import telemetry

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
# at most one liveness echo a second, however fast frames arrive
_ECHO_MIN_INTERVAL_S = 1.0

_NOT_PORTED = "ROADMAP queue 1, item 4 (the learner's transport and the buffered learner path)"


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


class SocketTransport:
    """Connect to a learner's ``TransportServer`` and track the newest
    weights frame it fans out."""

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

    def publish_rollout(self, rollout) -> None:
        raise NotImplementedError(f"publishing rollouts from the port is not ported yet: {_NOT_PORTED}")

    def publish_rollout_bytes(self, payload) -> None:
        raise NotImplementedError(f"publishing rollouts from the port is not ported yet: {_NOT_PORTED}")

    def publish_metrics_bytes(self, payload) -> None:
        raise NotImplementedError(f"publishing metrics from the port is not ported yet: {_NOT_PORTED}")

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
