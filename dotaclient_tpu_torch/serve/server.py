"""Socket front door of the serving plane: request/reply on the framed lane.

Counterpart of ``dotaclient_tpu/serve/server.py``, on the same wire, so a
JAX ``ServeClient`` talks to this server and the port's client to a JAX
server. Frames are the transport lane's (``transport/socket_transport.py``):
header CRC (framing loss is fatal), payload CRC trailer, corrupt frames
dropped and counted (``transport/frames_corrupt_total``), and a peer that
sends ``transport.poison_frame_limit`` bad frames in a row quarantined
(``transport/peers_quarantined``): its connection cut and its slot
reclaimed. The serve lane's kinds are ``KIND_SERVE_REQUEST`` (3) and
``KIND_SERVE_REPLY`` (4).

A request is ``encode_rollout_bytes({"obs": ..., "reset": ...})`` (with
``serve.request_wire_dtype="bfloat16"`` narrowed by the rollout cast plan),
``env_id`` the client's slot and ``rollout_id`` the request id the reply
echoes. A reply carries the packed per-head actions, the joint log-prob,
the dispatch index, and the weights version that sampled it
(``model_version``). With a process tracer configured
(``utils/tracing.py``), a request's ``__trace__`` record gets its ``recv``
hop on receive (a ``serve_request`` event is emitted) and its ``reply`` hop
when the writer sends the answer, which carries it back unpadded.

Threads: one accept loop; per connection a reader, which decodes and calls
``ServeEngine.submit`` with host numpy only, and a writer, the only thread
that writes the socket. Every device operation stays on the engine's
batcher thread.

Slots: the server allocates the lowest free carry slot at accept and sends
an attach frame (a reply-kind frame whose ``env_id`` names the slot and
whose request id is ``ATTACH_REQUEST_ID``); disconnect and quarantine
release the slot, and the engine zeroes its carry row between dispatches.
With every slot taken a joiner is closed at once
(``serve/conns_rejected_total``).

Weights: ``attach_weights_source`` polls a fanout (anything with
``latest_weights()``, such as ``SocketTransport``) and hands every newer
frame, converted and sliced, to the engine's between-dispatch swap.
"""

from __future__ import annotations

import heapq
import socket
import threading
from collections import deque
from typing import Any, Deque, List, Optional, Tuple

import numpy as np

from dotaclient_tpu_torch.models.distributions import HEADS
from dotaclient_tpu_torch.serve.engine import ServeEngine
from dotaclient_tpu_torch.serve.policy_path import weights_frame_to_params
from dotaclient_tpu_torch.transport.serialize import decode_rollout_bytes, encode_rollout_bytes
from dotaclient_tpu_torch.transport.socket_transport import (
    FrameCorrupt,
    FramingLost,
    _recv_frame,
    _send_frame,
)
from dotaclient_tpu_torch.utils import telemetry, tracing

# kinds 0-2 belong to the training transport; the serve lane extends them
KIND_SERVE_REQUEST = 3
KIND_SERVE_REPLY = 4

# the attach frame's request id: clients number requests from 1
ATTACH_REQUEST_ID = 0


def encode_reply(
    actions: np.ndarray, logp: float, version: int, slot: int, request_id: int,
    trace: Optional[bytes] = None, dispatch_idx: int = 0, carry: Optional[dict] = None,
) -> bytes:
    """One reply's wire bytes: packed head indices, joint log-prob and the
    dispatch index; the version in ``model_version``, the slot in
    ``env_id``, the echoed request id in ``rollout_id``. ``trace`` is a
    traced request's record with its server hops; ``carry`` is the
    carry-shadow row (``ServeEngine.carry_row_to_wire``) on shadow-mode
    engines."""
    arrays = {
        "actions": np.asarray(actions, np.int32),
        "logp": np.asarray(logp, np.float32),
        "dispatch_idx": np.asarray(dispatch_idx, np.int32),
    }
    if carry is not None:
        arrays["carry"] = carry
    return encode_rollout_bytes(
        arrays, model_version=version, env_id=slot, rollout_id=request_id, length=1, total_reward=0.0, trace=trace,
    )


class _ServeConn:
    """One attached game: socket, slot, the reply queue its writer drains,
    and the records of its traced requests awaiting their reply."""

    __slots__ = ("sock", "slot", "cond", "replies", "dead", "bad_streak", "traces")

    def __init__(self, sock: socket.socket, slot: int) -> None:
        self.sock = sock
        self.slot = slot
        self.cond = threading.Condition()
        # (actions, logp, version, request_id, dispatch_idx, carry); encoded
        # on the writer thread, so the batcher's reply callback stays O(1)
        self.replies: Deque[Tuple] = deque()
        self.dead = False
        self.bad_streak = 0
        self.traces: dict = {}   # request id -> record, under cond


class PolicyServer:
    """Listener plus per-connection reader and writer threads over a
    ``ServeEngine``."""

    def __init__(
        self,
        engine: ServeEngine,
        config: Any,
        host: str = "127.0.0.1",
        port: int = 0,
        registry: Optional[telemetry.Registry] = None,
    ) -> None:
        self._engine = engine
        self._config = config
        self._poison_frame_limit = max(1, config.transport.poison_frame_limit)
        self._tel = registry if registry is not None else telemetry.get_registry()
        self._listener = socket.create_server((host, port))
        self.address = self._listener.getsockname()
        self._conns: List[_ServeConn] = []
        self._conns_lock = threading.Lock()
        # lowest slot first: a reconnect lands on the slot just freed
        self._free_slots: List[int] = list(range(engine.max_slots))
        heapq.heapify(self._free_slots)
        self._closed = threading.Event()
        self._weights_thread: Optional[threading.Thread] = None
        for name in ("serve/conns_rejected_total", "transport/frames_corrupt_total",
                     "transport/peers_quarantined"):
            self._tel.counter(name)
        self._tel.gauge("serve/clients_connected")
        self._tel.gauge("serve/slots_in_use")
        self._accept_thread = threading.Thread(target=self._accept_loop, name="serve-accept", daemon=True)
        self._accept_thread.start()

    # -- threads -------------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return  # listener closed
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                if not self._free_slots:
                    # every carry slot is owned by a live game: shed the joiner
                    self._tel.counter("serve/conns_rejected_total").inc()
                    try:
                        sock.close()
                    except OSError:
                        pass
                    continue
                slot = heapq.heappop(self._free_slots)
                conn = _ServeConn(sock, slot)
                self._conns.append(conn)
                self._publish_conn_gauges()
            # the attach frame rides the writer's queue: a joiner that never
            # reads wedges only its own writer
            with conn.cond:
                conn.replies.append(
                    (np.zeros((len(HEADS),), np.int32), 0.0, self._engine.version, ATTACH_REQUEST_ID, 0, None)
                )
                conn.cond.notify()
            threading.Thread(target=self._reader_loop, args=(conn,), name="serve-reader", daemon=True).start()
            threading.Thread(target=self._writer_loop, args=(conn,), name="serve-writer", daemon=True).start()

    def _poison(self, conn: _ServeConn, fatal: bool = False) -> None:
        """One corrupt or undecodable frame: count it, and quarantine (raise,
        which drops the connection and frees its slot) at the limit."""
        self._tel.counter("transport/frames_corrupt_total").inc()
        conn.bad_streak += 1
        if fatal or conn.bad_streak >= self._poison_frame_limit:
            self._tel.counter("transport/peers_quarantined").inc()
            raise FrameCorrupt(f"serve client quarantined after {conn.bad_streak} consecutive corrupt frames")

    def _reader_loop(self, conn: _ServeConn) -> None:
        try:
            while not self._closed.is_set():
                try:
                    frame = _recv_frame(conn.sock)
                except FramingLost:
                    self._poison(conn, fatal=True)  # raises: no resync after a bad header
                except FrameCorrupt:
                    self._poison(conn)
                    continue
                if frame is None:
                    return  # clean disconnect
                kind, payload = frame
                if kind != KIND_SERVE_REQUEST:
                    continue  # other kinds: skip, stay in sync
                try:
                    meta, arrays = decode_rollout_bytes(payload, upcast=True)
                    tracer = tracing.get()
                    if tracer is not None and "trace_blob" in meta:
                        # receive and CRC check happened in _recv_frame just
                        # above; the record waits for the writer's reply hop
                        rec = tracing.stamp_serve_recv(meta)
                        if rec is not None:
                            tracer.emit("serve_request", tid=rec["tid"], slot=conn.slot)
                            with conn.cond:
                                conn.traces[meta["rollout_id"]] = rec
                    reset = bool(np.asarray(arrays["reset"]).reshape(-1)[0])
                    # submit validates the obs tree (and a shadow carry row)
                    # here, so a request that cannot be dispatched takes the
                    # poison path and the batcher never sees it
                    self._engine.submit(
                        conn.slot, arrays["obs"], reset,
                        reply=self._make_reply(conn),
                        request_id=meta["rollout_id"],
                        carry=arrays.get("carry"),
                    )
                except Exception:  # noqa: BLE001 - undecodable or lane-incompatible: poison
                    self._poison(conn)
                    continue
                conn.bad_streak = 0
        except (OSError, ValueError):
            pass  # a dead or quarantined client is dropped
        finally:
            self._drop(conn)

    def _make_reply(self, conn: _ServeConn):
        def reply(actions, logp, version, request_id, dispatch_idx, carry=None):
            with conn.cond:
                if conn.dead:
                    raise ConnectionError("serve client gone")
                conn.replies.append((actions, logp, version, request_id, dispatch_idx, carry))
                conn.cond.notify()

        return reply

    def _writer_loop(self, conn: _ServeConn) -> None:
        while True:
            with conn.cond:
                while not conn.replies and not conn.dead and not self._closed.is_set():
                    conn.cond.wait(0.5)
                if conn.dead or self._closed.is_set():
                    return
                batch = list(conn.replies)
                conn.replies.clear()
                reply_traces = {rid: conn.traces.pop(rid) for _a, _l, _v, rid, _d, _c in batch
                                if rid in conn.traces} if conn.traces else {}
            try:
                for actions, logp, version, request_id, didx, carry in batch:
                    blob = None
                    rec = reply_traces.get(request_id)
                    if rec is not None:
                        blob = tracing.record_to_blob(tracing.append_hop(rec, "reply"), pad=False)
                    _send_frame(
                        conn.sock, KIND_SERVE_REPLY,
                        encode_reply(actions, logp, version, conn.slot, request_id, trace=blob, dispatch_idx=didx,
                                     carry=carry),
                    )
            except (OSError, ValueError):
                self._drop(conn)
                return

    def _drop(self, conn: _ServeConn) -> None:
        with self._conns_lock:
            if conn in self._conns:
                self._conns.remove(conn)
                heapq.heappush(self._free_slots, conn.slot)
                # the engine zeroes the slot's carry row between dispatches
                self._engine.release_slot(conn.slot)
                self._publish_conn_gauges()
        with conn.cond:
            conn.dead = True
            conn.cond.notify_all()
        for fn in (lambda: conn.sock.shutdown(socket.SHUT_RDWR), conn.sock.close):
            try:
                fn()
            except OSError:
                pass

    def _publish_conn_gauges(self) -> None:
        """Set the pool's gauges. Called with ``_conns_lock`` held, in the
        critical section that changed the pool, so the last value set is
        always the pool's state."""
        self._tel.gauge("serve/clients_connected").set(float(len(self._conns)))
        self._tel.gauge("serve/slots_in_use").set(float(self._engine.max_slots - len(self._free_slots)))

    # -- weights subscription ------------------------------------------------

    def attach_weights_source(self, source: Any) -> None:
        """Poll ``source.latest_weights()`` every ``serve.weights_poll_s``
        on a thread of its own; every frame newer than the last one applied
        is converted, sliced and handed to the engine."""
        if self._weights_thread is not None:
            raise RuntimeError("weights source already attached")
        poll_s = max(0.01, self._config.serve.weights_poll_s)

        def loop() -> None:
            last_seen = self._engine.version
            while not self._closed.wait(poll_s):
                try:
                    msg = source.latest_weights()
                except ConnectionError:
                    return  # fanout gone: keep serving the last version
                if msg is None or msg.version <= last_seen:
                    continue
                last_seen, params = weights_frame_to_params(msg)
                self._engine.submit_weights(last_seen, params)

        self._weights_thread = threading.Thread(target=loop, name="serve-weights", daemon=True)
        self._weights_thread.start()

    # -- lifecycle -----------------------------------------------------------

    @property
    def n_connected(self) -> int:
        with self._conns_lock:
            return len(self._conns)

    def close(self) -> None:
        self._closed.set()
        # shutdown wakes the accept loop (a bare close leaves it blocked)
        for fn in (lambda: self._listener.shutdown(socket.SHUT_RDWR), self._listener.close):
            try:
                fn()
            except OSError:
                pass
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            self._drop(conn)
        self._accept_thread.join(timeout=5)
        if self._weights_thread is not None:
            self._weights_thread.join(timeout=5)
