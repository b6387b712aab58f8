"""Session-affine router of a serve-backend fleet.

Counterpart of ``dotaclient_tpu/serve/router.py``, on the same wire, so a
JAX client attaches through this router and the port's client through a
JAX one. The :class:`SessionRouter` maps each game (a *session*) to one of N
backends (``PolicyServer`` processes) and keeps the map honest under
failure. Data traffic never touches the router: clients talk to their
backend directly over the serve lane and ask the router only the control
questions ("where do I attach?", "where is my session now?") in two
JSON-payload frame kinds on the shared CRC wire (``KIND_ROUTE_REQUEST`` 6,
``KIND_ROUTE_REPLY`` 7).

Liveness: the router holds one probe connection per backend (it takes one
carry slot of the backend for the router's lifetime) and sends heartbeat
frames (kind 2, which the backend's reader skips) every
``serve.router_probe_s``. A killed backend shows as EOF or RST on that
connection; the probe then tries to reconnect for
``serve.router_dead_after_s`` before it declares the backend dead, so a
blip inside that grace window is not a death.

On a death the router re-homes: a live hot spare (a backend registered with
``--spares``) joins the pool, a routing change only, and every session of
the dead backend moves to the least-loaded live backend with its epoch
bumped, so the client's next ``where`` sees the redirect. What state the
session resumes with is the client's affair (``serve/client.py``): a zeroed
carry by default, the stashed carry row under ``serve.carry_shadow``.

This module is host code only: it imports no torch, so a router process
holds no CUDA context. Telemetry (every ``router/*`` key created at
construction): session and re-home counters, live/dead/spare gauges and
``router/backend/<i>/sessions``. ``router/carry_resets_total`` is created
and stays 0: no caller in the reference reports a carry reset to it. The
router CLI (``main``) runs the alert engine over its own registry, so
``serve_peer_dead`` pages and ``sessions_rehomed_burst`` warns as ``ALERT``
lines in its metrics JSONL.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from dotaclient_tpu_torch.transport.socket_transport import FrameCorrupt, FramingLost, _recv_frame, _send_frame
from dotaclient_tpu_torch.utils import telemetry
from dotaclient_tpu_torch.utils.fleet import peer_label

# kinds 0-2 are the training transport's, 3-4 the serve lane's, 5 a fleet
# metrics snapshot; payloads are JSON and carry the CRC trailer all the same
KIND_ROUTE_REQUEST = 6
KIND_ROUTE_REPLY = 7

_KIND_HEARTBEAT = 2  # probe frames; the backend's reader skips kind != 3


def route_call(sock: socket.socket, request: Dict[str, Any], timeout: float = 5.0) -> Dict[str, Any]:
    """One control round trip on an open router connection: send a JSON
    route request and block for the JSON reply, skipping frames of other
    kinds."""
    sock.settimeout(timeout)
    _send_frame(sock, KIND_ROUTE_REQUEST, json.dumps(request).encode())
    while True:
        frame = _recv_frame(sock)
        if frame is None:
            raise ConnectionError("router closed the connection")
        kind, payload = frame
        if kind != KIND_ROUTE_REPLY:
            continue
        return json.loads(bytes(payload).decode())


class _Backend:
    """One registered backend: address, liveness and its session set. The
    mutable fields are guarded by the router's lock, except the probe
    thread's own socket."""

    __slots__ = ("index", "addr", "spare", "live", "sessions", "probe_sock", "last_ok")

    def __init__(self, index: int, addr: Tuple[str, int], spare: bool):
        self.index = index
        self.addr = addr
        self.spare = spare          # outside the assignment pool until promoted
        self.live = False           # reachability confirmed by the probe
        self.sessions: set = set()  # ids of the sessions homed here
        self.probe_sock: Optional[socket.socket] = None
        self.last_ok = 0.0


class SessionRouter:
    """Session -> backend map, liveness probes and re-homing."""

    def __init__(
        self,
        config: Any,
        backends: List[Tuple[str, int]],
        spares: Optional[List[Tuple[str, int]]] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        registry: Optional[telemetry.Registry] = None,
    ) -> None:
        if not backends:
            raise ValueError("a router needs at least one active backend")
        scfg = config.serve
        self._probe_s = max(0.05, scfg.router_probe_s)
        self._dead_after_s = max(self._probe_s, scfg.router_dead_after_s)
        self._tel = registry if registry is not None else telemetry.get_registry()
        self._lock = threading.Lock()
        self._backends: List[_Backend] = [_Backend(i, addr, spare=False) for i, addr in enumerate(backends)]
        for addr in spares or []:
            self._backends.append(_Backend(len(self._backends), addr, spare=True))
        # session id -> {"backend": index, "epoch": n, "rehomed": bool}; the
        # epoch bumps on every reassignment, so a client holding a stale
        # address learns of the redirect from one integer compare
        self._sessions: Dict[int, Dict[str, Any]] = {}
        self._next_session = 1
        self._closed = threading.Event()
        # the whole key family, so a router that never loses a backend
        # still reports zeros
        for name in (
            "router/sessions_attached_total",
            "router/sessions_detached_total",
            "router/sessions_rehomed_total",
            "router/carry_resets_total",
            "router/spares_promoted_total",
            "router/backend_deaths_total",
            "router/probe_reconnects_total",
            "router/route_requests_total",
            "router/route_errors_total",
        ):
            self._tel.counter(name)
        for name in ("router/backends_live", "router/backends_dead", "router/spares_available",
                     "router/sessions_active"):
            self._tel.gauge(name)
        for b in self._backends:
            self._tel.gauge(f"router/backend/{b.index}/sessions")
        self._listener = socket.create_server((host, port))
        self.address = self._listener.getsockname()
        self._probe_threads = [
            threading.Thread(target=self._probe_loop, args=(b,), name=f"router-probe-{b.index}", daemon=True)
            for b in self._backends
        ]
        for t in self._probe_threads:
            t.start()
        self._accept_thread = threading.Thread(target=self._accept_loop, name="router-accept", daemon=True)
        self._accept_thread.start()

    # -- liveness probes (one thread per backend) ---------------------------

    def _probe_connect(self, b: _Backend) -> Optional[socket.socket]:
        try:
            sock = socket.create_connection(b.addr, timeout=self._probe_s)
        except OSError:
            return None
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(self._probe_s)
        try:
            # the attach frame every joiner gets (the probe keeps its slot)
            frame = _recv_frame(sock)
        except (OSError, FrameCorrupt, FramingLost):
            frame = None
        if frame is None:
            try:
                sock.close()
            except OSError:
                pass
            return None
        return sock

    def _probe_loop(self, b: _Backend) -> None:
        """Own b's probe socket; flip ``b.live`` and trigger re-homing. A
        lost connection gets ``router_dead_after_s`` of reconnects before
        the death is declared; a dead backend that answers again rejoins
        the pool empty (its sessions have moved on)."""
        while not self._closed.is_set():
            sock = self._probe_connect(b)
            if sock is None:
                self._tel.counter("router/probe_reconnects_total").inc()
                if b.live and time.monotonic() - b.last_ok >= self._dead_after_s:
                    self._declare_dead(b)
                if self._closed.wait(min(0.2, self._probe_s)):
                    return
                continue
            b.probe_sock = sock
            b.last_ok = time.monotonic()
            self._set_live(b, True)
            try:
                while not self._closed.is_set():
                    _send_frame(sock, _KIND_HEARTBEAT, b"")
                    try:
                        frame = _recv_frame(sock)
                    except socket.timeout:
                        frame = True  # no reply traffic is the steady state
                    except (FrameCorrupt, FramingLost):
                        frame = True  # the probe lane carries nothing we parse
                    if frame is None:
                        break  # EOF: the backend is gone
                    b.last_ok = time.monotonic()
            except OSError:
                pass  # the send failed: the backend is gone
            finally:
                b.probe_sock = None
                try:
                    sock.close()
                except OSError:
                    pass
            # connection lost: reconnect until the grace window runs out,
            # then declare the death
            lost_at = time.monotonic()
            while not self._closed.is_set() and time.monotonic() - lost_at < self._dead_after_s:
                sock = self._probe_connect(b)
                if sock is not None:
                    b.probe_sock = sock
                    b.last_ok = time.monotonic()
                    self._tel.counter("router/probe_reconnects_total").inc()
                    break
                self._closed.wait(min(0.2, self._probe_s))
            else:
                if not self._closed.is_set():
                    self._declare_dead(b)
                continue
            # back inside the grace window: the heartbeat loop resumes on a
            # fresh connection next turn
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass

    def _set_live(self, b: _Backend, live: bool) -> None:
        with self._lock:
            b.live = live
            self._publish_gauges_locked()

    def _declare_dead(self, b: _Backend) -> None:
        """The failover: promote a live spare, re-home every session of the
        dead backend, bump their epochs, all in one hold of the lock, so a
        route request sees the old world or the new one, never half."""
        with self._lock:
            if not b.live and not b.sessions:
                return  # already handled, or never attached
            b.live = False
            self._tel.counter("router/backend_deaths_total").inc()
            for s in self._backends:
                if s.spare and s.live:
                    s.spare = False
                    self._tel.counter("router/spares_promoted_total").inc()
                    break
            moved = self._rehome_locked(b)
            self._publish_gauges_locked()
        if moved:
            self._tel.counter("router/sessions_rehomed_total").inc(moved)

    def _rehome_locked(self, dead: _Backend) -> int:
        """Move every session homed on ``dead`` to the least-loaded live
        non-spare backend. With no live home the sessions stay parked
        (epoch unchanged) until a later death or ``where`` moves them."""
        moved = 0
        for sid in sorted(dead.sessions):
            target = self._pick_backend_locked()
            if target is None or target is dead:
                break
            dead.sessions.discard(sid)
            target.sessions.add(sid)
            sess = self._sessions[sid]
            sess["backend"] = target.index
            sess["epoch"] += 1
            sess["rehomed"] = True
            moved += 1
        return moved

    def _pick_backend_locked(self) -> Optional[_Backend]:
        pool = [b for b in self._backends if b.live and not b.spare]
        if not pool:
            return None
        return min(pool, key=lambda b: (len(b.sessions), b.index))

    def _publish_gauges_locked(self) -> None:
        live = sum(1 for b in self._backends if b.live and not b.spare)
        dead = sum(1 for b in self._backends if not b.live and not b.spare)
        spares = sum(1 for b in self._backends if b.spare and b.live)
        self._tel.gauge("router/backends_live").set(float(live))
        self._tel.gauge("router/backends_dead").set(float(dead))
        self._tel.gauge("router/spares_available").set(float(spares))
        self._tel.gauge("router/sessions_active").set(float(len(self._sessions)))
        for b in self._backends:
            self._tel.gauge(f"router/backend/{b.index}/sessions").set(float(len(b.sessions)))

    # -- route control plane -------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return  # listener closed
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._conn_loop, args=(sock,), name="router-conn", daemon=True).start()

    def _conn_loop(self, sock: socket.socket) -> None:
        try:
            while not self._closed.is_set():
                try:
                    frame = _recv_frame(sock)
                except (FrameCorrupt, FramingLost):
                    self._tel.counter("router/route_errors_total").inc()
                    return  # control lane: no resync, the client redials
                if frame is None:
                    return  # clean disconnect
                kind, payload = frame
                if kind != KIND_ROUTE_REQUEST:
                    continue
                self._tel.counter("router/route_requests_total").inc()
                try:
                    reply = self._handle(json.loads(bytes(payload).decode()))
                except Exception:  # noqa: BLE001 - the control plane stays up
                    self._tel.counter("router/route_errors_total").inc()
                    reply = {"error": "malformed route request"}
                _send_frame(sock, KIND_ROUTE_REPLY, json.dumps(reply).encode())
        except OSError:
            pass  # a control connection is disposable
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _handle(self, request: Dict[str, Any]) -> Dict[str, Any]:
        op = request.get("op")
        if op == "attach":
            return self.attach()
        if op == "where":
            return self.where(int(request["session"]))
        if op == "detach":
            return self.detach(int(request["session"]))
        if op == "status":
            return self.status()
        self._tel.counter("router/route_errors_total").inc()
        return {"error": f"unknown op {op!r}"}

    def attach(self) -> Dict[str, Any]:
        with self._lock:
            target = self._pick_backend_locked()
            if target is None:
                self._tel.counter("router/route_errors_total").inc()
                return {"error": "no live backend"}
            sid = self._next_session
            self._next_session += 1
            target.sessions.add(sid)
            self._sessions[sid] = {"backend": target.index, "epoch": 0, "rehomed": False}
            self._tel.counter("router/sessions_attached_total").inc()
            self._publish_gauges_locked()
            return {"session": sid, "addr": list(target.addr), "epoch": 0}

    def where(self, sid: int) -> Dict[str, Any]:
        """The session's current home. A session parked on a dead backend
        re-homes here if a live backend has appeared since: the lazy half
        of re-homing, for sessions stranded while no backend was live."""
        with self._lock:
            sess = self._sessions.get(sid)
            if sess is None:
                return {"error": f"unknown session {sid}"}
            b = self._backends[sess["backend"]]
            if not b.live:
                target = self._pick_backend_locked()
                if target is None:
                    return {"error": "no live backend"}
                b.sessions.discard(sid)
                target.sessions.add(sid)
                sess["backend"] = target.index
                sess["epoch"] += 1
                sess["rehomed"] = True
                b = target
                self._tel.counter("router/sessions_rehomed_total").inc()
                self._publish_gauges_locked()
            return {"session": sid, "addr": list(b.addr), "epoch": sess["epoch"], "rehomed": bool(sess["rehomed"])}

    def detach(self, sid: int) -> Dict[str, Any]:
        with self._lock:
            sess = self._sessions.pop(sid, None)
            if sess is not None:
                self._backends[sess["backend"]].sessions.discard(sid)
                self._tel.counter("router/sessions_detached_total").inc()
                self._publish_gauges_locked()
        return {"session": sid, "detached": sess is not None}

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "backends": [
                    {
                        "index": b.index,
                        "addr": list(b.addr),
                        # the fleet row this backend publishes under (serve
                        # peers key on their listen port)
                        "fleet_peer": peer_label("serve", b.addr[1] & 0xFFFF),
                        "live": b.live,
                        "spare": b.spare,
                        "sessions": len(b.sessions),
                    }
                    for b in self._backends
                ],
                "sessions": len(self._sessions),
            }

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        self._closed.set()
        try:
            self._listener.close()
        except OSError:
            pass
        for b in self._backends:
            sock = b.probe_sock
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
        for t in self._probe_threads:
            t.join(timeout=2)


def _parse_addrs(spec: Optional[str]) -> List[Tuple[str, int]]:
    out = []
    for part in (spec or "").split(","):
        if part.strip():
            host, port = part.strip().rsplit(":", 1)
            out.append((host, int(port)))
    return out


def main(argv=None) -> int:
    """Standalone router::

        python -m dotaclient_tpu_torch.serve.router \\
            --listen 127.0.0.1:7799 \\
            --backends 127.0.0.1:7788,127.0.0.1:7789 \\
            --spares 127.0.0.1:7790 --metrics-jsonl router.jsonl

    Prints ``ROUTER_LISTENING {"host", "port"}`` once it listens, appends a
    ``router/*`` snapshot to ``--metrics-jsonl`` every ``--interval`` seconds
    and at exit, with ``ALERT`` lines from the alert engine between them,
    and prints one JSON line of totals when it stops (``--duration`` or
    SIGINT). Imports no torch.
    """
    import argparse
    import dataclasses

    p = argparse.ArgumentParser(description=main.__doc__.split("\n\n")[0])
    p.add_argument("--listen", type=str, default="127.0.0.1:0",
                   help="host:port of the route control lane (port 0 = ephemeral, printed at startup)")
    p.add_argument("--backends", type=str, required=True, help="comma-separated host:port of active backends")
    p.add_argument("--spares", type=str, default=None,
                   help="comma-separated host:port of hot spares (promotion is a routing change)")
    p.add_argument("--serve", type=str, default=None, metavar="K=V,...",
                   help="ServeConfig overrides (router_probe_s, router_dead_after_s, ...)")
    p.add_argument("--metrics-jsonl", type=str, default=None, metavar="PATH",
                   help="append router telemetry snapshots and ALERT events to PATH")
    p.add_argument("--interval", type=float, default=1.0, help="snapshot and alert cadence in seconds")
    p.add_argument("--duration", type=float, default=0.0, help="route for this many seconds then exit (0 = forever)")
    args = p.parse_args(argv)

    from dotaclient_tpu_torch.config import ServeConfig, default_config
    from dotaclient_tpu_torch.utils.alerts import AlertEngine
    from dotaclient_tpu_torch.utils.overrides import parse_dataclass_overrides

    config = default_config()
    if args.serve:
        try:
            over = parse_dataclass_overrides(ServeConfig, args.serve, "--serve")
        except ValueError as e:
            p.error(str(e))
        config = dataclasses.replace(config, serve=dataclasses.replace(config.serve, **over))

    host, port = args.listen.rsplit(":", 1)
    tel = telemetry.get_registry()
    router = SessionRouter(config, _parse_addrs(args.backends), spares=_parse_addrs(args.spares),
                           host=host, port=int(port), registry=tel)
    sink = telemetry.JsonlSink(args.metrics_jsonl) if args.metrics_jsonl else None
    engine = AlertEngine(registry=tel, emit=sink.emit_event if sink is not None else None)
    print("ROUTER_LISTENING " + json.dumps({"host": router.address[0], "port": int(router.address[1])}), flush=True)
    ticks = 0
    t_end = time.time() + args.duration if args.duration else None
    try:
        while t_end is None or time.time() < t_end:
            time.sleep(args.interval)
            ticks += 1
            counters, gauges = tel.counters_and_gauges()
            snapshot = {**counters, **gauges}
            engine.evaluate(snapshot)
            if sink is not None:
                sink.emit(ticks, snapshot)
    except KeyboardInterrupt:
        pass
    finally:
        router.close()
        counters, gauges = tel.counters_and_gauges()
        if sink is not None:
            sink.emit(ticks + 1, {**counters, **gauges})
            sink.close()
        print(json.dumps({
            "router_sessions_attached": counters.get("router/sessions_attached_total", 0.0),
            "router_sessions_rehomed": counters.get("router/sessions_rehomed_total", 0.0),
            "router_backend_deaths": counters.get("router/backend_deaths_total", 0.0),
        }), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
