"""Serve-plane client: one game, one session, bounded failure.

Counterpart of ``dotaclient_tpu/serve/client.py`` in direct mode, on the
same wire, so it talks to the port's ``PolicyServer`` and to a JAX one.
``step(obs)`` sends one request frame and blocks until the reply that
echoes its id arrives. Recurrent state stays on the server, in the slot it
assigned at attach; ``reset=True`` on an episode's first step zeroes it.

Failure is bounded, never a hang: each ``step()`` spends from a deadline
budget (``serve.request_deadline_s``) across at most
``serve.request_retries`` resends, reconnecting through
``connect_with_backoff``, and raises :class:`ServeDeadlineError` when the
budget is spent. A reconnect lands on a fresh slot, so the next request
either resends the stashed carry row (``serve.carry_shadow``) or is sent
with ``reset=True``, counted in ``carry_resets``. ``retries_total`` counts
the failed attempts that were retried or ended a request. The caller's
stop hook (``should_abort``, a SIGTERM latch, say) ends a step, its
recovery and every backoff between reconnects within one sleep, raising
``ConnectionError``.

Fleet mode (``router=True``): ``(host, port)`` names a
:class:`~dotaclient_tpu_torch.serve.router.SessionRouter`. The client
attaches through the router, talks to its backend (``backend_addr``)
directly, and after any backend failure asks the router ``where`` its
session lives now, following a new epoch to the backend or promoted spare
it was re-homed to (``rehomed_count``, ``last_rehomed``). Until the router
declares the old backend dead, ``where`` answers with the old address and
the client polls inside its deadline. ``close`` detaches the session.

Tracing (``utils/tracing.py``): with a process tracer configured, every
``trace_sample_n``-th request carries a record with its ``encode`` hop as
an unpadded ``__trace__`` blob; the server stamps ``recv`` and ``reply``
and echoes it, and the client stamps ``done`` and emits it.
"""

from __future__ import annotations

import socket
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from dotaclient_tpu_torch.actor.backoff import connect_with_backoff
from dotaclient_tpu_torch.config import RunConfig
from dotaclient_tpu_torch.models.distributions import HEADS
from dotaclient_tpu_torch.serve.router import route_call
from dotaclient_tpu_torch.serve.server import ATTACH_REQUEST_ID, KIND_SERVE_REPLY, KIND_SERVE_REQUEST
from dotaclient_tpu_torch.transport.serialize import (
    decode_rollout_bytes,
    encode_rollout_bytes,
    rollout_int_bounds,
)
from dotaclient_tpu_torch.transport.socket_transport import _recv_frame, _send_frame
from dotaclient_tpu_torch.utils import tracing


class ServeDeadlineError(ConnectionError):
    """A request's deadline budget elapsed (retries and reconnects
    included): ``step()`` returns an action or raises this within
    ``serve.request_deadline_s``."""


def serve_request_wire_kwargs(config: RunConfig) -> Dict[str, Any]:
    """Encode kwargs of the request wire: ``{}`` at full width, the rollout
    cast plan's (bf16 floats, exact bounded ints) otherwise."""
    if config.serve.request_wire_dtype == "float32":
        return {}
    return dict(wire_dtype=config.serve.request_wire_dtype, int_bounds=rollout_int_bounds(config))


class ServeClient:
    """Blocking request/reply client for one game (direct or fleet mode)."""

    def __init__(
        self,
        host: str,
        port: int,
        config: RunConfig,
        timeout_s: float = 30.0,
        router: bool = False,
        max_reconnects: int = 6,
        should_abort: Optional[Callable[[], bool]] = None,
    ) -> None:
        scfg = config.serve
        self._timeout_s = timeout_s
        self._deadline_s = max(0.05, scfg.request_deadline_s)
        self._retries = max(0, int(scfg.request_retries))
        self._shadow = bool(scfg.carry_shadow)
        self._max_reconnects = max(1, int(max_reconnects))
        self._should_abort = should_abort
        self._wire_kwargs = serve_request_wire_kwargs(config)
        self._next_id = 1  # 0 is the attach frame's id
        self.slot = -1
        self.last_version = 0
        self.last_logp = 0.0
        self.last_latency_s = 0.0
        self.last_dispatch_idx = -1
        self._last_packed = np.zeros((len(HEADS),), np.int32)
        # fleet mode
        self._router = bool(router)
        self._router_addr: Optional[Tuple[str, int]] = None
        self._route_sock: Optional[socket.socket] = None
        self.session: Optional[int] = None
        self._epoch = -1
        # failover bookkeeping
        self.rehomed_count = 0
        self.last_rehomed = False
        self.carry_resets = 0
        self.retries_total = 0
        self._carry_stash: Optional[Dict[str, np.ndarray]] = None
        self._pending_restore = False
        self._sock: Optional[socket.socket] = None
        self.backend_addr: Tuple[str, int] = (host, port)
        deadline = time.monotonic() + self._deadline_s
        try:
            if self._router:
                self._router_addr = (host, port)
                info = self._route({"op": "attach"}, deadline)
                if "error" in info:
                    raise ConnectionError(f"router attach failed: {info['error']}")
                self.session = int(info["session"])
                self._epoch = int(info["epoch"])
                self.backend_addr = (info["addr"][0], int(info["addr"][1]))
            self._connect_backend(deadline)
        except BaseException:
            self.close()
            raise

    # -- connection ------------------------------------------------------------

    def _abort_by(self, deadline: float) -> Callable[[], bool]:
        """The backoff's stop predicate: the caller's stop hook, or the
        request deadline."""
        def abort() -> bool:
            return (self._should_abort is not None and self._should_abort()) or time.monotonic() >= deadline
        return abort

    def _stop_requested(self) -> None:
        if self._should_abort is not None and self._should_abort():
            raise ConnectionError("serve client stopping: stop requested")

    def _connect_backend(self, deadline: float) -> None:
        """Connect and read the attach frame."""

        def factory() -> socket.socket:
            sock = socket.create_connection(self.backend_addr, timeout=self._timeout_s)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(self._timeout_s)
            try:
                # the first frame names this connection's slot and the
                # server's weights version; a shed joiner is closed unread
                meta = self._recv_reply_on(sock, ATTACH_REQUEST_ID, deadline)[0]
            except BaseException:
                sock.close()
                raise
            self.slot = meta["env_id"]
            self.last_version = meta["model_version"]
            return sock

        self._sock = connect_with_backoff(
            factory, max_attempts=self._max_reconnects, base_delay=0.1, max_delay=1.0,
            should_abort=self._abort_by(deadline),
        )

    def _close_backend(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _close_route(self) -> None:
        if self._route_sock is not None:
            try:
                self._route_sock.close()
            except OSError:
                pass
            self._route_sock = None

    def _route(self, request: Dict[str, Any], deadline: float) -> Dict[str, Any]:
        """One router round trip, redialing the control connection once if
        it went stale, inside the deadline either way."""
        redialed = False
        while True:
            if self._route_sock is None:
                def factory() -> socket.socket:
                    s = socket.create_connection(self._router_addr, timeout=self._timeout_s)
                    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    return s

                self._route_sock = connect_with_backoff(
                    factory, max_attempts=self._max_reconnects, base_delay=0.1, max_delay=1.0,
                    should_abort=self._abort_by(deadline),
                )
            try:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ServeDeadlineError("route round trip would exceed the request deadline")
                return route_call(self._route_sock, request, timeout=min(self._timeout_s, remaining))
            except ServeDeadlineError:
                raise
            except (OSError, ConnectionError, ValueError):
                self._close_route()
                if redialed:
                    raise
                redialed = True

    def _recover(self, deadline: float) -> None:
        """After a failed attempt: find the session's home (fleet mode asks
        the router and follows a redirect) and reconnect, looping until
        connected or the deadline budget is spent."""
        self._close_backend()
        # the old slot is gone: the next request restores or resets
        self._pending_restore = True
        while True:
            self._stop_requested()
            if time.monotonic() >= deadline:
                raise ServeDeadlineError("recovery exceeded the request deadline budget")
            try:
                if self._router:
                    info = self._route({"op": "where", "session": self.session}, deadline)
                    if "error" in info:
                        # no live backend yet: poll inside the budget
                        time.sleep(0.05)
                        continue
                    epoch = int(info["epoch"])
                    if epoch != self._epoch:
                        # the redirect: the session was re-homed
                        self._epoch = epoch
                        self.backend_addr = (info["addr"][0], int(info["addr"][1]))
                        self.rehomed_count += 1
                        self.last_rehomed = True
                self._connect_backend(deadline)
                return
            except ServeDeadlineError:
                raise
            except (OSError, ConnectionError):
                # refused or mid-restart: go around, inside the deadline
                time.sleep(0.05)

    # -- request/reply -------------------------------------------------------

    def _recv_reply_on(self, sock: socket.socket, request_id: int, deadline: float) -> Tuple[Dict[str, Any], Any]:
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout("request deadline elapsed mid-wait")
            sock.settimeout(min(self._timeout_s, remaining))
            frame = _recv_frame(sock)
            if frame is None:
                raise ConnectionError("serve server closed the connection")
            kind, payload = frame
            if kind != KIND_SERVE_REPLY:
                continue  # other kinds: skip, stay in sync
            meta, arrays = decode_rollout_bytes(payload, upcast=True)
            if meta["rollout_id"] == request_id:
                return meta, arrays
            # an echo of an earlier id: keep draining

    def _step_once(self, obs: Dict[str, np.ndarray], reset: bool, deadline: float) -> Dict[str, int]:
        request_id = self._next_id
        self._next_id += 1
        send_reset, send_carry = reset, None
        if self._pending_restore:
            if self._shadow and self._carry_stash is not None:
                send_carry = self._carry_stash  # resume exactly on the new slot
            else:
                send_reset = True  # the new slot's carry is zeros: say so
        trace_blob = None
        tracer = tracing.get()
        if tracer is not None and tracer.should_sample():
            # the server stamps recv and reply and echoes the record; done
            # below closes the round trip
            rec = tracing.append_hop(tracing.new_record(tracer.next_tid(self.slot), self.slot, self.last_version),
                                     "encode")
            trace_blob = tracing.record_to_blob(rec, pad=False)
        arrays: Dict[str, Any] = {"obs": obs, "reset": np.asarray(1.0 if send_reset else 0.0, np.float32)}
        if send_carry is not None:
            arrays["carry"] = send_carry
        payload = encode_rollout_bytes(
            arrays, model_version=self.last_version, env_id=self.slot, rollout_id=request_id,
            length=1, total_reward=0.0, **self._wire_kwargs, trace=trace_blob,
        )
        t0 = time.perf_counter()
        _send_frame(self._sock, KIND_SERVE_REQUEST, payload)
        meta, reply = self._recv_reply_on(self._sock, request_id, deadline)
        self.last_latency_s = time.perf_counter() - t0
        if tracer is not None and "trace_blob" in meta:
            rec = tracing.parse_blob(meta["trace_blob"])
            if rec is not None:
                tracer.emit_chunk(tracing.append_hop(rec, "done"))
        if self._pending_restore:
            self._pending_restore = False
            if send_carry is None:
                self.carry_resets += 1
        self.last_version = meta["model_version"]
        self._last_packed = np.asarray(reply["actions"]).astype(np.int32)
        self.last_logp = float(np.asarray(reply["logp"]).reshape(-1)[0])
        if "dispatch_idx" in reply:
            self.last_dispatch_idx = int(np.asarray(reply["dispatch_idx"]).reshape(-1)[0])
        if self._shadow and reply.get("carry") is not None:
            self._carry_stash = reply["carry"]
        return {h: int(self._last_packed[j]) for j, h in enumerate(HEADS)}

    def step(self, obs: Dict[str, np.ndarray], reset: bool = False) -> Dict[str, int]:
        """One action for one observation (unbatched leaves): the per-head
        indices. The joint log-prob, weights version, packed row, dispatch
        index and round-trip time land on ``last_logp``, ``last_version``,
        ``last_packed``, ``last_dispatch_idx`` and ``last_latency_s``.
        Resolves within ``serve.request_deadline_s`` (retries, reconnects
        and router redirects included) or raises
        :class:`ServeDeadlineError`."""
        deadline = time.monotonic() + self._deadline_s
        attempts = 0
        while True:
            self._stop_requested()
            try:
                return self._step_once(obs, reset, deadline)
            except ServeDeadlineError:
                raise
            except (OSError, ConnectionError, ValueError) as e:
                # socket.timeout is an OSError, FrameCorrupt a ValueError
                last_err = e
            attempts += 1
            self.retries_total += 1
            if time.monotonic() >= deadline or attempts > self._retries:
                raise ServeDeadlineError(
                    f"serve request failed after {attempts} attempt(s) inside the {self._deadline_s:.1f}s "
                    f"budget ({type(last_err).__name__}: {last_err})"
                ) from last_err
            self._recover(deadline)

    @property
    def last_packed(self) -> np.ndarray:
        """The raw packed ``[5]`` int32 action row of the last reply."""
        return self._last_packed

    @property
    def last_carry(self) -> Optional[Dict[str, np.ndarray]]:
        """The carry-shadow row (the opaque wire dict ``c0..``) of the last
        reply; None unless the server runs ``serve.carry_shadow``."""
        return self._carry_stash

    def close(self) -> None:
        if self._router and self.session is not None:
            try:
                self._route({"op": "detach", "session": self.session}, time.monotonic() + 1.0)
            except (OSError, ConnectionError, ValueError):
                pass  # router gone: nothing to detach from
        self._close_backend()
        self._close_route()
