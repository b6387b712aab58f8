"""Continuous-batching inference engine: the serving plane's hot loop.

Counterpart of ``dotaclient_tpu/serve/engine.py`` with the same semantics.
Many remote games each want ONE action at tight latency. The engine collects
per-game step requests into preallocated staging lanes until
``serve.batch_window_ms`` elapses or ``serve.max_batch`` requests are staged
(whichever first), runs one dispatch over the padded batch, and replies per
requester.

Carry residency: recurrent state never rides the wire. Each attached game
owns a carry SLOT in a device-resident store ``[max_slots + 1, ...]`` per
leaf of the policy's carry tree (``(c, h)`` for the LSTM core; ``valid``
and each layer's ``k``, ``v`` for the transformer core), kept as the flat
tuple of leaves in ``tree_leaves`` order; a dispatch gathers the batch's rows, zeroes the rows of new
episodes (and of padding), steps the policy, and writes the new rows back in
place with ``index_copy_``. Row ``max_slots`` is a scratch slot: padding rows
gather and scatter it, so they never touch a live game, and a window never
holds two requests for one slot (the second waits for the next window).

Weight swaps, slot releases and carry-shadow installs are marshalled to the
batcher thread and applied BETWEEN dispatches, so every action of one batch
comes from one weights version (the version rides each reply), and every
carry mutation happens on the batcher thread. Releases and installs are
taken in the same hold of the lock that closes a window, and applied before
it dispatches: a request that joins an open window never dispatches ahead
of the shadow row it carries or of a release of its slot that came before
it, and a released game's requests still in the window are dropped. (The
reference takes them once per batcher turn, before it opens the window, so
a request that joins the open window dispatches without them.)

Sampling determinism: dispatch ``i`` draws its Gumbel noise from a
generator seeded from ``(serve.seed, i)``, so ``reference_step`` replays a
recorded stream bit for bit through the same dispatch function.

Host syncs: the dispatch enqueues the staging copies, the policy step and
the carry scatter; the one sync per dispatch is the fetch of the actions
and log-probs the replies need.

The engine owns the ``Policy`` module it is given: dispatches run it through
``torch.func.functional_call`` with the engine's own params, serialized by a
lock, and never change its registered parameters.

Telemetry (created eagerly): ``serve/requests_total``,
``serve/replies_total``, ``serve/reply_errors_total``,
``serve/dispatches_total``, ``serve/batch_window_hits``,
``serve/max_batch_hits``, ``serve/weight_swaps_total``,
``serve/dispatch_errors_total``, ``serve/carry_installs_total``,
``serve/batch_fill``, ``serve/p99_latency_ms``, ``serve/weights_version``,
and the ``serve/request`` span (arrival to reply, per request).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Mapping, Optional, Set, Tuple

import numpy as np
import torch
from torch.func import functional_call

from dotaclient_tpu_torch.config import RunConfig
from dotaclient_tpu_torch.device import DeviceLike, resolve_device
from dotaclient_tpu_torch.models import distributions as D
from dotaclient_tpu_torch.models.policy import (
    TORCH_DTYPES,
    Carry,
    Policy,
    mask_carry,
    obs_layout,
)
from dotaclient_tpu_torch.utils import telemetry, tracing, utilization
from dotaclient_tpu_torch.utils.tree import tree_leaves, tree_unflatten

logger = logging.getLogger(__name__)

# reply callback: (packed_actions [5] int32, logp, weights_version,
# request_id, dispatch_index), plus carry=<wire dict> by keyword on
# carry-shadow engines. Runs on the batcher thread: must not block for long.
ReplyFn = Callable[[np.ndarray, float, int, int, int], None]

Params = Mapping[str, Any]


@dataclasses.dataclass
class _Request:
    slot: int
    obs: Dict[str, np.ndarray]
    reset: float
    t0: float
    reply: ReplyFn
    request_id: int


def dispatch_seed(seed: int, dispatch_idx: int) -> int:
    """Generator seed of dispatch ``dispatch_idx`` (a 63-bit mix of both)."""
    state = np.random.SeedSequence([seed, dispatch_idx]).generate_state(1, np.uint64)
    return int(state[0]) & ((1 << 63) - 1)


class ServeEngine:
    """One batcher thread + preallocated staging lanes + a carry store."""

    def __init__(
        self,
        config: RunConfig,
        policy: Policy,
        params: Params,
        version: int = 0,
        registry: Optional[telemetry.Registry] = None,
        device: DeviceLike = None,
    ) -> None:
        scfg = config.serve
        self._device = resolve_device(device)
        if policy.device != self._device:
            raise ValueError(
                f"policy lives on {policy.device}, the engine on {self._device}"
            )
        self._config = config
        self._scfg = scfg
        self._policy = policy
        self._param_names = {name for name, _ in policy.named_parameters()}
        self._tel = registry if registry is not None else telemetry.get_registry()
        B, S = scfg.max_batch, scfg.max_slots
        self._scratch_slot = S  # padding rows gather/scatter here, never a game
        # Preallocated staging lanes: one [max_batch, ...] host block per obs
        # leaf (pinned on CUDA, so the copy to the device is asynchronous),
        # each with a device twin. Requests are copied in, never stacked.
        self._layout = obs_layout(config.obs, config.actions)
        pin = self._device.type == "cuda"
        self._host_lanes: Dict[str, torch.Tensor] = {
            name: torch.zeros((B,) + shape, dtype=TORCH_DTYPES[dt], pin_memory=pin)
            for name, (shape, dt) in self._layout.items()
        }
        self._lanes: Dict[str, np.ndarray] = {
            name: t.numpy() for name, t in self._host_lanes.items()
        }
        self._dev_lanes = {
            name: torch.empty_like(t, device=self._device)
            for name, t in self._host_lanes.items()
        }
        self._slots_host = torch.full((B,), S, dtype=torch.int64, pin_memory=pin)
        self._reset_host = torch.ones((B,), dtype=torch.float32, pin_memory=pin)
        self._slots_np = self._slots_host.numpy()
        self._reset_np = self._reset_host.numpy()
        self._slots_dev = torch.empty_like(self._slots_host, device=self._device)
        self._reset_dev = torch.empty_like(self._reset_host, device=self._device)
        # Server-resident carries: one row per attached game + the scratch
        # row, updated in place by every dispatch; the leaves of the carry
        # tree, whose structure the one-row template keeps
        with torch.no_grad():
            self._carry_tmpl: Carry = policy.initial_state(1)
            self._carries: Tuple[torch.Tensor, ...] = tuple(tree_leaves(policy.initial_state(S + 1)))
        self._params = self._params_to_device(params)
        self._version = version
        self._seed = scfg.seed
        self._generator = torch.Generator(device=self._device)
        self._call_lock = threading.Lock()
        self._dispatch_idx = 0
        self._cond = threading.Condition()
        self._pending: Deque[_Request] = deque()
        self._window: List[_Request] = []  # the open window's requests
        self._reset_slots: Set[int] = set()
        self._stopped = False
        self._weights_lock = threading.Lock()
        self._pending_weights: Optional[Tuple[int, Dict[str, torch.Tensor]]] = None
        # Carry-shadow plane: replies also hand the requester its updated
        # carry row, and a re-homed client resends it; inbound rows park
        # here and the batcher installs them between dispatches.
        self._carry_shadow = bool(scfg.carry_shadow)
        self._install_carries: Dict[int, Tuple[np.ndarray, ...]] = {}
        self._carry_row_shapes = [tuple(c.shape[1:]) for c in self._carries]

        tracing.ensure_metrics(self._tel)
        for name in (
            "serve/requests_total",
            "serve/replies_total",
            "serve/reply_errors_total",
            "serve/dispatches_total",
            "serve/batch_window_hits",
            "serve/max_batch_hits",
            "serve/weight_swaps_total",
            "serve/dispatch_errors_total",
            "serve/carry_installs_total",
        ):
            self._tel.counter(name)
        self._tel.gauge("serve/batch_fill")
        self._tel.gauge("serve/p99_latency_ms")
        self._tel.gauge("serve/weights_version").set(float(version))
        self._tel.timer("span/serve/request")
        # window_wait / dispatch / reply split of the batcher's wall clock
        self._util = utilization.make_serve(self._tel)
        self._batcher = threading.Thread(
            target=self._batch_loop, name="serve-batcher", daemon=True
        )
        self._batcher.start()

    # -- params -------------------------------------------------------------

    def _params_to_device(self, params: Params) -> Dict[str, torch.Tensor]:
        """Validate a port state dict (tensors or arrays) against the policy
        and commit it to the engine's device as f32."""
        names = set(params)
        if names != self._param_names:
            missing = sorted(self._param_names - names)
            extra = sorted(names - self._param_names)
            raise ValueError(f"params do not fit the policy: missing {missing}, unexpected {extra}")
        return {
            name: (v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))).to(
                self._device, torch.float32
            )
            for name, v in params.items()
        }

    # -- submission (reader / weight-swap threads) --------------------------

    @property
    def max_slots(self) -> int:
        return self._scfg.max_slots

    @property
    def version(self) -> int:
        """Weights version of the last committed swap."""
        return self._version

    @property
    def device(self) -> torch.device:
        return self._device

    def _validate_obs(self, obs: Dict[str, np.ndarray]) -> None:
        """Reject a request whose obs cannot land in the staging lanes, on
        the submitting thread, so the batcher never sees it."""
        for name, (row_shape, _) in self._layout.items():
            leaf = obs.get(name)
            if leaf is None:
                raise ValueError(f"request missing obs leaf {name!r}")
            shape = np.shape(leaf)
            if int(np.prod(shape, dtype=np.int64)) != int(np.prod(row_shape, dtype=np.int64)):
                raise ValueError(
                    f"request obs leaf {name!r} has shape {shape}, "
                    f"incompatible with the serving lane {row_shape}"
                )

    def submit(
        self,
        slot: int,
        obs: Dict[str, np.ndarray],
        reset: bool,
        reply: ReplyFn,
        request_id: int = 0,
        carry: Optional[Dict[str, np.ndarray]] = None,
    ) -> None:
        """Queue one game's step request. ``obs`` is one observation
        (unbatched numpy leaves); ``reset`` marks the first step of an
        episode (the slot's carry is zeroed before the core). ``carry`` is a
        re-homed session's shadowed row, installed before this request
        dispatches; only carry-shadow engines take it."""
        if not 0 <= slot < self._scfg.max_slots:
            raise ValueError(f"slot {slot} out of range [0, {self._scfg.max_slots})")
        self._validate_obs(obs)
        row = None
        if carry is not None:
            if not self._carry_shadow:
                raise ValueError(
                    "request carries a shadow row but serve.carry_shadow is off"
                )
            row = self.wire_to_carry_row(carry)
        req = _Request(
            slot=slot,
            obs=obs,
            reset=1.0 if reset else 0.0,
            t0=time.perf_counter(),
            reply=reply,
            request_id=request_id,
        )
        with self._cond:
            if self._stopped:
                raise RuntimeError("serve engine is stopped")
            if row is not None:
                self._install_carries[slot] = row
            self._pending.append(req)
            self._cond.notify()
        self._tel.counter("serve/requests_total").inc()

    def submit_weights(self, version: int, params: Params) -> None:
        """Latest-wins weight refresh (a port state dict), applied by the
        batcher between dispatches. Versions at or below the newest seen are
        dropped. The params are validated and copied to the device here, on
        the caller's thread."""
        staged = self._params_to_device(params)
        with self._weights_lock:
            newest = (
                self._pending_weights[0]
                if self._pending_weights is not None
                else self._version
            )
            if version <= newest:
                return
            self._pending_weights = (version, staged)
        with self._cond:
            self._cond.notify()

    def release_slot(self, slot: int) -> None:
        """A game detached: zero its carry row (between dispatches, on the
        batcher, before the next window dispatches) and discard its
        still-pending requests, those in the open window included, and its
        shadow row, whose carry would otherwise land in the reclaimed row."""
        with self._cond:
            if any(r.slot == slot for r in self._pending):
                self._pending = deque(r for r in self._pending if r.slot != slot)
            self._window = [r for r in self._window if r.slot != slot]
            self._install_carries.pop(slot, None)
            self._reset_slots.add(slot)
            self._cond.notify()

    def stop(self, timeout: float = 30.0) -> None:
        """Serve every pending request, then stop the batcher."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._batcher.join(timeout)

    @property
    def pending(self) -> int:
        with self._cond:
            return len(self._pending)

    def warm_up(self) -> float:
        """One dispatch of zero observations, every row on the scratch slot,
        so that a game's first request does not pay the device's first calls
        (library loads, cuBLAS set-up). Call it before any game attaches.
        Counted nowhere: no counter, dispatch index or game carry moves.
        Returns its seconds."""
        t0 = time.perf_counter()
        B, dev = self._scfg.max_batch, self._device
        out, _ = self._dispatch(
            # lint-ok: thread-ownership(before any game attaches: the
            # batcher waits on an empty window, and this dispatch writes
            # the scratch slot's carry row alone)
            self._params,
            {name: torch.zeros_like(lane) for name, lane in self._dev_lanes.items()},
            torch.full((B,), self._scratch_slot, dtype=torch.int64, device=dev),
            torch.ones((B,), dtype=torch.float32, device=dev),
            # lint-ok: thread-ownership(the same warm-up dispatch, before
            # any game attaches)
            self._carries,
            torch.Generator(device=dev),
        )
        self._unpack(out)
        return time.perf_counter() - t0

    # -- the dispatch --------------------------------------------------------

    def _dispatch(
        self,
        params: Dict[str, torch.Tensor],
        obs: Dict[str, torch.Tensor],
        slots: torch.Tensor,
        reset: torch.Tensor,
        carries: Tuple[torch.Tensor, ...],
        generator: torch.Generator,
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """Gather, reset, step, sample, scatter (in place into ``carries``,
        the store's leaves). Returns (out [B, 6] int32: five actions then the
        f32 log-prob's bits, the new carry rows' leaves)."""
        with torch.no_grad():
            carry = tree_unflatten(self._carry_tmpl, [c.index_select(0, slots) for c in carries])
            # reset rows (fresh episodes AND padding rows) start from zeros
            carry = mask_carry(carry, 1.0 - reset)
            with self._call_lock:
                logits, _, carry2 = functional_call(self._policy, params, (obs, carry))
            carry2 = tuple(tree_leaves(carry2))
            acts, logp = D.sample(logits, obs, generator=generator)
            packed = torch.stack([acts[h] for h in D.HEADS], dim=1).to(torch.int32)
            for store, new in zip(carries, carry2):
                store.index_copy_(0, slots, new)
            out = torch.cat([packed, logp.float().view(torch.int32)[:, None]], dim=1)
        return out, carry2

    @staticmethod
    def _unpack(out: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        out_np = out.cpu().numpy()
        return out_np[:, :5], np.ascontiguousarray(out_np[:, 5]).view(np.float32)

    # -- batcher thread ------------------------------------------------------

    def _batch_loop(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        while True:
            with self._cond:
                while (
                    not self._pending
                    and not self._reset_slots
                    and not self._stopped
                    and self._peek_pending_weights() is None
                ):
                    # idle waiting for ANY request counts as window_wait
                    t_w = time.perf_counter()
                    self._cond.wait()
                    if self._util is not None:
                        self._util.phase("window_wait", time.perf_counter() - t_w)
                if self._stopped and not self._pending:
                    return
            rows, resets, installs = self._collect_window()
            if resets:
                idx = torch.as_tensor(resets, dtype=torch.int64, device=self._device)
                for c in self._carries:
                    c.index_fill_(0, idx, 0)
            for slot, row in installs:
                # after zeroes (a reclaimed slot re-attached with a shadow
                # row keeps the row), before the window of its request
                for c, leaf in zip(self._carries, row):
                    # a copy: the decoded row may view a read-only payload
                    c[slot] = torch.as_tensor(np.array(leaf)).to(self._device, c.dtype)
                self._tel.counter("serve/carry_installs_total").inc()
            self._apply_pending_weights()
            if rows:
                try:
                    self._dispatch_window(rows)
                except Exception as e:  # noqa: BLE001 - the batcher must outlive any window
                    # request-shaped trouble is rejected at submit; what is
                    # left (a device error) is counted, never silent
                    self._tel.counter("serve/dispatch_errors_total").inc()
                    logger.warning(
                        "serve dispatch failed (%s: %s); window of %d "
                        "request(s) dropped, batcher continues",
                        type(e).__name__, e, len(rows),
                    )
            if self._util is not None:
                self._util.maybe_fold()

    def _peek_pending_weights(self):
        with self._weights_lock:
            return self._pending_weights

    def _apply_pending_weights(self) -> None:
        with self._weights_lock:
            pending, self._pending_weights = self._pending_weights, None
        if pending is None:
            return
        self._version, self._params = pending
        self._tel.gauge("serve/weights_version").set(float(self._version))
        self._tel.counter("serve/weight_swaps_total").inc()

    def _collect_window(self) -> Tuple[List[_Request], List[int], List[Tuple[int, Tuple[np.ndarray, ...]]]]:
        """Fill the open window (``self._window``) until it is full or its
        deadline passes, then close it and, in the same hold of the lock,
        take the slot releases and shadow-row installs submitted so far.
        Returns (the window's requests, the slots to zero, the rows to
        install); the requests are empty when nothing is pending."""
        scfg = self._scfg
        window_s = scfg.batch_window_ms / 1e3
        deadline: Optional[float] = None
        while True:
            with self._cond:
                slots = {r.slot for r in self._window}
                held: List[_Request] = []
                while self._pending and len(self._window) < scfg.max_batch:
                    req = self._pending.popleft()
                    if req.slot in slots:
                        # one request per slot per dispatch: the second
                        # waits for the next window
                        held.append(req)
                        continue
                    self._window.append(req)
                    slots.add(req.slot)
                for req in reversed(held):
                    self._pending.appendleft(req)
                close = not self._window
                if self._window:
                    if deadline is None:
                        # the window opened when the FIRST request arrived
                        deadline = self._window[0].t0 + window_s
                    now = time.perf_counter()
                    if len(self._window) >= scfg.max_batch:
                        self._tel.counter("serve/max_batch_hits").inc()
                        close = True
                    elif now >= deadline or self._stopped:
                        self._tel.counter("serve/batch_window_hits").inc()
                        close = True
                if close:
                    rows, self._window = self._window, []
                    resets = list(self._reset_slots)
                    self._reset_slots.clear()
                    installs = list(self._install_carries.items())
                    self._install_carries.clear()
                    return rows, resets, installs
                self._cond.wait(min(deadline - now, 0.05))
                if self._util is not None:
                    self._util.phase("window_wait", time.perf_counter() - now)

    def _stage(self, rows: List[_Request]) -> None:
        """Copy the window into the host lanes and enqueue their copies to
        the device (asynchronous from pinned memory)."""
        n = len(rows)
        for i, req in enumerate(rows):
            for name, lane in self._lanes.items():
                lane[i] = np.asarray(req.obs[name]).reshape(lane.shape[1:])
            self._slots_np[i] = req.slot
            self._reset_np[i] = req.reset
        self._slots_np[n:] = self._scratch_slot
        self._reset_np[n:] = 1.0            # padding gathers a zeroed carry
        for name, dev in self._dev_lanes.items():
            dev.copy_(self._host_lanes[name], non_blocking=True)
        self._slots_dev.copy_(self._slots_host, non_blocking=True)
        self._reset_dev.copy_(self._reset_host, non_blocking=True)

    def _dispatch_window(self, rows: List[_Request]) -> None:
        n = len(rows)
        t_d = time.perf_counter()
        with self._tel.span("serve/dispatch"):
            self._stage(rows)
            self._generator.manual_seed(dispatch_seed(self._seed, self._dispatch_idx))
            out, carry2 = self._dispatch(
                self._params, self._dev_lanes, self._slots_dev, self._reset_dev,
                self._carries, self._generator,
            )
            # the serving plane's one sync: replies need host actions
            packed_np, logp_np = self._unpack(out)
            carry2_np = (
                tuple(c.float().cpu().numpy() for c in carry2)
                if self._carry_shadow
                else None
            )
        idx = self._dispatch_idx
        self._dispatch_idx += 1
        version = self._version
        t_done = time.perf_counter()
        if self._util is not None:
            self._util.phase("dispatch", t_done - t_d)
        timer = self._tel.timer("span/serve/request")
        errors = 0
        for i, req in enumerate(rows):
            timer.observe(t_done - req.t0)
            try:
                if carry2_np is None:
                    req.reply(packed_np[i], float(logp_np[i]), version, req.request_id, idx)
                else:
                    req.reply(
                        packed_np[i], float(logp_np[i]), version, req.request_id, idx,
                        carry=self.carry_row_to_wire(tuple(c[i] for c in carry2_np)),
                    )
            except Exception:   # noqa: BLE001 - a dead client must not kill the batcher
                errors += 1
        if self._util is not None:
            self._util.phase("reply", time.perf_counter() - t_done)
        self._tel.counter("serve/dispatches_total").inc()
        self._tel.counter("serve/replies_total").inc(n - errors)
        if errors:
            self._tel.counter("serve/reply_errors_total").inc(errors)
        self._tel.gauge("serve/batch_fill").set(n / self._scfg.max_batch)
        self._tel.gauge("serve/p99_latency_ms").set(timer.quantile(0.99) * 1e3)

    # -- parity probe --------------------------------------------------------

    def initial_carries(self) -> Tuple[torch.Tensor, ...]:
        """A fresh all-zero carry store, its leaves (for ``reference_step``)."""
        with torch.no_grad():
            return tuple(tree_leaves(self._policy.initial_state(self._scfg.max_slots + 1)))

    def reference_step(
        self,
        obs_rows: List[Dict[str, np.ndarray]],
        slots: List[int],
        resets: List[float],
        carries: Tuple[torch.Tensor, ...],
        dispatch_idx: int,
        params: Optional[Params] = None,
    ) -> Tuple[np.ndarray, np.ndarray, Tuple[torch.Tensor, ...]]:
        """Replay one dispatch through the same dispatch function the
        batcher runs. Updates ``carries`` (the caller's own store, never the
        live one) in place and returns ``(packed [B, 5], logp [B],
        carries)``; rows past ``len(obs_rows)`` are padding."""
        B = self._scfg.max_batch
        lanes = {name: np.zeros_like(lane) for name, lane in self._lanes.items()}
        slots_np = np.full((B,), self._scratch_slot, np.int64)
        reset_np = np.ones((B,), np.float32)
        for i, obs in enumerate(obs_rows):
            for name, lane in lanes.items():
                lane[i] = np.asarray(obs[name]).reshape(lane.shape[1:])
            slots_np[i] = slots[i]
            reset_np[i] = resets[i]
        dev = self._device
        generator = torch.Generator(device=dev)
        generator.manual_seed(dispatch_seed(self._seed, dispatch_idx))
        out, _ = self._dispatch(
            self._params if params is None else self._params_to_device(params),
            {name: torch.from_numpy(lane).to(dev) for name, lane in lanes.items()},
            torch.from_numpy(slots_np).to(dev),
            torch.from_numpy(reset_np).to(dev),
            carries,
            generator,
        )
        packed_np, logp_np = self._unpack(out)
        return packed_np, logp_np, carries

    # -- carry-shadow wire form ----------------------------------------------

    def carry_row_to_wire(self, row: Tuple[np.ndarray, ...]) -> Dict[str, np.ndarray]:
        """One carry row's leaves -> the flat wire dict replies ship,
        ``{"c<i>": leaf i}`` in ``tree_leaves`` order, which is the
        reference's tree leaf order: ``c0, c1`` = c, h for the LSTM
        core (the bf16 rows upcast exactly to f32), ``c0..c4`` = valid, k0,
        v0, k1, v1 for a two-layer transformer."""
        return {f"c{i}": np.asarray(leaf) for i, leaf in enumerate(row)}

    def wire_to_carry_row(self, wire: Dict[str, np.ndarray]) -> Tuple[np.ndarray, ...]:
        """Inverse of :meth:`carry_row_to_wire`, validated on the submitting
        thread."""
        n = len(self._carry_row_shapes)
        leaves = []
        for i, shape in enumerate(self._carry_row_shapes):
            leaf = wire.get(f"c{i}")
            if leaf is None:
                raise ValueError(f"shadow carry missing leaf c{i} (expected {n})")
            arr = np.asarray(leaf, dtype=np.float32)
            if arr.size != int(np.prod(shape, dtype=np.int64)):
                raise ValueError(
                    f"shadow carry leaf c{i} has shape {arr.shape}, "
                    f"incompatible with the carry row {shape}"
                )
            leaves.append(arr.reshape(shape))
        if len(wire) != n:
            raise ValueError(f"shadow carry has {len(wire)} leaves, expected {n}")
        return tuple(leaves)
