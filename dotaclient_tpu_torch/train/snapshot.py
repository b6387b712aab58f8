"""The snapshot engine: the learner's boundary side effects off the train thread.

Counterpart of ``dotaclient_tpu/train/snapshot.py``. At a publish,
checkpoint or log boundary the train thread only queues an on-device copy
of what the job needs (:func:`device_copy`: clones of the params or of the
whole train state, or the metric tensors themselves, which nothing writes
into, and a CUDA event recorded after them on the stream that runs the
updates) and goes on issuing work. The engine's one thread then does the
device-to-host copy, the weights encode and publish, the checkpoint write
and the metrics continuation.

Ordering on the card. Adam updates the params in place, so a snapshot is a
clone queued on the train thread before the next update, and the engine's
copy to the host waits on that clone's event from a stream of its own:
it never waits on (or reads past) the updates queued after it.

Semantics, as the reference's:

* one latest-wins slot per job kind (publish, checkpoint, metrics): unsent
  work coalesces to the newest submission (``snapshot/<kind>_coalesced``);
  published versions stay monotonic;
* stats jobs (actor stat drains and health verdicts) are a backlog that is
  never coalesced and is processed before the same cycle's slot jobs, so a
  version-V publish runs after every verdict for steps <= V has folded;
* the health gates: a latched-unhealthy monitor refuses publishes
  (``health/publish_blocked_total``) and periodic checkpoints
  (``health/checkpoints_blocked_total``); a checkpoint that passes the gate
  is mirrored into the ``last_good`` slot;
* periodic checkpoints go through the manager's writer thread
  (``CheckpointManager.save_host`` returns before the write lands), and
  ``drain()`` and ``stop()`` return only after every pending job and the
  checkpoint writes they queued have landed; a failing job is counted in
  ``snapshot/errors_total`` and the engine goes on (a failed write
  surfaces at the manager's next save or ``wait``).

With a tracer configured when the engine is built (``utils/tracing.py``),
a publish stamps its weights frame with a ``weights_record`` blob after
the copy to the host, and emits a ``publish`` event.

Telemetry: ``snapshot/pending``, ``snapshot/d2h_ms`` (the last batched
device-to-host copy), ``snapshot/errors_total``,
``span/transport/publish_weights`` and ``span/learner/metrics_fetch``.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from dotaclient_tpu_torch.utils import telemetry, tracing

logger = logging.getLogger(__name__)

_KINDS = ("publish", "checkpoint", "metrics")


def map_tensors(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` over the tensor leaves of nested dicts, lists and tuples;
    other leaves pass unchanged."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return tree


@dataclasses.dataclass
class DeviceCopy:
    """A tree queued for the engine, and the event after which its device
    tensors are complete (None when none is on a CUDA card)."""

    tree: Any
    event: Optional[Any] = None
    device: Optional[torch.device] = None


def device_copy(tree: Any, clone: bool = True) -> DeviceCopy:
    """On the train thread: a tree for the engine. With ``clone`` every
    tensor is cloned on the current stream (the live tensors change in
    place at the next update); without it the tree's tensors must be fresh
    outputs that nothing writes into. Records a CUDA event after them."""
    out = map_tensors(lambda t: t.detach().clone(), tree) if clone else tree
    cuda = [None]

    def note(t: torch.Tensor) -> torch.Tensor:
        if t.is_cuda:
            cuda[0] = t.device
        return t

    map_tensors(note, out)
    if cuda[0] is None:
        return DeviceCopy(out)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(cuda[0]))
    return DeviceCopy(out, event, cuda[0])


class SnapshotEngine:
    """One background thread, three latest-wins job slots and a stats
    backlog."""

    def __init__(self, transport: Any = None, wire_dtype: str = "float32", ckpt: Any = None,
                 registry: Optional[telemetry.Registry] = None, health: Any = None) -> None:
        self._transport = transport
        self._wire_dtype = wire_dtype
        self._ckpt = ckpt
        self._health = health
        self._tel = registry if registry is not None else telemetry.get_registry()
        self._cond = threading.Condition()
        self._jobs: Dict[str, Optional[Tuple]] = {k: None for k in _KINDS}
        self._stats_jobs: list = []
        self._busy = False
        self._stopped = False
        self._last_published = -1
        self._tracer = tracing.get()   # captured once: tracing off costs one pointer test a publish
        self._streams: Dict[Any, Any] = {}   # the engine thread's copy stream per card
        self._tel.gauge("snapshot/pending")
        self._tel.gauge("snapshot/d2h_ms")
        self._tel.counter("snapshot/errors_total")
        for k in _KINDS:
            self._tel.counter(f"snapshot/{k}_coalesced")
        self._thread = threading.Thread(target=self._run, name="snapshot", daemon=True)
        self._thread.start()

    # -- submission (train thread) -----------------------------------------

    def _submit(self, kind: str, job: Tuple) -> None:
        with self._cond:
            if self._stopped:
                raise RuntimeError("snapshot engine is stopped")
            if self._jobs[kind] is not None:
                self._tel.counter(f"snapshot/{kind}_coalesced").inc()
            self._jobs[kind] = job
            # host-sync-ok: a host int
            self._tel.gauge("snapshot/pending").set(float(self._pending_locked()))
            self._cond.notify_all()

    def _pending_locked(self) -> int:
        return sum(j is not None for j in self._jobs.values()) + len(self._stats_jobs) + (1 if self._busy else 0)

    def submit_publish(self, params: DeviceCopy, version: int) -> None:
        """``params``: a :func:`device_copy` of the policy's state dict; the
        frame carries it in the Flax layout (``models.convert.to_flax``)."""
        self._submit("publish", (params, version))

    def submit_checkpoint(self, state: DeviceCopy, config: Any) -> None:
        """``state``: a :func:`device_copy` of ``{"step", "version",
        "params", "opt_state"}``, the layout ``CheckpointManager.save_host``
        writes."""
        self._submit("checkpoint", (state, config))

    def submit_metrics(self, device_tree: DeviceCopy, finish: Callable[[Any], None]) -> None:
        """Copy ``device_tree`` to the host and hand it to ``finish`` on the
        engine's thread. Latest-wins: only the newest log boundary survives
        a backlog."""
        self._submit("metrics", (device_tree, finish))

    def submit_stats(self, device_stats: DeviceCopy, finish: Callable[[Any], Any]) -> None:
        """Queue one stat drain or verdict batch: ``finish(host)`` folds it.
        Never coalesced, and processed before the same cycle's slot jobs."""
        with self._cond:
            if self._stopped:
                raise RuntimeError("snapshot engine is stopped")
            self._stats_jobs.append((device_stats, finish))
            # host-sync-ok: a host int
            self._tel.gauge("snapshot/pending").set(float(self._pending_locked()))
            self._cond.notify_all()

    # -- lifecycle ----------------------------------------------------------

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every pending job is processed and the checkpoint
        writes they queued have landed (False on timeout)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._pending_locked():
                wait = 1.0
                if deadline is not None:
                    wait = deadline - time.monotonic()
                    if wait <= 0:
                        return False
                self._cond.wait(min(wait, 1.0))
        return self._join_writes(deadline)

    def stop(self, timeout: float = 30.0) -> None:
        """Process whatever is pending, then stop the thread; returns once
        the checkpoint writes it queued have landed (within ``timeout``)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout)
        self._join_writes(deadline)

    def _join_writes(self, deadline: Optional[float]) -> bool:
        if self._ckpt is None:
            return True
        return self._ckpt.join_writes(None if deadline is None else max(0.0, deadline - time.monotonic()))

    @property
    def last_published(self) -> int:
        """Highest version handed to the transport (read by the rollback
        after ``drain``, when the engine is idle)."""
        # lint-ok: thread-ownership(rollback reads this only after drain()
        # returned: the engine thread is provably idle at that point)
        return self._last_published

    # -- the engine's thread ------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._stopped and all(j is None for j in self._jobs.values()) and not self._stats_jobs:
                    self._cond.wait()
                batch = {k: j for k, j in self._jobs.items() if j is not None}
                stats_batch, self._stats_jobs = self._stats_jobs, []
                if not batch and not stats_batch:
                    return  # stopped with nothing left
                for k in batch:
                    self._jobs[k] = None
                self._busy = True
                # host-sync-ok: a host int
                self._tel.gauge("snapshot/pending").set(float(self._pending_locked()))
            try:
                # stat folds first (the log line and the health gates read
                # them), then the publish, then the slower checkpoint write
                for dev, finish in stats_batch:
                    try:
                        finish(self._fetch(dev))
                    except Exception as e:  # noqa: BLE001 - the engine outlives any job
                        self._tel.counter("snapshot/errors_total").inc()
                        logger.warning("snapshot stats fold failed (%s: %s)", type(e).__name__, e)
                for kind in _KINDS:
                    job = batch.get(kind)
                    if job is None:
                        continue
                    try:
                        getattr(self, f"_do_{kind}")(*job)
                    except Exception as e:  # noqa: BLE001 - the engine outlives any job
                        self._tel.counter("snapshot/errors_total").inc()
                        logger.warning("snapshot %s job failed (%s: %s); the engine continues", kind,
                                       type(e).__name__, e)
            finally:
                with self._cond:
                    self._busy = False
                    # host-sync-ok: a host int
                    self._tel.gauge("snapshot/pending").set(float(self._pending_locked()))
                    self._cond.notify_all()

    def _fetch(self, copy: DeviceCopy) -> Any:
        """The one device-to-host copy of a job, on a stream of this thread
        that first waits for the copy's event (not for what the train
        thread queued after it)."""
        t0 = time.perf_counter()
        if copy.event is None:
            # host-sync-ok: the engine's one batched fetch, on its own thread
            host = map_tensors(lambda t: t.cpu(), copy.tree)
        else:
            stream = self._streams.get(copy.device)
            if stream is None:
                stream = self._streams[copy.device] = torch.cuda.Stream(copy.device)
            with torch.cuda.stream(stream):
                stream.wait_event(copy.event)
                # host-sync-ok: the engine's one batched fetch, on its own thread
                host = map_tensors(lambda t: t.cpu(), copy.tree)
        self._tel.gauge("snapshot/d2h_ms").set((time.perf_counter() - t0) * 1e3)
        return host

    def _do_publish(self, params: DeviceCopy, version: int) -> None:
        if self._health is not None and self._health.unhealthy is not None:
            # contain: a flagged step's params never reach the transport
            self._tel.counter("health/publish_blocked_total").inc()
            logger.warning("snapshot: publish of version %d blocked: training health latched unhealthy "
                           "(%s at step %d)", version, self._health.unhealthy.reason, self._health.unhealthy.step)
            return
        if version <= self._last_published:
            return  # a stale re-submit: published versions stay monotonic
        from dotaclient_tpu_torch.models.convert import to_flax
        from dotaclient_tpu_torch.transport.serialize import encode_weights

        host = to_flax(self._fetch(params))
        trace_blob = None
        if self._tracer is not None:
            # stamped after the copy: the hop dates the version's fanout,
            # which an actor's apply lag is measured against
            trace_blob = tracing.record_to_blob(tracing.weights_record(version), pad=False)
            self._tracer.emit("publish", version=version)
        msg = encode_weights(host, version, wire_dtype=self._wire_dtype, trace=trace_blob)
        with self._tel.span("transport/publish_weights"):
            self._transport.publish_weights(msg)
        self._last_published = version

    def _do_checkpoint(self, state: DeviceCopy, config: Any) -> None:
        healthy = True
        if self._health is not None:
            if self._health.unhealthy is not None:
                # contain: a poisoned state never enters the retention
                self._tel.counter("health/checkpoints_blocked_total").inc()
                logger.warning("snapshot: periodic checkpoint blocked: training health latched unhealthy")
                return
            healthy = self._health.cfg.enabled
        # every verdict <= this state's step folded before this job ran
        # (the stats backlog goes first), so a save that gets here is
        # health-verified: it is mirrored into the last_good slot
        self._ckpt.save_host(self._fetch(state), config, force=False, mark_good=healthy)

    def _do_metrics(self, device_tree: DeviceCopy, finish: Callable[[Any], None]) -> None:
        with self._tel.span("learner/metrics_fetch"):
            host = self._fetch(device_tree)
        finish(host)
