"""The in-process transport: the experience queue and the weights fanout in
one process.

Counterpart of ``InProcTransport`` in ``dotaclient_tpu/transport/queues.py``
(the learner builds one when it is given no transport). Experience is a
work queue, each rollout consumed by exactly one learner, bounded with
drop-oldest so an actor never blocks on a slow learner; weights are a
fanout with replacement, a reader only ever wants the latest version.
Protos pass by reference, never serialized to bytes. ``AmqpTransport``
comes with the learner's transports (ROADMAP queue 1, item 4b).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

from dotaclient_tpu_torch.protos import dota_pb2 as pb
from dotaclient_tpu_torch.utils import telemetry


class InProcTransport:
    """Thread-safe in-process transport."""

    def __init__(self, max_rollouts: int = 4096, registry: Optional[telemetry.Registry] = None) -> None:
        self._rollouts: "queue.Queue[pb.Rollout]" = queue.Queue(max_rollouts)
        self._publish_lock = threading.Lock()
        self._weights_lock = threading.Lock()
        self._weights: Optional[pb.ModelWeights] = None
        self.dropped = 0
        self._tel = registry if registry is not None else telemetry.get_registry()

    def publish_rollout(self, rollout: "pb.Rollout") -> None:
        # backpressure is drop-oldest; the lock makes evict-then-put atomic
        # across concurrent publishers
        with self._publish_lock:
            while True:
                try:
                    self._rollouts.put_nowait(rollout)
                    break
                except queue.Full:
                    try:
                        self._rollouts.get_nowait()
                        self.dropped += 1
                        self._tel.counter("transport/experience_dropped").inc()
                    except queue.Empty:
                        pass
        self._tel.counter("transport/experience_published").inc()
        self._tel.gauge("transport/queue_depth").set(self._rollouts.qsize())

    def consume_rollouts(self, max_count: int, timeout: Optional[float] = None) -> List["pb.Rollout"]:
        """Up to ``max_count`` rollouts, waiting at most ``timeout`` for the
        first; timed only when something drained (empty polls are idle
        waiting, not drain cost)."""
        out: List[pb.Rollout] = []
        t0 = time.perf_counter()
        try:
            out.append(self._rollouts.get(timeout=timeout))
        except queue.Empty:
            return out
        while len(out) < max_count:
            try:
                out.append(self._rollouts.get_nowait())
            except queue.Empty:
                break
        self._tel.timer("span/transport/consume").observe(time.perf_counter() - t0)
        self._tel.counter("transport/experience_consumed").inc(len(out))
        self._tel.gauge("transport/queue_depth").set(self._rollouts.qsize())
        return out

    def publish_weights(self, weights: "pb.ModelWeights") -> None:
        with self._weights_lock:
            self._weights = weights
        self._tel.counter("transport/weights_published").inc()
        self._tel.gauge("transport/weights_version").set(weights.version)

    def latest_weights(self) -> Optional["pb.ModelWeights"]:
        with self._weights_lock:
            return self._weights

    @property
    def pending_rollouts(self) -> int:
        return self._rollouts.qsize()
