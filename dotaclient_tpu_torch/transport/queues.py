"""The in-process transport and the AMQP one: the experience queue and the
weights fanout.

Counterpart of ``dotaclient_tpu/transport/queues.py``. Experience is a
work queue, each rollout consumed by exactly one learner; weights are a
fanout with replacement, a reader only ever wants the latest version.

``InProcTransport`` (the learner builds one when it is given no transport)
holds both in one process, bounded with drop-oldest so an actor never
blocks on a slow learner; protos pass by reference, never serialized.

``AmqpTransport`` puts them on a RabbitMQ broker with the reference's
topology and names: a durable queue ``experience`` and a fanout exchange
``weights`` that each transport binds its own exclusive queue to, so a
transport that binds after a publish waits for the next one. ``pika`` is
imported when one is built; without it the constructor raises
``RuntimeError`` naming it. ``publish_rollout_bytes`` takes the native
encoder's bytes. The learner's ``--transport amqp --amqp-host H[:P]`` and
the actor's ``--amqp H[:P]`` build one.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional, Protocol

from dotaclient_tpu_torch.protos import dota_pb2 as pb
from dotaclient_tpu_torch.utils import telemetry


class Transport(Protocol):
    """Both directions of the actor <-> learner channel."""

    def publish_rollout(self, rollout: "pb.Rollout") -> None: ...
    def consume_rollouts(self, max_count: int, timeout: Optional[float] = None) -> List["pb.Rollout"]: ...
    def publish_weights(self, weights: "pb.ModelWeights") -> None: ...
    def latest_weights(self) -> Optional["pb.ModelWeights"]: ...


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


class AmqpTransport:
    """RabbitMQ-backed transport with the reference's topology: a durable
    experience queue and a fanout weights exchange."""

    EXPERIENCE_QUEUE = "experience"
    WEIGHTS_EXCHANGE = "weights"

    def __init__(self, host: str, port: int = 5672, registry: Optional[telemetry.Registry] = None) -> None:
        try:
            import pika  # type: ignore[import-not-found]
        except ImportError as e:
            raise RuntimeError(
                "AmqpTransport requires pika (and a reachable RabbitMQ broker); use InProcTransport in "
                "broker-less environments"
            ) from e
        self._tel = registry if registry is not None else telemetry.get_registry()
        self._conn = pika.BlockingConnection(pika.ConnectionParameters(host=host, port=port))
        self._ch = self._conn.channel()
        self._ch.queue_declare(queue=self.EXPERIENCE_QUEUE, durable=True)
        self._ch.exchange_declare(exchange=self.WEIGHTS_EXCHANGE, exchange_type="fanout")
        self._weights_queue = self._ch.queue_declare(queue="", exclusive=True).method.queue
        self._ch.queue_bind(exchange=self.WEIGHTS_EXCHANGE, queue=self._weights_queue)

    def publish_rollout(self, rollout: "pb.Rollout") -> None:
        self.publish_rollout_bytes(rollout.SerializeToString())

    def publish_rollout_bytes(self, payload) -> None:
        """Ship serialized rollout bytes (the native encoder's memoryview
        included: pika takes only bytes)."""
        self._ch.basic_publish(exchange="", routing_key=self.EXPERIENCE_QUEUE, body=bytes(payload))
        self._tel.counter("transport/experience_published").inc()

    def consume_rollouts(self, max_count: int, timeout: Optional[float] = None) -> List["pb.Rollout"]:
        """Up to ``max_count`` rollouts, each acked as it is taken; the
        consumer is cancelled after, which requeues anything delivered and
        not acked. Timed only when something drained."""
        out: List[pb.Rollout] = []
        t0 = time.perf_counter()
        for method, _props, body in self._ch.consume(self.EXPERIENCE_QUEUE, inactivity_timeout=timeout):
            if body is None:
                break
            r = pb.Rollout()
            r.ParseFromString(body)
            out.append(r)
            self._ch.basic_ack(method.delivery_tag)
            if len(out) >= max_count:
                break
        self._ch.cancel()
        if out:
            self._tel.timer("span/transport/consume").observe(time.perf_counter() - t0)
            self._tel.counter("transport/experience_consumed").inc(len(out))
        return out

    def publish_weights(self, weights: "pb.ModelWeights") -> None:
        self._ch.basic_publish(exchange=self.WEIGHTS_EXCHANGE, routing_key="", body=weights.SerializeToString())
        self._tel.counter("transport/weights_published").inc()
        self._tel.gauge("transport/weights_version").set(weights.version)

    def latest_weights(self) -> Optional["pb.ModelWeights"]:
        """The newest weights frame in this transport's fanout queue, the
        older ones drained; None when nothing arrived since the last call."""
        latest: Optional[bytes] = None
        while True:
            _method, _props, body = self._ch.basic_get(self._weights_queue, auto_ack=True)
            if body is None:
                break
            latest = body
        if latest is None:
            return None
        msg = pb.ModelWeights()
        msg.ParseFromString(latest)
        return msg

    @property
    def pending_rollouts(self) -> int:
        """The broker's experience backlog: one passive declare, a round
        trip (read at log boundaries only)."""
        return int(self._ch.queue_declare(queue=self.EXPERIENCE_QUEUE, passive=True).method.message_count)

    def close(self) -> None:
        try:
            self._conn.close()
        except Exception:  # noqa: BLE001 - a broker already gone has nothing to close
            pass
