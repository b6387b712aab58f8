"""The port's ``AmqpTransport`` against the JAX package's, on an in-memory fake pika.

Neither this machine nor the card's has ``pika`` or a broker, so both
packages' transports run against the fake broker of ``tests/test_amqp.py``
(queues, fanout exchanges, bindings; a consumer cancel requeues what was
delivered and not acked), extended here with the two calls the port's
learner makes beyond the reference's tests: a passive declare (the backlog
gauge) and a connection close. Each case of ``tests/test_amqp.py`` runs on
the port's transport and across the packages on one broker (a JAX actor
into a port learner and back), with the same outcome.
"""

from __future__ import annotations

import sys
import types

import numpy as np
import pytest

from dotaclient_tpu.transport import queues as jqueues
from dotaclient_tpu.transport import serialize as J
from dotaclient_tpu_torch.transport import queues as pqueues
from dotaclient_tpu_torch.transport import serialize as S
from dotaclient_tpu_torch.utils import telemetry
from tests.test_amqp import _DeclareOk, _FakeBroker, _FakeChannel, _rollout, _weights


class _Backlog:
    def __init__(self, queue: str, count: int) -> None:
        self.queue, self.message_count = queue, count


class _Channel(_FakeChannel):
    """The reference test's fake channel with a passive declare."""

    def queue_declare(self, queue: str = "", durable: bool = False, exclusive: bool = False,
                      passive: bool = False):
        if passive:
            ok = _DeclareOk(queue)
            ok.method = _Backlog(queue, len(self._b.queues[queue]))
            return ok
        return super().queue_declare(queue=queue, durable=durable, exclusive=exclusive)


class _Connection:
    def __init__(self, params) -> None:
        self._broker = params._broker
        self.closed = False

    def channel(self) -> _Channel:
        return _Channel(self._broker)

    def close(self) -> None:
        self.closed = True


def install_fake_pika(monkeypatch) -> _FakeBroker:
    """A fresh fake broker behind ``import pika``, for both packages."""
    broker = _FakeBroker()
    mod = types.ModuleType("pika")

    class ConnectionParameters:
        def __init__(self, host: str, port: int = 5672) -> None:
            self.host, self.port = host, port
            self._broker = broker

    mod.ConnectionParameters = ConnectionParameters
    mod.BlockingConnection = _Connection
    monkeypatch.setitem(sys.modules, "pika", mod)
    return broker


PACKAGES = {"port": pqueues.AmqpTransport, "jax": jqueues.AmqpTransport}
# (actor side, learner side): the port alone, and across the packages
PAIRS = [("port", "port"), ("jax", "port"), ("port", "jax")]


def transport(pkg: str):
    if pkg == "port":
        return pqueues.AmqpTransport("broker", registry=telemetry.Registry())
    return jqueues.AmqpTransport("broker")


def test_requires_pika(monkeypatch):
    monkeypatch.setitem(sys.modules, "pika", None)
    for cls in PACKAGES.values():
        with pytest.raises(RuntimeError, match="requires pika"):
            cls("localhost")


@pytest.mark.parametrize("actor,learner", PAIRS)
def test_rollout_work_queue_exactly_once(actor, learner, monkeypatch):
    install_fake_pika(monkeypatch)
    actor_a, actor_b, consumer = transport(actor), transport(actor), transport(learner)
    for i in range(3):
        actor_a.publish_rollout(_rollout(i))
    for i in range(3, 5):
        actor_b.publish_rollout(_rollout(i))
    got = consumer.consume_rollouts(max_count=10, timeout=0.01)
    assert sorted(r.env_id for r in got) == [0, 1, 2, 3, 4]
    assert consumer.consume_rollouts(max_count=10, timeout=0.01) == []


@pytest.mark.parametrize("actor,learner", PAIRS)
def test_consume_respects_max_count_and_requeues_rest(actor, learner, monkeypatch):
    install_fake_pika(monkeypatch)
    producer, consumer = transport(actor), transport(learner)
    for i in range(6):
        producer.publish_rollout(_rollout(i))
    assert [r.env_id for r in consumer.consume_rollouts(max_count=4, timeout=0.01)] == [0, 1, 2, 3]
    assert consumer.pending_rollouts == 2
    assert [r.env_id for r in consumer.consume_rollouts(max_count=10, timeout=0.01)] == [4, 5]


@pytest.mark.parametrize("actor,learner", PAIRS)
def test_weights_fanout_reaches_every_actor(actor, learner, monkeypatch):
    install_fake_pika(monkeypatch)
    actor_a, actor_b, publisher = transport(actor), transport(actor), transport(learner)
    publisher.publish_weights(_weights(7))
    for a in (actor_a, actor_b):
        got = a.latest_weights()
        assert got is not None and got.version == 7


@pytest.mark.parametrize("actor,learner", PAIRS)
def test_latest_weights_drains_to_newest(actor, learner, monkeypatch):
    install_fake_pika(monkeypatch)
    reader, publisher = transport(actor), transport(learner)
    for v in (1, 2, 3):
        publisher.publish_weights(_weights(v))
    assert reader.latest_weights().version == 3
    assert reader.latest_weights() is None
    publisher.publish_weights(_weights(4))
    assert reader.latest_weights().version == 4


@pytest.mark.parametrize("actor,learner", PAIRS)
def test_late_binder_misses_prior_weights(actor, learner, monkeypatch):
    install_fake_pika(monkeypatch)
    publisher = transport(learner)
    publisher.publish_weights(_weights(1))
    late = transport(actor)
    assert late.latest_weights() is None
    publisher.publish_weights(_weights(2))
    assert late.latest_weights().version == 2


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("actor,learner", PAIRS)
def test_wire_roundtrip_preserves_tensor_payload(actor, learner, wire, monkeypatch):
    """The actor's native encoder's bytes cross the broker (pika takes only
    bytes) and decode on the learner's side, in either package, to the
    arrays the protobuf codec gives, once."""
    install_fake_pika(monkeypatch)
    rng = np.random.default_rng(3)
    arrays = {"obs": {"units": rng.normal(size=(2, 3, 4)).astype(np.float32)},
              "actions": {"move_x": np.array([1, 4], np.int32)},
              "rewards": np.array([0.5, -1.0], np.float32)}
    kw = dict(wire_dtype=wire, int_bounds={"actions/move_x": 8})
    codec = S if actor == "port" else J
    payload = codec.encode_rollout_bytes(arrays, 3, 9, 1, 2, -0.5, **kw)
    assert not isinstance(payload, bytes)   # the native codec's memoryview
    producer, consumer = transport(actor), transport(learner)
    producer.publish_rollout_bytes(payload)
    (got,) = consumer.consume_rollouts(max_count=1, timeout=0.01)
    assert got.SerializeToString(deterministic=True) == S.pb.Rollout.FromString(bytes(payload)).SerializeToString(
        deterministic=True)
    pm, pa = S.decode_rollout(got, upcast=True)
    jm, ja = J.decode_rollout(got, upcast=True)
    assert pm == jm and pm["model_version"] == 3 and pm["env_id"] == 9
    for name, want in J.flatten_tree(ja).items():
        np.testing.assert_array_equal(S.flatten_tree(pa)[name], want)
    if wire == "float32":
        np.testing.assert_array_equal(pa["obs"]["units"], arrays["obs"]["units"])
    assert consumer.consume_rollouts(max_count=1, timeout=0.01) == []


def test_port_transport_counts_and_closes(monkeypatch):
    """The port's registry counts what the reference's counts, and close
    closes the broker connection (the learner CLI's exit path)."""
    install_fake_pika(monkeypatch)
    reg = telemetry.Registry()
    t = pqueues.AmqpTransport("broker", registry=reg)
    t.publish_rollout(_rollout(0))
    t.publish_weights(_weights(5))
    assert len(t.consume_rollouts(max_count=4, timeout=0.01)) == 1
    snap = reg.snapshot()
    assert snap["transport/experience_published"] == 1.0 and snap["transport/experience_consumed"] == 1.0
    assert snap["transport/weights_published"] == 1.0 and snap["transport/weights_version"] == 5.0
    assert t.pending_rollouts == 0
    t.close()
    assert t._conn.closed
