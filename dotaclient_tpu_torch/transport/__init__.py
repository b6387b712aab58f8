"""The wire: the rollout codec (native and protobuf), the framed TCP lane,
the same-host shared-memory lane, the in-process transport and the AMQP
one.

Exports the names of the JAX package's ``transport`` package, resolved on
first use: the session router imports the framing of ``socket_transport``
without loading torch, so this package imports nothing up front.
"""

import importlib

_EXPORTS = {
    "AmqpTransport": "queues",
    "InProcTransport": "queues",
    "ShmTransport": "shm_transport",
    "ShmTransportServer": "shm_transport",
    "SocketTransport": "socket_transport",
    "Transport": "queues",
    "TransportServer": "socket_transport",
    **{name: "serialize" for name in (
        "decode_rollout", "decode_rollout_bytes", "decode_weights", "encode_rollout", "encode_rollout_bytes",
        "encode_weights", "flatten_tree", "proto_to_tensor", "tensor_to_proto", "unflatten_tree")},
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
