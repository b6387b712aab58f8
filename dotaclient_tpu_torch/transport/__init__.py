"""The wire: the protobuf codec, the framed TCP lane, the same-host
shared-memory lane and the in-process transport.

Exports the names of the JAX package's ``transport`` package that the port
has, resolved on first use: the session router imports the framing of
``socket_transport`` without loading torch, so this package imports
nothing up front. ``AmqpTransport`` waits for ROADMAP queue 1, item 13.
"""

import importlib

_EXPORTS = {
    "InProcTransport": "queues",
    "ShmTransport": "shm_transport",
    "ShmTransportServer": "shm_transport",
    "SocketTransport": "socket_transport",
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
