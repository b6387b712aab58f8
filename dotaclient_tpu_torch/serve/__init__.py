"""Policy-serving plane of the port: the continuous-batching engine, the
socket lane (``PolicyServer``, ``ServeClient``), the session router of a
serve fleet (``SessionRouter``, ``route_call``) and the inference-only
policy path with its two restore sources.

The names load their modules on first use, so that the router
(``python -m dotaclient_tpu_torch.serve.router``), which is host code
only, starts without importing torch.
"""

import importlib

_EXPORTS = {
    "PolicyServer": "server",
    "ServeClient": "client",
    "ServeDeadlineError": "client",
    "ServeEngine": "engine",
    "SessionRouter": "router",
    "TRAIN_ONLY_PARAM_KEYS": "policy_path",
    "load_inference_params": "policy_path",
    "make_inference_policy": "policy_path",
    "route_call": "router",
    "serve_request_wire_kwargs": "client",
    "slice_train_params": "policy_path",
    "weights_frame_to_params": "policy_path",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


def __dir__():
    return sorted(list(globals()) + __all__)
