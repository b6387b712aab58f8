"""Policy-serving plane of the port: the continuous-batching engine, the
socket lane (``PolicyServer``, ``ServeClient``) and the inference-only
policy path with its two restore sources."""

from dotaclient_tpu_torch.serve.client import ServeClient, ServeDeadlineError, serve_request_wire_kwargs
from dotaclient_tpu_torch.serve.engine import ServeEngine
from dotaclient_tpu_torch.serve.policy_path import (
    TRAIN_ONLY_PARAM_KEYS,
    load_inference_params,
    make_inference_policy,
    slice_train_params,
    weights_frame_to_params,
)
from dotaclient_tpu_torch.serve.server import PolicyServer

__all__ = [
    "PolicyServer",
    "ServeClient",
    "ServeDeadlineError",
    "ServeEngine",
    "TRAIN_ONLY_PARAM_KEYS",
    "load_inference_params",
    "make_inference_policy",
    "serve_request_wire_kwargs",
    "slice_train_params",
    "weights_frame_to_params",
]
