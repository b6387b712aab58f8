"""Inference-only policy path: the slim model and param tree serving runs.

The serving plane runs ``Policy`` with ``value_head=False``: the same trunk,
core and action heads as the training policy, so logits are identical, over
a param tree that is the training tree minus the training-only entries.
``slice_train_params`` takes either a Flax tree or the port's state dict.

Two sources restore into the sliced tree (port state dicts of f32 CPU
tensors), and agree bit for bit on the same params:

* a checkpoint the port's learner wrote (``load_inference_params``): the
  weights-only restore, manifest-verified with walk-back
  (``utils/checkpoint.py``), then the slice;
* a published ``ModelWeights`` frame (``weights_frame_to_params``): frames
  carry the Flax layout JAX learners publish, so the frame is decoded (bf16
  wire leaves upcast exactly), converted (``models/convert.py``) and sliced.
  The port's learner publishes that layout too (``models.convert.to_flax``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from dotaclient_tpu_torch.config import RunConfig
from dotaclient_tpu_torch.device import DeviceLike
from dotaclient_tpu_torch.models.convert import convert
from dotaclient_tpu_torch.models.policy import Policy
from dotaclient_tpu_torch.transport.serialize import decode_weights
from dotaclient_tpu_torch.utils.checkpoint import CheckpointManager

# Top-level param entries that exist only for training (name-based, so a
# future training-only head lands here once).
TRAIN_ONLY_PARAM_KEYS = ("head_value",)


def make_inference_policy(config: RunConfig, device: DeviceLike = None) -> Policy:
    """The serving-plane policy: identical architecture, no value head."""
    if config.model.moe_experts > 0 and config.model.core != "transformer":
        raise ValueError(
            f"moe_experts={config.model.moe_experts} requires "
            f"core='transformer' (got core={config.model.core!r})"
        )
    return Policy(
        config.model, config.obs, config.actions, value_head=False, device=device
    )


def _is_train_only(key: str) -> bool:
    return key.split(".", 1)[0] in TRAIN_ONLY_PARAM_KEYS


def slice_train_params(params: Any) -> Dict[str, Any]:
    """Training params -> inference-only params (drop the value head).

    Takes a Flax tree (``{"params": {...}}`` or the bare level) or a port
    state dict (``"head_value.weight"`` style keys) and returns the same
    nesting it was given."""
    if not isinstance(params, dict):
        raise TypeError(f"expected a param dict, got {type(params).__name__}")
    if "params" in params:
        out = dict(params)
        out["params"] = slice_train_params(params["params"])
        return out
    return {k: v for k, v in params.items() if not _is_train_only(k)}


def load_inference_params(checkpoint_dir: str) -> Tuple[RunConfig, Dict[str, torch.Tensor], int]:
    """A port checkpoint -> ``(config, sliced params, step)``. The
    checkpoint's own config governs the model; the step is the serving
    plane's starting weights version."""
    mgr = CheckpointManager(checkpoint_dir)
    config = mgr.restore_config()
    params, step = mgr.restore_weights()
    return config, slice_train_params(params), int(step)


def weights_frame_to_params(msg: Any) -> Tuple[int, Dict[str, torch.Tensor]]:
    """A published ``ModelWeights`` frame (Flax layout) -> ``(version,
    sliced port params)``."""
    version, tree = decode_weights(msg)
    return version, slice_train_params(convert(tree))
