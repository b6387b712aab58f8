"""Tensor-parallel partition rules for the policy's parameters.

Counterpart of ``dotaclient_tpu/parallel/sharding.py``. The rule is pure:
given a parameter's shape in the Flax layout, its path and the model
axis's size, it names the dimension the parameter is cut along, or None
when every rank holds it whole. In precedence order:

1. expert-major tensors (a path containing ``"expert"``) along axis 0, when
   it divides;
2. the last axis when it divides (the column cut of a dense kernel
   ``[in, out]``, its bias, an embedding table ``[vocab, dim]``);
3. otherwise replicated.

``state_shardings`` applies it to every named tensor of the port's
``TrainState``: the parameters and Adam's two moments. A ``torch.nn.Linear``
weight is the transpose of the Flax kernel, so the rule reads its reversed
shape and the dimension is mapped back. With ``model_parallel == 1`` every
tensor is replicated; the learner runs only that (tensor parallelism in the
learner is ROADMAP queue 1, item 7b).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch


def param_spec(shape: Sequence[int], path: str = "", n_model: int = 1) -> Optional[int]:
    """The dimension of a parameter of ``shape`` (Flax layout) cut over a
    model axis of ``n_model`` ranks, or None (replicated)."""
    n = n_model
    if n <= 1:
        return None
    if "expert" in path and len(shape) >= 1 and shape[0] % n == 0:
        return 0
    if len(shape) >= 1 and shape[-1] % n == 0 and shape[-1] >= n:
        return len(shape) - 1
    return None


def _linear_weights(policy: torch.nn.Module) -> set:
    return {f"{name}.weight" for name, m in policy.named_modules() if isinstance(m, torch.nn.Linear)}


def state_shardings(state: Any, n_model: int = 1) -> Dict[str, Optional[int]]:
    """The cut dimension of every tensor of ``state`` (a ``TrainState``), keyed
    ``params/<name>``, ``opt_state/exp_avg/<name>`` and
    ``opt_state/exp_avg_sq/<name>``: a moment follows its parameter."""
    linear = _linear_weights(state.policy)
    out: Dict[str, Optional[int]] = {}
    for name, p in state.policy.named_parameters():
        shape = tuple(p.shape)
        if name in linear and len(shape) == 2:
            d = param_spec(shape[::-1], name, n_model)
            spec = None if d is None else len(shape) - 1 - d
        else:
            spec = param_spec(shape, name, n_model)
        out[f"params/{name}"] = spec
        out[f"opt_state/exp_avg/{name}"] = spec
        out[f"opt_state/exp_avg_sq/{name}"] = spec
    return out
