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
tensor is replicated.

``ParamShards`` is the layout in the learner, on a mesh whose model axis
has m > 1 ranks: each rank keeps, of every tensor the rule cuts, only its
1/m slice of the master param (the optimizer steps it, with its two Adam
moments of the same shape); replicated tensors stay whole. After each
optimizer step the model group gathers the slices into the policy's
working params, whole on every rank, which the rollout and the next
forward and backward run on: ``lstm_seq`` keeps whole gate matrices in
shared memory, and a column-cut gate would need a gather inside the
recurrence at every time step. So the model ranks of one data shard
compute the same thing; what is sharded is the master params and the
optimizer state. The gradient a rank keeps of a cut tensor is its slice,
summed over the batch group; the global norm sums the slices' squares over
the model group and adds the replicated tensors' once.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from dotaclient_tpu_torch.parallel.collectives import Group, gather_cut, group_rank, group_size, psum


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


def param_dims(policy: torch.nn.Module, n_model: int) -> Dict[str, Optional[int]]:
    """The cut dimension (torch layout) of each of ``policy``'s named
    parameters over a model axis of ``n_model`` ranks, or None."""
    linear = _linear_weights(policy)
    out: Dict[str, Optional[int]] = {}
    for name, p in policy.named_parameters():
        shape = tuple(p.shape)
        if name in linear and len(shape) == 2:
            d = param_spec(shape[::-1], name, n_model)
            out[name] = None if d is None else len(shape) - 1 - d
        else:
            out[name] = param_spec(shape, name, n_model)
    return out


def state_shardings(state: Any, n_model: int = 1) -> Dict[str, Optional[int]]:
    """The cut dimension of every tensor of ``state`` (a ``TrainState``), keyed
    ``params/<name>``, ``opt_state/exp_avg/<name>`` and
    ``opt_state/exp_avg_sq/<name>``: a moment follows its parameter."""
    out: Dict[str, Optional[int]] = {}
    for name, spec in param_dims(state.policy, n_model).items():
        out[f"params/{name}"] = spec
        out[f"opt_state/exp_avg/{name}"] = spec
        out[f"opt_state/exp_avg_sq/{name}"] = spec
    return out


MOMENTS = ("exp_avg", "exp_avg_sq")


class ParamShards:
    """The tensor-parallel layout of ``policy``'s params over the model
    group ``group`` (see the module's text). ``masters`` lists, in
    ``named_parameters`` order, what the optimizer steps: this rank's slice
    (a leaf tensor of its own) of a cut parameter, the policy's own tensor
    of a replicated one."""

    def __init__(self, policy: torch.nn.Module, group: Group) -> None:
        self.policy = policy
        self.group = group
        self.n, self.me = group_size(group), group_rank(group)
        dims = param_dims(policy, self.n)
        self.named: List[Tuple[str, torch.nn.Parameter, Optional[int]]] = [
            (name, p, dims[name]) for name, p in policy.named_parameters()]
        self.masters: List[torch.Tensor] = [
            p if d is None else torch.nn.Parameter(self.cut(p.detach(), d).clone()) for _, p, d in self.named]

    def cut(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``t`` along ``dim`` (a view)."""
        per = t.shape[dim] // self.n
        return t.narrow(dim, self.me * per, per)

    @property
    def dims(self) -> List[Optional[int]]:
        return [d for _, _, d in self.named]

    def local_grads(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Whole gradients (``named_parameters`` order) -> the masters':
        the slice of a cut one, a replicated one as it is."""
        return [g if d is None else self.cut(g, d).contiguous() for g, d in zip(grads, self.dims)]

    def global_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """optax's global norm of the whole gradient from the masters'
        gradients: the cut slices' squares summed over the model group,
        the replicated tensors' counted once."""
        zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        cut = sum((torch.sum(g * g) for g, d in zip(grads, self.dims) if d is not None), zero)
        rep = sum((torch.sum(g * g) for g, d in zip(grads, self.dims) if d is None), zero)
        return torch.sqrt(psum(cut, self.group) + rep)

    def gather(self) -> None:
        """The masters' slices into the policy's whole working params, on
        every rank of the model group (one all-reduce)."""
        cut = [(p, m, d) for (_, p, d), m in zip(self.named, self.masters) if d is not None]
        with torch.no_grad():
            wholes = gather_cut([m.detach() for _, m, _ in cut], [d for _, _, d in cut], self.group)
            for (p, _, _), w in zip(cut, wholes):
                p.copy_(w)

    def recut(self) -> None:
        """The masters from the policy's whole params (after a load or a
        broadcast of them)."""
        with torch.no_grad():
            for (_, p, d), m in zip(self.named, self.masters):
                if d is not None:
                    m.copy_(self.cut(p.detach(), d))

    def whole_opt_state(self, sd: Dict[str, Any]) -> Dict[str, Any]:
        """An optimizer ``state_dict`` of the masters -> the whole layout's
        (each cut moment gathered over the model group: one all-reduce), the
        one a single card saves."""
        state = {i: dict(v) for i, v in sd["state"].items()}
        keys = [(i, k) for i, d in enumerate(self.dims) if d is not None and i in state for k in MOMENTS
                if k in state[i]]
        if keys:
            wholes = gather_cut([state[i][k] for i, k in keys], [self.dims[i] for i, _ in keys], self.group)
            for (i, k), w in zip(keys, wholes):
                state[i][k] = w
        return {**sd, "state": state}

    def cut_opt_state(self, sd: Dict[str, Any]) -> Dict[str, Any]:
        """A whole-layout optimizer ``state_dict`` -> this rank's (each cut
        moment cut)."""
        state = {}
        for i, v in sd["state"].items():
            d = self.dims[int(i)]
            state[i] = {k: (self.cut(torch.as_tensor(t), d).clone() if d is not None and k in MOMENTS else t)
                        for k, t in v.items()}
        return {**sd, "state": state}
