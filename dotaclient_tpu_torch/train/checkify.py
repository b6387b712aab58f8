"""The learner's ``--checkify``: every op of an update checked for NaN.

Counterpart of the JAX package's ``checkify.checkify(...,
errors=checkify.float_checks)`` around its staged train step
(``dotaclient_tpu/train/ppo.py``), which raises on the first primitive that
produces a NaN ("nan generated by primitive: log") or divides by an operand
holding a zero. Here a ``TorchDispatchMode`` sees every aten op the update
runs: the forward, the backward (autograd's engine carries the mode into
its threads) and the optimizer's step. ``FloatChecks``:

* raises ``FloatCheckError("nan generated by primitive: aten.<op>")`` when
  an op's floating result (or, for an in-place op, the operand it wrote)
  holds a NaN; ops that only move or select values (views, copies,
  gathers, ``where``) are not checked, as checkify does not check
  ``select_n``, ``gather`` or ``concatenate``: a NaN they pass on is
  flagged where it was computed;
* raises ``FloatCheckError("division by zero ...")`` when a division's
  divisor holds a zero, whatever the dtype, as checkify's ``div`` check
  does.

An infinity alone raises nothing, in either package: it raises only where
it makes a NaN (``inf - inf``, ``0 * inf``) or meets a zero divisor.
``checked(fn)`` runs ``fn`` under the mode with
``torch.autograd.set_detect_anomaly(True)``, so an error raised in the
backward carries the forward's trace of the op that failed.

Each check reads a device value: the mode syncs the host on every op. It
is a debug mode ("slow; never for production runs"), never run under
``torch.cuda.set_sync_debug_mode("error")``. A hand-written kernel's
output is filled outside the dispatcher, so a NaN it makes is flagged at
the first op that reads it.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# ops that only move, view or select values: they compute none, so a NaN
# in their result was flagged where it was made (or came in with the data)
_PASS_THROUGH = frozenset({
    "_to_copy", "_unsafe_view", "alias", "as_strided", "cat", "clone", "copy", "copy_", "detach",
    "empty", "empty_like", "empty_strided", "expand", "fill", "fill_", "full", "full_like", "gather",
    "index", "index_select", "lift_fresh", "lift_fresh_copy", "new_empty", "new_empty_strided",
    "new_zeros", "new_ones", "new_full", "ones", "ones_like", "permute", "reshape", "select", "slice",
    "split", "split_with_sizes", "squeeze", "stack", "t", "transpose", "unbind", "unsqueeze", "view",
    "where", "zero_", "zeros", "zeros_like", "_foreach_copy_", "masked_fill", "masked_fill_",
    "index_put", "index_put_", "scalar_tensor", "arange", "_local_scalar_dense", "set_",
})
# the divisions: checkify's ``div`` (true and integer division alike)
_DIVISIONS = frozenset({"div", "div_", "floor_divide", "floor_divide_", "reciprocal", "reciprocal_",
                        "_foreach_div", "_foreach_div_", "_foreach_reciprocal", "_foreach_reciprocal_"})


class FloatCheckError(RuntimeError):
    """The first op of a checked update that produced a NaN or divided by
    zero; its message names the op."""


def _has_zero(divisor: Any) -> bool:
    for leaf in tree_leaves(divisor):
        if isinstance(leaf, torch.Tensor):
            if bool((leaf == 0).any()):
                return True
        elif isinstance(leaf, (int, float)) and not isinstance(leaf, bool) and leaf == 0:
            return True
    return False


def _written(func: Any, args: tuple, kwargs: dict, out: Any) -> Iterator[torch.Tensor]:
    """The tensors an op produced: the operands it wrote, for a mutating
    op (``add_``, ``_foreach_add_``, ``out=``), else its results."""
    schema = func._schema
    if schema.is_mutable:
        for i, a in enumerate(schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                value = args[i] if i < len(args) else kwargs.get(a.name)
                yield from (t for t in tree_leaves(value) if isinstance(t, torch.Tensor))
        return
    yield from (t for t in tree_leaves(out) if isinstance(t, torch.Tensor))


class FloatChecks(TorchDispatchMode):
    """Checks every aten op run under it (see the module's docstring)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in _DIVISIONS:
            divisor = args[0] if name.startswith(("reciprocal", "_foreach_reciprocal")) else (
                args[1] if len(args) > 1 else kwargs.get("other"))
            if _has_zero(divisor):
                raise FloatCheckError(f"division by zero in primitive: {func}")
        out = func(*args, **kwargs)
        if name not in _PASS_THROUGH:
            for t in _written(func, args, kwargs, out):
                if t.is_floating_point() and bool(torch.isnan(t).any()):
                    raise FloatCheckError(f"nan generated by primitive: {func}")
        return out


def checked(fn: Callable) -> Callable:
    """``fn`` run under ``FloatChecks`` with anomaly detection on (restored
    after)."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        prev = torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()
        torch.autograd.set_detect_anomaly(True)
        try:
            with FloatChecks():
                return fn(*args, **kwargs)
        finally:
            torch.autograd.set_detect_anomaly(*prev)

    return run
