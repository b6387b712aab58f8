"""Checkpoints of the learner state, with integrity manifests and walk-back.

Counterpart of ``dotaclient_tpu/utils/checkpoint.py`` in the port's own
format (the port cannot read orbax). A checkpoint directory holds::

    <dir>/<step>/state.pt        torch.save of {"step", "version",
                                 "params": state dict of CPU tensors,
                                 "opt_state": optimizer.state_dict()}
    <dir>/<step>/config.json     RunConfig.to_json()
    <dir>/manifests/<step>.json  per-leaf shape, dtype and frame_crc32,
                                 and the frame_crc32 of each file

A step is written into a temporary directory and moved into place with
``os.replace``, so a reader never sees half of one. ``state.pt`` is read
back with ``torch.load(..., weights_only=True)``: tensors, numbers and plain
containers only, as Adam's state dict is.

Every restore verifies the step's manifest. A step that fails (unreadable,
or a leaf or file whose digest differs) is counted
(``checkpoint/manifest_failures_total``), warned about and skipped for the
previous step. ``max_to_keep`` keeps the newest saves. A periodic save that
hits an I/O error is counted (``checkpoint/save_failures_total``) and
returns False; a forced save raises.

``shape_mismatches`` compares a restored state dict with the one a run
expects (the learner's ``init_from`` check). Not ported yet (ROADMAP queue
1, item 3): async saves on a thread, the ``last_good`` slot,
``restore_pipeline`` and ``discard_steps_above``.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import shutil
import tempfile
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from dotaclient_tpu_torch.config import RunConfig
from dotaclient_tpu_torch.device import DeviceLike
from dotaclient_tpu_torch.transport.serialize import frame_crc32
from dotaclient_tpu_torch.utils import telemetry

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"
CONFIG_FILE = "config.json"


class CheckpointIntegrityError(RuntimeError):
    """A restored checkpoint failed its integrity-manifest verification."""


def _tensor_bytes(t: torch.Tensor) -> bytes:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """Slash-joined leaf paths of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree, key=str) for kv in _leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _leaves(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


def build_manifest(host_state: Any) -> dict:
    """Per-leaf record of a state tree: tensors by shape, dtype and
    ``frame_crc32`` of their bytes, other leaves by value."""
    leaves = {}
    for key, leaf in _leaves(host_state):
        if isinstance(leaf, torch.Tensor):
            leaves[key] = {
                "shape": list(leaf.shape),
                "dtype": str(leaf.dtype).replace("torch.", ""),
                "crc": frame_crc32(_tensor_bytes(leaf)),
            }
        else:
            leaves[key] = {"value": leaf}
    return {"version": 1, "leaves": leaves}


def verify_manifest(manifest: dict, host_state: Any) -> None:
    """Raise :class:`CheckpointIntegrityError` on the first leaf whose
    record differs from the manifest, or on a leaf-set mismatch."""
    got = build_manifest(host_state)["leaves"]
    want = manifest.get("leaves", {})
    if set(got) != set(want):
        missing = sorted(set(want) - set(got))[:3]
        extra = sorted(set(got) - set(want))[:3]
        raise CheckpointIntegrityError(
            f"leaf set differs from manifest (missing {missing}, unexpected {extra})"
        )
    for key, spec in want.items():
        g = got[key]
        for field in spec:
            if g.get(field) != spec[field]:
                raise CheckpointIntegrityError(
                    f"leaf {key!r} {field} mismatch: restored {g.get(field)!r} != saved {spec[field]!r}"
                )


def shape_mismatches(got: Dict[str, Any], want: Dict[str, Any]) -> List[str]:
    """Key-by-key shape comparison of two state dicts: one
    ``"<key>: (got) != (want)"`` string per mismatched tensor, in key order,
    or a single ``"tree structure differs: ..."`` when the key sets differ."""
    if set(got) != set(want):
        missing = sorted(set(want) - set(got))[:3]
        extra = sorted(set(got) - set(want))[:3]
        return [f"tree structure differs: missing {missing}, unexpected {extra}"]
    out = []
    for key in sorted(want):
        g, w = tuple(got[key].shape), tuple(want[key].shape)
        if g != w:
            out.append(f"{key}: {g} != {w}")
    return out


def _file_crc(path: str) -> int:
    with open(path, "rb") as f:
        return frame_crc32(f.read())


class CheckpointManager:
    """Sync saves and verified, walk-back restores under one directory."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 registry: Optional[telemetry.Registry] = None) -> None:
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max(1, max_to_keep)
        self._tel = registry if registry is not None else telemetry.get_registry()
        # the step a walk-back restore landed on
        self.last_restored_step: Optional[int] = None
        self._tel.counter("checkpoint/save_failures_total")
        self._tel.counter("checkpoint/manifest_failures_total")

    # -- layout ---------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.directory, "manifests", f"{step}.json")

    def all_steps(self) -> List[int]:
        return sorted(
            int(n) for n in os.listdir(self.directory)
            if n.isdigit() and os.path.isfile(os.path.join(self.directory, n, STATE_FILE))
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save -------------------------------------------------------------------

    def save(self, state: Any, config: RunConfig, force: bool = False) -> bool:
        """Write ``state`` (a ``TrainState``: its step, version, policy
        params and optimizer state) and ``config`` at ``state.step``. Copies
        every tensor to the host, so it reads the device: the learner calls
        it only between iterations. A step that exists is replaced."""
        host_state = {
            "step": int(state.step),
            "version": int(state.version),
            "params": {k: v.detach().cpu().clone() for k, v in state.policy.state_dict().items()},
            "opt_state": _to_cpu(state.optimizer.state_dict()),
        }
        return self.save_host(host_state, config, force=force)

    def save_host(self, host_state: Dict[str, Any], config: RunConfig, force: bool = False) -> bool:
        """Write an already-fetched host state dict (``step``, ``version``,
        ``params``, ``opt_state``)."""
        step = int(host_state["step"])
        tmp = None
        try:
            tmp = tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=self.directory)
            state_path = os.path.join(tmp, STATE_FILE)
            torch.save(host_state, state_path)
            with open(os.path.join(tmp, CONFIG_FILE), "w") as f:
                f.write(config.to_json())
            manifest = {
                "step": step,
                **build_manifest(host_state),
                "files": {n: _file_crc(os.path.join(tmp, n)) for n in (STATE_FILE, CONFIG_FILE)},
            }
            os.makedirs(os.path.join(self.directory, "manifests"), exist_ok=True)
            with open(self._manifest_path(step) + ".tmp", "w") as f:
                json.dump(manifest, f)
            final = self._step_dir(step)
            if os.path.exists(final):
                # the newest content supersedes a save of the same step
                shutil.rmtree(final)
            os.replace(tmp, final)
            tmp = None
            os.replace(self._manifest_path(step) + ".tmp", self._manifest_path(step))
        except (OSError, RuntimeError, pickle.PicklingError) as e:
            if force:
                raise
            self._tel.counter("checkpoint/save_failures_total").inc()
            logger.warning("periodic checkpoint save at step %d failed (%s: %s); training continues",
                           step, type(e).__name__, e)
            return False
        finally:
            if tmp is not None:
                shutil.rmtree(tmp, ignore_errors=True)
        self._retain()
        return True

    def _retain(self) -> None:
        """Delete all but the newest ``max_to_keep`` steps and their
        manifests."""
        for step in self.all_steps()[: -self.max_to_keep]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
            try:
                os.unlink(self._manifest_path(step))
            except OSError:
                pass

    # -- restore ----------------------------------------------------------------

    def _load_step(self, step: int) -> Dict[str, Any]:
        """Read and verify one step's state (a step without a manifest
        restores unverified)."""
        path = os.path.join(self._step_dir(step), STATE_FILE)
        try:
            with open(self._manifest_path(step)) as f:
                manifest = json.load(f)
        except FileNotFoundError:
            manifest = None
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointIntegrityError(f"manifest for step {step} unreadable: {e}") from e
        if manifest is not None:
            for name, crc in manifest.get("files", {}).items():
                got = _file_crc(os.path.join(self._step_dir(step), name))
                if got != crc:
                    raise CheckpointIntegrityError(f"{name} of step {step}: crc {got} != saved {crc}")
        raw = torch.load(path, map_location="cpu", weights_only=True)
        if manifest is not None:
            verify_manifest(manifest, raw)
        return raw

    def _restore_stepwise(self, attempt: Callable[[int], Any]) -> Any:
        """Try ``attempt(step)`` newest step first; a failing step is
        counted, warned about and skipped. Re-raises the last error when
        every step fails."""
        steps = sorted(self.all_steps(), reverse=True)
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        last_err: Optional[BaseException] = None
        for i, step in enumerate(steps):
            try:
                out = attempt(step)
            except (CheckpointIntegrityError, KeyError, FileNotFoundError, OSError, ValueError,
                    TypeError, RuntimeError, EOFError, pickle.UnpicklingError) as e:
                last_err = e
                self._tel.counter("checkpoint/manifest_failures_total").inc()
                logger.warning(
                    "checkpoint restore at step %d failed integrity/read (%s: %s) — %s", step,
                    type(e).__name__, e,
                    "walking back to the previous save" if i + 1 < len(steps) else "no older save to walk back to",
                )
                continue
            self.last_restored_step = step
            return out
        raise last_err  # type: ignore[misc]  # steps is non-empty

    def restore_config(self) -> RunConfig:
        """The RunConfig of the latest step: what a tool needs to build the
        model before it restores weights."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        with open(os.path.join(self._step_dir(step), CONFIG_FILE)) as f:
            return RunConfig.from_json(f.read())

    def restore_weights(self) -> Tuple[Dict[str, torch.Tensor], int]:
        """Weights only: ``(params state dict of CPU tensors, step)``. The
        optimizer state is ignored, so this works across optimizer
        layouts."""
        def attempt(step: int):
            raw = self._load_step(step)
            return raw["params"], int(raw["step"])

        return self._restore_stepwise(attempt)

    def restore(self, config: RunConfig, state: Any = None,
                device: DeviceLike = None) -> Tuple[Any, RunConfig]:
        """The latest valid step into ``state`` (a ``TrainState``, loaded in
        place; built from ``config`` on ``device`` when None): params,
        optimizer state, step and version. Returns (state, the step's
        config)."""
        if state is None:
            from dotaclient_tpu_torch.models.policy import make_policy
            from dotaclient_tpu_torch.train.ppo import init_train_state

            state = init_train_state(make_policy(config.model, config.obs, config.actions, device=device),
                                     config.ppo)

        def attempt(step: int):
            raw = self._load_step(step)
            with open(os.path.join(self._step_dir(step), CONFIG_FILE)) as f:
                saved = RunConfig.from_json(f.read())
            return raw, saved

        raw, saved = self._restore_stepwise(attempt)
        state.policy.load_state_dict(raw["params"])
        _load_optimizer(state.optimizer, raw["opt_state"])
        state.step, state.version = int(raw["step"]), int(raw["version"])
        return state, saved


def _load_optimizer(opt: torch.optim.Optimizer, saved: Dict[str, Any]) -> None:
    """``opt.load_state_dict(saved)``, keeping each group's learning rate
    where the live optimizer keeps it: a device tensor that the
    ``kl_target`` controller rescales in place stays that tensor (with the
    saved value), and a float stays a float."""
    lrs = [g["lr"] for g in opt.param_groups]
    opt.load_state_dict(saved)
    for group, live in zip(opt.param_groups, lrs):
        if isinstance(live, torch.Tensor):
            live.copy_(torch.as_tensor(group["lr"]))
            group["lr"] = live
        elif isinstance(group["lr"], torch.Tensor):
            group["lr"] = float(group["lr"])


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


__all__ = [
    "CheckpointIntegrityError",
    "CheckpointManager",
    "build_manifest",
    "shape_mismatches",
    "verify_manifest",
]
