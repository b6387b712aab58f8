"""Checkpoints of the learner state, with integrity manifests and walk-back.

Counterpart of ``dotaclient_tpu/utils/checkpoint.py`` in the port's own
format (the port cannot read orbax). A checkpoint directory holds::

    <dir>/<step>/state.pt        torch.save of {"step", "version",
                                 "params": state dict of CPU tensors,
                                 "opt_state": the optimizer's state dict,
                                 whole whatever the tensor-parallel
                                 layout, TrainState.optimizer_state_dict}
    <dir>/<step>/config.json     RunConfig.to_json()
    <dir>/<step>/pipeline.pt     (optional) the learner's pipeline state:
                                 the trajectory ring, the device actor's
                                 state, the minibatch draw count
    <dir>/manifests/<step>.json  per-leaf shape, dtype and frame_crc32,
                                 and the frame_crc32 of each file
    <dir>/last_good/             the last health-verified save, a manager
                                 of its own with max_to_keep 1

A step is written into a temporary directory and moved into place with
``os.replace``, so a reader never sees half of one. ``state.pt`` is read
back with ``torch.load(..., weights_only=True)``: tensors, numbers and plain
containers only, as Adam's state dict is.

Saves return before the write lands, as the reference's orbax saves do.
``save`` copies the state to the host on the calling thread (the learner
calls it between iterations: it reads the device) and ``save_host`` hands
the write to the manager's one writer thread, at most one write in flight:
a save first joins the previous write (bounded by ``LOCK_TIMEOUT_S``, as
the writers' lock is). ``wait`` blocks until the write has landed and
raises its failure; ``close`` lands it and stops the thread; a process that
exits with a write in flight lands it first (an ``atexit`` hook, bounded by
``LOCK_TIMEOUT_S``). Every reader
(``all_steps``, ``latest_step``, the ``restore*`` calls,
``last_good_step``, ``restore_last_good``, ``discard_steps_above``) joins
the pending write first, so none races it.

The failure policy is the reference's. A background write that fails
surfaces at the next save's join: a periodic save counts it
(``checkpoint/save_failures_total``), warns and goes on with its own
write; a forced save raises it. A periodic save that cannot take the lock
or join the previous write within ``LOCK_TIMEOUT_S`` is counted and
returns False; a forced one raises. The decline rule is orbax's: a save
that is not forced, at a step below the newest on disk and not on disk
itself, is declined and returns False (a step on disk is replaced, the
newest content winning). Where orbax orders its steps by save time (a
forced save below the newest becomes its "latest"), this manager orders
them by step, as a reopened orbax manager does.

Every restore verifies the step's manifest. A step that fails (unreadable,
or a leaf or file whose digest differs) is counted
(``checkpoint/manifest_failures_total``), warned about and skipped for the
previous step. ``max_to_keep`` keeps the newest saves.

The health guardian's pieces (``train/health.py``): ``save(...,
mark_good=True)`` mirrors a verified save into the ``last_good`` slot once
the main write has landed (on the writer thread), ``restore_last_good`` is
the rollback's restore point, and ``discard_steps_above`` deletes the
abandoned timeline's saves. A save with ``pipeline`` carries the rest of
the learner, which ``restore_pipeline`` brings back into a template of the
same shapes. The snapshot engine's thread and the train thread hand their
writes over under one lock. The fault sites ``checkpoint.fail_write`` (a
save raises ``OSError`` as if the disk were full) and
``checkpoint.corrupt_manifest`` (a verification fails) are those of the
reference.

``shape_mismatches`` compares a restored state dict with the one a run
expects (the learner's ``init_from`` check).
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import pickle
import shutil
import tempfile
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from dotaclient_tpu_torch.config import RunConfig
from dotaclient_tpu_torch.device import DeviceLike
from dotaclient_tpu_torch.transport.serialize import frame_crc32
from dotaclient_tpu_torch.utils import faults, telemetry

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"
CONFIG_FILE = "config.json"
PIPELINE_FILE = "pipeline.pt"
LAST_GOOD = "last_good"
STATE_KEYS = ("step", "version", "params", "opt_state")


class CheckpointIntegrityError(RuntimeError):
    """A restored checkpoint failed its integrity-manifest verification."""


def _tensor_bytes(t: torch.Tensor) -> bytes:
    # host-sync-ok: the manifest's CRC of tensors already copied to the host by save
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


# managers with a writer thread, whose pending writes land at exit
_WRITING: "weakref.WeakSet[CheckpointManager]" = weakref.WeakSet()


@atexit.register
def _land_pending_writes() -> None:
    for mgr in list(_WRITING):
        mgr.join_writes(mgr.LOCK_TIMEOUT_S)


class CheckpointManager:
    """Saves handed to one writer thread, and verified, walk-back restores,
    under one directory."""

    # how long a save, ``wait`` or ``discard_steps_above`` waits for the
    # writers' lock or for the previous write to land: a wedged disk fails
    # a forced save loudly and costs a periodic one, instead of a hang
    LOCK_TIMEOUT_S = 120.0

    def __init__(self, directory: str, max_to_keep: int = 3,
                 registry: Optional[telemetry.Registry] = None, _is_slot: bool = False) -> None:
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max(1, max_to_keep)
        self._tel = registry if registry is not None else telemetry.get_registry()
        # the step a walk-back restore landed on
        self.last_restored_step: Optional[int] = None
        self._is_slot = _is_slot
        self._slot_mgr: Optional["CheckpointManager"] = None
        # the snapshot engine's periodic saves and the train thread's
        # forced ones hand their writes over under one lock
        self._save_lock = threading.Lock()
        # the writer: one write in flight (``_job``, set until it has
        # landed) and the failure of a landed write not yet surfaced
        self._cond = threading.Condition()
        self._job: Optional[Callable[[], None]] = None
        self._error: Optional[BaseException] = None
        self._writer: Optional[threading.Thread] = None
        self._faults = faults.get()   # None unless fault injection is on
        self._tel.counter("checkpoint/save_failures_total")
        self._tel.counter("checkpoint/manifest_failures_total")

    # -- layout ---------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.directory, "manifests", f"{step}.json")

    def _steps_on_disk(self) -> List[int]:
        return sorted(
            # host-sync-ok: step directories' names
            int(n) for n in os.listdir(self.directory)
            if n.isdigit() and os.path.isfile(os.path.join(self.directory, n, STATE_FILE))
        )

    def all_steps(self) -> List[int]:
        """The steps on disk, oldest first, once the pending write has
        landed."""
        self.join_writes()
        return self._steps_on_disk()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- the writer -------------------------------------------------------------

    def join_writes(self, timeout: Optional[float] = None) -> bool:
        """Block until the write in flight has landed, without surfacing
        its failure (the next save or ``wait`` does); False on timeout."""
        if threading.current_thread() is self._writer:
            return True   # the writer's own reads: its job is the one in flight
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._job is not None:
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._cond.wait(left)
        return True

    def _take_error(self) -> Optional[BaseException]:
        with self._cond:
            err, self._error = self._error, None
            return err

    def _hand_off(self, job: Callable[[], None]) -> None:
        """Give ``job`` to the writer thread (the previous one has landed:
        the caller joined it under the lock)."""
        with self._cond:
            self._job = job
            if self._writer is None:
                self._writer = threading.Thread(target=self._run_writer, name="checkpoint-writer", daemon=True)
                self._writer.start()
                _WRITING.add(self)
            self._cond.notify_all()

    def _run_writer(self) -> None:
        while True:
            with self._cond:
                while self._job is None and self._writer is threading.current_thread():
                    self._cond.wait()
                if self._job is None:
                    return   # closed
                job = self._job
            err = None
            try:
                job()
            except Exception as e:  # noqa: BLE001 - surfaced at the next join that asks
                err = e
            with self._cond:
                self._job = None
                if err is not None:
                    self._error = err
                self._cond.notify_all()

    def _refuse(self, force: bool, err: BaseException) -> bool:
        """A save that could not be handed over: raised when forced, else
        counted and declined."""
        if force:
            raise err
        self._tel.counter("checkpoint/save_failures_total").inc()
        logger.warning("periodic checkpoint save failed (%s: %s); training continues", type(err).__name__, err)
        return False

    def wait(self) -> None:
        """Block until the pending write has landed; raise its failure."""
        if not self._save_lock.acquire(timeout=self.LOCK_TIMEOUT_S):
            raise RuntimeError(f"checkpoint writer lock not acquired within {self.LOCK_TIMEOUT_S:.0f}s: a "
                               "concurrent save appears wedged")
        try:
            if not self.join_writes(self.LOCK_TIMEOUT_S):
                raise RuntimeError(f"the checkpoint write in flight did not land within {self.LOCK_TIMEOUT_S:.0f}s")
            err = self._take_error()
            if err is not None:
                raise err
        finally:
            self._save_lock.release()

    def close(self) -> None:
        """Land the pending write and stop the writer thread. A failure
        no save surfaced is counted and warned about, never raised."""
        self.join_writes(self.LOCK_TIMEOUT_S)
        err = self._take_error()
        if err is not None:
            self._tel.counter("checkpoint/save_failures_total").inc()
            logger.warning("the last checkpoint write failed (%s: %s)", type(err).__name__, err)
        with self._cond:
            writer, self._writer = self._writer, None
            self._cond.notify_all()
        if writer is not None:
            writer.join(self.LOCK_TIMEOUT_S)
        if self._slot_mgr is not None:
            self._slot_mgr.close()

    # -- save -------------------------------------------------------------------

    def save(self, state: Any, config: RunConfig, force: bool = False, pipeline: Optional[Any] = None,
             mark_good: bool = False, opt_state: Optional[Dict[str, Any]] = None) -> bool:
        """Save ``state`` (a ``TrainState``: its step, version, policy params
        and optimizer state) and ``config`` at ``state.step``, with
        ``pipeline`` (a tree of tensors and ints) beside it. The copy to the
        host happens here (it reads the device: the learner calls it only
        between iterations); the write lands after it returns. A state of
        the tensor-parallel layout gathers its optimizer state over the
        model group here (every rank of it must call this), unless
        ``opt_state`` gives it, gathered already."""
        host_state = {
            # host-sync-ok: host ints
            "step": int(state.step),
            # host-sync-ok: host ints
            "version": int(state.version),
            # host-sync-ok: the save path's one batched fetch: the learner saves between iterations
            "params": {k: v.detach().cpu().clone() for k, v in state.policy.state_dict().items()},
            "opt_state": _to_cpu(opt_state if opt_state is not None else _whole_opt_state(state)),
        }
        if pipeline is not None:
            pipeline = _to_cpu(pipeline)
        return self.save_host(host_state, config, force=force, pipeline=pipeline, mark_good=mark_good)

    def save_host(self, host_state: Dict[str, Any], config: RunConfig, force: bool = False,
                  pipeline: Optional[Any] = None, mark_good: bool = False) -> bool:
        """Hand the write of an already-fetched host state dict (``step``,
        ``version``, ``params``, ``opt_state``; tensors nothing writes into
        afterwards), and of ``pipeline`` if given, to the writer thread.
        Returns True when handed over, False when declined (the decline
        rule) or, for a periodic save, refused. With ``mark_good`` (a
        health-verified state) the landed save is mirrored into the
        ``last_good`` slot."""
        # host-sync-ok: a host int
        step = int(host_state["step"])
        if not self._save_lock.acquire(timeout=self.LOCK_TIMEOUT_S):
            return self._refuse(force, RuntimeError(
                f"checkpoint writer lock not acquired within {self.LOCK_TIMEOUT_S:.0f}s: a concurrent save appears "
                f"wedged; step {step} was not written"))
        try:
            if not self.join_writes(self.LOCK_TIMEOUT_S):
                return self._refuse(force, RuntimeError(
                    f"the previous checkpoint write did not land within {self.LOCK_TIMEOUT_S:.0f}s; step {step} was "
                    "not written"))
            prev = self._take_error()
            if prev is not None:
                if force:
                    raise prev
                self._tel.counter("checkpoint/save_failures_total").inc()
                logger.warning("an earlier checkpoint write failed (%s: %s); counted; saving step %d anyway",
                               type(prev).__name__, prev, step)
            if self._faults is not None and self._faults.fire("checkpoint.fail_write"):
                return self._refuse(force, OSError("injected fault: checkpoint.fail_write (a full disk)"))
            steps = self._steps_on_disk()
            if not force and steps and step < steps[-1] and step not in steps:
                logger.info("checkpoint save at step %d declined: below the newest step %d", step, steps[-1])
                return False
            self._hand_off(lambda: self._write(host_state, config, pipeline, mark_good))
            return True
        finally:
            self._save_lock.release()

    def _write(self, host_state: Dict[str, Any], config: RunConfig, pipeline: Optional[Any],
               mark_good: bool) -> None:
        """The write itself, on the writer thread: a temporary directory
        moved into place, the manifest, the retention, the mirror."""
        # host-sync-ok: a host int
        step = int(host_state["step"])
        tmp = None
        try:
            tmp = tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=self.directory)
            state_path = os.path.join(tmp, STATE_FILE)
            torch.save(host_state, state_path)
            with open(os.path.join(tmp, CONFIG_FILE), "w") as f:
                f.write(config.to_json())
            files = [STATE_FILE, CONFIG_FILE]
            if pipeline is not None:
                torch.save(pipeline, os.path.join(tmp, PIPELINE_FILE))
                files.append(PIPELINE_FILE)
            manifest = {
                "step": step,
                **build_manifest(host_state),
                "files": {n: _file_crc(os.path.join(tmp, n)) for n in files},
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
        finally:
            if tmp is not None:
                shutil.rmtree(tmp, ignore_errors=True)
        self._retain()
        if mark_good and not self._is_slot:
            self._save_last_good(host_state, config)

    def _save_last_good(self, host_state: Dict[str, Any], config: RunConfig) -> None:
        """Mirror a landed, health-verified save into the ``last_good`` slot
        (its own manager, so the main retention never deletes it), and wait
        for it there. An I/O error here is counted and warned about; the
        main save stands."""
        # host-sync-ok: a host int
        step = int(host_state["step"])
        try:
            slot = self._last_good_slot()
            slot.save_host({k: host_state[k] for k in STATE_KEYS}, config, force=True)
            slot.wait()
            # host-sync-ok: a host int
            self._tel.gauge("health/last_good_step").set(float(step))
        except Exception as e:  # noqa: BLE001 - a protection layer, never fatal
            self._tel.counter("checkpoint/save_failures_total").inc()
            logger.warning("last_good slot update at step %d failed (%s: %s); the main save stands", step,
                           type(e).__name__, e)

    def _last_good_slot(self) -> "CheckpointManager":
        if self._slot_mgr is None:
            self._slot_mgr = CheckpointManager(os.path.join(self.directory, LAST_GOOD), max_to_keep=1,
                                               registry=self._tel, _is_slot=True)
        return self._slot_mgr

    def last_good_step(self) -> Optional[int]:
        """The step the ``last_good`` slot holds, or None before the first
        health-verified save (after the pending mirror has landed)."""
        self.join_writes()
        if self._slot_mgr is None and not os.path.isdir(os.path.join(self.directory, LAST_GOOD)):
            return None
        return self._last_good_slot().latest_step()

    def restore_last_good(self, config: RunConfig, state: Any = None,
                          device: DeviceLike = None) -> Optional[Tuple[Any, RunConfig]]:
        """The last health-verified save into ``state`` (the rollback's
        restore point), verified like every restore; None when the slot is
        empty."""
        if self.last_good_step() is None:
            return None
        return self._last_good_slot().restore(config, state, device=device)

    def discard_steps_above(self, step: int) -> int:
        """Delete every save newer than ``step`` (the rollback: the
        abandoned timeline's saves must not be restorable, and the
        retrained run reaches their step numbers again), once the pending
        write has landed. Returns how many were deleted."""
        if not self._save_lock.acquire(timeout=self.LOCK_TIMEOUT_S):
            raise RuntimeError(f"checkpoint writer lock not acquired within {self.LOCK_TIMEOUT_S:.0f}s: cannot "
                               "discard the abandoned timeline's saves")
        try:
            if not self.join_writes(self.LOCK_TIMEOUT_S):
                raise RuntimeError(f"the checkpoint write in flight did not land within "
                                   f"{self.LOCK_TIMEOUT_S:.0f}s: cannot discard the abandoned timeline's saves")
            doomed = [s for s in self._steps_on_disk() if s > step]
            for s in doomed:
                self._delete(s)
            return len(doomed)
        finally:
            self._save_lock.release()

    def _delete(self, step: int) -> None:
        shutil.rmtree(self._step_dir(step), ignore_errors=True)
        try:
            os.unlink(self._manifest_path(step))
        except OSError:
            pass

    def _retain(self) -> None:
        """Delete all but the newest ``max_to_keep`` steps and their
        manifests."""
        for step in self._steps_on_disk()[: -self.max_to_keep]:
            self._delete(step)

    # -- restore ----------------------------------------------------------------

    def _manifest(self, step: int) -> Optional[dict]:
        """One step's manifest, None for a step saved without one. Raises
        :class:`CheckpointIntegrityError` when it is unreadable, or when
        the ``checkpoint.corrupt_manifest`` fault fires."""
        if self._faults is not None and self._faults.fire("checkpoint.corrupt_manifest"):
            raise CheckpointIntegrityError("injected fault: checkpoint.corrupt_manifest")
        try:
            with open(self._manifest_path(step)) as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointIntegrityError(f"manifest for step {step} unreadable: {e}") from e

    def _check_files(self, step: int, manifest: Optional[dict], names: Optional[Tuple[str, ...]] = None) -> None:
        """Each file of the manifest (or ``names`` of them) against its crc."""
        if manifest is None:
            return
        for name, crc in manifest.get("files", {}).items():
            if names is not None and name not in names:
                continue
            got = _file_crc(os.path.join(self._step_dir(step), name))
            if got != crc:
                raise CheckpointIntegrityError(f"{name} of step {step}: crc {got} != saved {crc}")

    def _load_step(self, step: int) -> Dict[str, Any]:
        """Read and verify one step's state (a step without a manifest
        restores unverified)."""
        manifest = self._manifest(step)
        self._check_files(step, manifest, (STATE_FILE, CONFIG_FILE))
        raw = torch.load(os.path.join(self._step_dir(step), STATE_FILE), map_location="cpu", weights_only=True)
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
        if hasattr(state, "load_whole"):
            state.load_whole(raw["params"], raw["opt_state"])
        else:
            from dotaclient_tpu_torch.train.ppo import load_optimizer_state

            state.policy.load_state_dict(raw["params"])
            load_optimizer_state(state.optimizer, raw["opt_state"])
        state.step, state.version = int(raw["step"]), int(raw["version"])
        return state, saved

    def restore_pipeline(self, template: Any, step: Optional[int] = None) -> Tuple[Optional[Any], str]:
        """The pipeline state saved with ``step`` (by default the step the
        last restore landed on, else the newest), checked leaf by leaf
        against ``template``'s shapes. Returns (state, "") on success,
        (None, "") when the step has no pipeline, and (None, reason) when
        it has one that cannot be restored: a caller must say so loudly."""
        self.join_writes()
        if step is None:
            step = self.last_restored_step if self.last_restored_step is not None else self.latest_step()
        if step is None or not os.path.isfile(os.path.join(self._step_dir(step), PIPELINE_FILE)):
            return None, ""
        try:
            self._check_files(step, self._manifest(step), (PIPELINE_FILE,))
            out = torch.load(os.path.join(self._step_dir(step), PIPELINE_FILE), map_location="cpu",
                             weights_only=True)
        except (CheckpointIntegrityError, OSError, RuntimeError, EOFError, pickle.UnpicklingError) as e:
            return None, f"{type(e).__name__}: {e}"
        got = {k: v for k, v in _leaves(out) if isinstance(v, torch.Tensor)}
        want = {k: v for k, v in _leaves(template) if isinstance(v, torch.Tensor)}
        bad = shape_mismatches(got, want)
        if bad:
            return None, f"pipeline leaf shape mismatch: {bad[0]} (+{len(bad) - 1} more)"
        return out, ""


def _whole_opt_state(state: Any) -> Dict[str, Any]:
    """The optimizer state of ``state`` in the whole layout: a
    ``TrainState``'s own (gathered under tensor parallelism), else any
    state's optimizer's."""
    if hasattr(state, "optimizer_state_dict"):
        return state.optimizer_state_dict()
    return state.optimizer.state_dict()


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        # host-sync-ok: the save path's one batched fetch (the optimizer state and the pipeline beside the params)
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
