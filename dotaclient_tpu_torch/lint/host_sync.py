"""host-sync pass: no per-step host↔device syncs in the hot-path modules.

The learner's throughput rests on a discipline, not a mechanism: the train
loop only issues work to the card, and device values are read once per
``log_every`` boundary (docs/ARCHITECTURE.md "Observability", "Pipelined
data path"). That discipline regresses silently: one stray
``float(metrics["loss"])`` in the loop waits for the card every step, and
nothing crashes.

This pass is the static tripwire, the counterpart of the JAX package's
``lint/host_sync.py`` over the port's modules (``ALLOWED_FUNCS`` and
``SCAN_ONLY_FUNCS`` list the counterparts of the reference's thirteen). It
AST-scans them for the torch spellings of a read of a device value onto
the host:

* ``<x>.item()``, ``<x>.cpu()``, ``<x>.tolist()``, ``<x>.numpy()``
* ``float(...)``, ``int(...)``, ``bool(...)``
* ``np.asarray(...)`` / ``np.array(...)``
* ``torch.cuda.synchronize(...)`` / ``<x>.synchronize()``

and flags each occurrence that is neither inside an ALLOWED function
(construction, checkpoint and boundary code that runs off the hot path by
design) nor annotated at the line. Two annotation spellings are honoured:
``# host-sync-ok: <why>`` and the framework-standard
``# lint-ok: host-sync(<why>)``.

Static analysis cannot prove that an ``int()`` touches a device value, and
most annotated ones wrap host numbers; but every NEW unannotated occurrence
is exactly the kind of line a code review must look at. It complements, and
does not replace, the check on the card: ``chip_smoke.py`` runs the timed
loops under ``torch.cuda.set_sync_debug_mode("error")``, which raises on
any sync this pass cannot see (a tensor's truth value, a ``print``).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from dotaclient_tpu_torch.lint.core import Diagnostic, FileCtx, Rule, dotted_name

# Functions that legitimately sync: construction, checkpoint/restore, and
# log-boundary drains. Regressions INSIDE these functions are at the
# boundary's cadence, not a step's: out of scope for this pass.
# _publish_weights is deliberately NOT here: with the asynchronous snapshot
# engine it must only issue work on the train thread, so any sync pattern
# added to it needs a visible annotation.
ALLOWED_FUNCS: Dict[str, Set[str]] = {
    "dotaclient_tpu_torch/train/learner.py": {
        "__init__",
        "_load_best_win",       # construction: reads the best model's record
        "_seed_from",           # construction: --init-from's restore
        "_pipeline_state",
        "_restore_pipeline",
        "_flush_league_reports",
        "_publish_pipeline_gauges",
        "_maybe_save_best",
        "crash_checkpoint",     # the crash path: the run is over
        "main",
        "_run_cli",
    },
    "dotaclient_tpu_torch/buffer/trajectory_buffer.py": {
        "__init__",
        "_matches_slot",
        "_payload_finite",      # admission door: host arrays only
        "_payload_in_bounds",   # admission door: host arrays only
        "state_dict",
        "_local_state_dict",    # state_dict's halves: checkpoint cadence
        "_gather_state",
        "_door_state",
        "load_state_dict",
        "_cut_state",           # load_state_dict's halves: restore
        "_restored_leaf",
        "_publish_telemetry",
        "metrics",
    },
    # the health monitor: submit/take_pending run on the train thread and
    # must stay host-only; the fold side receives ALREADY fetched scalars
    # (the engine's one batched transfer), its casts annotated at the line
    "dotaclient_tpu_torch/train/health.py": set(),
    # the one-pass advantage plane: the consume-time pass runs on the
    # train thread between a gather and an update; it must only issue work
    # end to end (a hidden read there would serialize every consumed batch
    # behind the card); no function-level pass
    "dotaclient_tpu_torch/train/advantage.py": set(),
    # the outcome plane: the aggregator tick runs on the train thread at
    # log boundaries (in-process modes) and on the fleet aggregator's
    # thread (external modes); it must stay pure host registry arithmetic,
    # and the recording helpers take ALREADY fetched host scalars
    "dotaclient_tpu_torch/outcome/aggregator.py": {"__init__"},
    "dotaclient_tpu_torch/outcome/records.py": set(),
    # the utilization plane: pure host interval arithmetic, inline on the
    # train, actor and batcher threads at phase boundaries; no
    # function-level pass
    "dotaclient_tpu_torch/utils/utilization.py": set(),
    # the snapshot engine IS the designated sync site: its one batched
    # fetch is annotated at the line, everything else must stay host-only
    "dotaclient_tpu_torch/train/snapshot.py": set(),
    # checkpoints: restores are asked for by the user and sync by design;
    # the save path does exactly ONE batched fetch (annotated) and the
    # snapshot thread's entry point (save_host) none at all
    "dotaclient_tpu_torch/utils/checkpoint.py": {
        "shape_mismatches",
        "restore",
        "restore_weights",
        "restore_config",
        "restore_pipeline",
        "_restore_stepwise",    # restore's walk-back over the steps
        "_load_step",
        "attempt",              # restore's and restore_weights' closures
    },
}

# Modules where only the PUBLISH path (and the ingest accounting) is in
# scope: the transports are big and mostly reader-side, but
# publish_weights runs on the learner's snapshot thread (or the train
# thread with synchronous snapshots), and consume_decoded feeds the ring's
# door on the train thread every ingest. Only the named functions are
# scanned.
SCAN_ONLY_FUNCS: Dict[str, Set[str]] = {
    "dotaclient_tpu_torch/transport/socket_transport.py": {
        "publish_weights", "_writer_loop", "consume_decoded",
    },
    "dotaclient_tpu_torch/transport/shm_transport.py": {
        "publish_weights", "consume_decoded",
    },
    "dotaclient_tpu_torch/transport/queues.py": {"publish_weights"},
    # the byte accounting both consume_decoded paths call
    "dotaclient_tpu_torch/transport/serialize.py": {"decode_drained_payloads"},
}

ANNOTATION = "host-sync-ok"
_FRAMEWORK_ANNOTATION = "lint-ok: host-sync("

# the no-argument tensor methods that copy to the host
_READ_METHODS = ("item", "cpu", "tolist", "numpy")


def _pattern_of(call: ast.Call) -> Optional[str]:
    """Name of the sync pattern a Call node matches, or None."""
    fn = call.func
    if isinstance(fn, ast.Name) and fn.id in ("float", "int", "bool"):
        return f"{fn.id}()"
    if isinstance(fn, ast.Attribute):
        base = fn.value
        base_name = base.id if isinstance(base, ast.Name) else None
        if fn.attr in ("asarray", "array") and base_name == "np":
            return f"np.{fn.attr}()"
        if fn.attr in _READ_METHODS and not call.args:
            return f".{fn.attr}()"
        if fn.attr == "synchronize":
            if dotted_name(base) == "torch.cuda":
                return "torch.cuda.synchronize()"
            return ".synchronize()"
    return None


class _Scanner(ast.NodeVisitor):
    def __init__(self) -> None:
        self.func_stack: List[str] = []
        self.hits: List[Tuple[int, str, Optional[str]]] = []

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.func_stack.append(node.name)
        self.generic_visit(node)
        self.func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node: ast.Call) -> None:
        pat = _pattern_of(node)
        if pat is not None:
            # innermost NAMED def wins: closures like after_step() get
            # their own identity instead of hiding under train()
            fn = self.func_stack[-1] if self.func_stack else None
            self.hits.append((node.lineno, pat, fn))
        self.generic_visit(node)


def scan_source(
    source: str,
    allowed_funcs: Set[str],
    filename: str = "<string>",
    scan_only: Optional[Set[str]] = None,
) -> List[Tuple[int, str, Optional[str]]]:
    """Structured findings for one module: (line, pattern, func) triples
    that are neither allowed nor annotated (either spelling).

    ``scan_only`` restricts the scan to the named functions (the publish-
    path modules); ``None`` scans the whole module."""
    tree = ast.parse(source, filename)
    scanner = _Scanner()
    scanner.visit(tree)
    lines = source.splitlines()
    out: List[Tuple[int, str, Optional[str]]] = []
    for lineno, pat, func in scanner.hits:
        if scan_only is not None and func not in scan_only:
            continue
        if func in allowed_funcs:
            continue
        here = lines[lineno - 1] if lineno - 1 < len(lines) else ""
        above = lines[lineno - 2] if lineno >= 2 else ""
        if any(
            mark in text
            for mark in (ANNOTATION, _FRAMEWORK_ANNOTATION)
            for text in (here, above)
        ):
            continue
        out.append((lineno, pat, func))
    return out


def _message(pat: str, func: Optional[str]) -> str:
    where = f"in {func}()" if func else "at module level"
    return (
        f"{pat} {where} — a host↔device sync pattern on the hot path; "
        f"move it behind a log_every boundary, or annotate "
        f"'# {ANNOTATION}: <why>' if it only touches host values"
    )


def check_source(
    source: str,
    allowed_funcs: Set[str],
    filename: str = "<string>",
    scan_only: Optional[Set[str]] = None,
) -> List[str]:
    """Violation strings for one module's source (empty = clean): the
    ``utils/check_host_sync.py`` surface, byte-compatible with the JAX
    package's ``scripts/check_host_sync.py``."""
    return [
        f"{filename}:{lineno}: {_message(pat, func)}"
        for lineno, pat, func in scan_source(
            source, allowed_funcs, filename, scan_only=scan_only
        )
    ]


class HostSyncRule(Rule):
    id = "host-sync"
    summary = (
        "hot-path modules carry no unannotated host<->device sync patterns"
    )

    def paths(self) -> Iterable[str]:
        return sorted(ALLOWED_FUNCS) + sorted(SCAN_ONLY_FUNCS)

    def check(self, files: Dict[str, FileCtx]) -> List[Diagnostic]:
        out: List[Diagnostic] = []
        for rel, allowed in sorted(ALLOWED_FUNCS.items()):
            ctx = files.get(rel)
            if ctx is None:
                continue
            for lineno, pat, func in scan_source(ctx.source, allowed, rel):
                out.append(
                    Diagnostic(
                        rel, lineno, self.id, _message(pat, func),
                        context=func or "",
                    )
                )
        for rel, only in sorted(SCAN_ONLY_FUNCS.items()):
            ctx = files.get(rel)
            if ctx is None:
                continue
            for lineno, pat, func in scan_source(
                ctx.source, set(), rel, scan_only=only
            ):
                out.append(
                    Diagnostic(
                        rel, lineno, self.id, _message(pat, func),
                        context=func or "",
                    )
                )
        return out


def run_standalone(argv: Optional[List[str]] = None) -> int:
    """The ``utils/check_host_sync.py`` entry point: exit 0 when clean, 1
    with per-line diagnostics on stderr, the output of the JAX package's
    ``scripts/check_host_sync.py`` line for line."""
    import argparse
    import os
    import sys

    from dotaclient_tpu_torch.lint.core import REPO_ROOT

    p = argparse.ArgumentParser(description=__doc__)
    p.parse_args(argv)
    all_violations: List[str] = []
    for rel, allowed in sorted(ALLOWED_FUNCS.items()):
        with open(os.path.join(REPO_ROOT, rel)) as f:
            all_violations.extend(check_source(f.read(), allowed, rel))
    for rel, only in sorted(SCAN_ONLY_FUNCS.items()):
        with open(os.path.join(REPO_ROOT, rel)) as f:
            all_violations.extend(
                check_source(f.read(), set(), rel, scan_only=only)
            )
    if all_violations:
        print("host-sync discipline check FAILED:", file=sys.stderr)
        for v in all_violations:
            print(f"  - {v}", file=sys.stderr)
        return 1
    scanned = sorted(ALLOWED_FUNCS) + sorted(SCAN_ONLY_FUNCS)
    print(f"host-sync discipline OK: {', '.join(scanned)}")
    return 0
