"""config-drift pass: CLI flags and override knobs match the operator docs.

The counterpart of the JAX package's ``lint/config_drift.py`` over the
port. Two operator contracts drift the same way telemetry keys do:

* **Override knobs.** Every dataclass field reachable through the
  ``--ppo/--reward/--league/--buffer/--health/--learner/--mesh/--serve
  K=V`` override flags (``utils/overrides.py``) is a public tuning
  surface. The docs/OPERATIONS.md "Config override knobs" tables (the
  operator contract the port promises, as the JAX package does) plus the
  port's own knob tables in ``dotaclient_tpu_torch/OPERATIONS.md`` must
  list every such field of the port's ``config.py``, and every field the
  tables list must exist.
* **CLI flags.** Every ``--flag`` either OPERATIONS.md mentions must exist
  in some port entrypoint (a documented flag that argparse rejects is a
  broken runbook), unless the port's OPERATIONS.md lists it in its
  "Reference flags the port does not define" table with the reason; and
  every flag the learner/actor CLIs define must appear in one of the two.

Everything is extracted statically: ``config.py`` dataclass fields via
AST, ``add_argument("--x", ...)`` calls via AST (a flag passed as a loop
variable resolves when the loop runs over a tuple of literal tuples, as
the learner's override flags are added), documented flags via a regex
that rejects ``--xla_...``-style env-var fragments, knob tables via the
``### --flag (ClassName)`` heading + first-column-backtick convention.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Set, Tuple

from dotaclient_tpu_torch.lint.core import Diagnostic, FileCtx, Rule, table_tokens

CONFIG_PY = "dotaclient_tpu_torch/config.py"
OPERATIONS_MD = "docs/OPERATIONS.md"
PORT_OPERATIONS_MD = "dotaclient_tpu_torch/OPERATIONS.md"

# the port's OPERATIONS.md section listing the reference's documented
# flags that no port entrypoint defines, each with its reason
NOT_DEFINED_HEADING = "## Reference flags the port does not define"

# override flag → the dataclass it reaches (train/learner.py main();
# train/demo.py shares --ppo/--reward/--league via the same parser)
OVERRIDE_FLAGS: Dict[str, str] = {
    "--ppo": "PPOConfig",
    "--reward": "RewardConfig",
    "--league": "LeagueConfig",
    "--buffer": "BufferConfig",
    "--health": "HealthConfig",
    "--learner": "LearnerConfig",
    "--mesh": "MeshConfig",
    "--serve": "ServeConfig",
}

# CLIs whose full flag surface must be documented
OPERATOR_CLIS = (
    "dotaclient_tpu_torch/train/learner.py",
    "dotaclient_tpu_torch/actor/__main__.py",
)

# every entrypoint a documented flag may legitimately belong to: the
# counterparts of the reference's, and the port's consoles
ALL_CLIS = OPERATOR_CLIS + (
    "dotaclient_tpu_torch/league/__main__.py",
    "dotaclient_tpu_torch/lint/__main__.py",
    "dotaclient_tpu_torch/serve/__main__.py",
    "dotaclient_tpu_torch/serve/router.py",
    "dotaclient_tpu_torch/serve/loadgen.py",
    "dotaclient_tpu_torch/utils/chaos_run.py",
    "dotaclient_tpu_torch/utils/fleet_status.py",
    "dotaclient_tpu_torch/utils/run_multichip.py",
    "dotaclient_tpu_torch/train/demo.py",
    "dotaclient_tpu_torch/train/curriculum.py",
    "dotaclient_tpu_torch/train/bench_configs.py",
    "dotaclient_tpu_torch/utils/check_telemetry_schema.py",
    "dotaclient_tpu_torch/utils/check_host_sync.py",
    "dotaclient_tpu_torch/utils/trace_report.py",
    "dotaclient_tpu_torch/utils/outcome_report.py",
    "dotaclient_tpu_torch/utils/utilization_report.py",
    "dotaclient_tpu_torch/bench.py",
    "dotaclient_tpu_torch/transport/bench_producer.py",
    "dotaclient_tpu_torch/utils/bench_trajectory.py",
)

# `--flag` mention: lowercase-dashed word; a trailing [_a-z0-9] after the
# match would mean we clipped a longer token (e.g. --xla_force_...), and
# a leading '-' would mean we are inside a '---' rule line.
_DOC_FLAG_RE = re.compile(r"(?<!-)--([a-z][a-z0-9]*(?:-[a-z0-9]+)*)(?![a-z0-9_-])")

_KNOB_HEADING_RE = re.compile(r"^###\s+`?(--[a-z-]+)`?\s+\((\w+)\)\s*$")
_KNOB_ROW_RE = re.compile(r"^\|\s*`([a-z0-9_]+)`\s*\|")


def dataclass_fields(config_source: str) -> Dict[str, List[str]]:
    """class name → annotated field names, via AST (no import)."""
    tree = ast.parse(config_source)
    out: Dict[str, List[str]] = {}
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        fields = [
            stmt.target.id
            for stmt in node.body
            if isinstance(stmt, ast.AnnAssign)
            and isinstance(stmt.target, ast.Name)
        ]
        out[node.name] = fields
    return out


def _loop_bindings(tree: ast.AST) -> Dict[int, Dict[str, List[str]]]:
    """For every ``for A, B, ... in ((<str>, ...), ...):`` (or ``for A in
    (<str>, ...):``; the tuple may be a module-level name), map the loop's
    line span to {name: the literals it takes}, for each target name whose
    position holds a string literal in every item."""
    out: Dict[int, Dict[str, List[str]]] = {}
    # module-level NAME = (...) tuples a loop may run over by name
    named = {
        stmt.targets[0].id: stmt.value
        for stmt in getattr(tree, "body", [])
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
        and isinstance(stmt.targets[0], ast.Name) and isinstance(stmt.value, (ast.Tuple, ast.List))
    }
    for node in ast.walk(tree):
        if not isinstance(node, ast.For):
            continue
        it = named.get(node.iter.id) if isinstance(node.iter, ast.Name) else node.iter
        if not isinstance(it, (ast.Tuple, ast.List)):
            continue
        items = it.elts
        if isinstance(node.target, ast.Name):
            names = {0: node.target.id}
            rows = [[e] for e in items]
        elif isinstance(node.target, ast.Tuple):
            names = {i: t.id for i, t in enumerate(node.target.elts) if isinstance(t, ast.Name)}
            rows = [e.elts if isinstance(e, (ast.Tuple, ast.List)) else [] for e in items]
        else:
            continue
        for i, name in names.items():
            lits = [r[i].value for r in rows
                    if i < len(r) and isinstance(r[i], ast.Constant) and isinstance(r[i].value, str)]
            if len(lits) != len(rows):
                continue
            for line in range(node.lineno, (node.end_lineno or node.lineno) + 1):
                out.setdefault(line, {})[name] = lits
    return out


def cli_flags(py_source: str) -> Set[str]:
    """Every ``--flag`` passed to an add_argument call: literals, and loop
    variables bound to literals (``_loop_bindings``)."""
    tree = ast.parse(py_source)
    bindings = _loop_bindings(tree)
    out: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if not (isinstance(fn, ast.Attribute) and fn.attr == "add_argument"):
            continue
        for arg in node.args:
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                values = [arg.value]
            elif isinstance(arg, ast.Name):
                values = bindings.get(node.lineno, {}).get(arg.id, [])
            else:
                continue
            out.update(v for v in values if v.startswith("--"))
    return out


def documented_flags(doc_text: str) -> Dict[str, int]:
    """--flag mentions in the doc → first line number."""
    out: Dict[str, int] = {}
    for i, line in enumerate(doc_text.splitlines(), 1):
        for m in _DOC_FLAG_RE.finditer(line):
            out.setdefault(f"--{m.group(1)}", i)
    return out


def knob_tables(doc_text: str) -> Dict[str, Tuple[str, Dict[str, int]]]:
    """Parse the "Config override knobs" tables:
    flag → (ClassName, {knob: line})."""
    out: Dict[str, Tuple[str, Dict[str, int]]] = {}
    current: str = ""
    for i, line in enumerate(doc_text.splitlines(), 1):
        stripped = line.strip()
        m = _KNOB_HEADING_RE.match(stripped)
        if m:
            current = m.group(1)
            out[current] = (m.group(2), {})
            continue
        if stripped.startswith("#"):
            # any other heading closes the table: a later unrelated
            # backticked-first-column table must not be misattributed to
            # the last knob table
            current = ""
            continue
        if current:
            row = _KNOB_ROW_RE.match(stripped)
            if row and row.group(1) not in ("knob",):
                out[current][1].setdefault(row.group(1), i)
    return out


def drift_findings(
    fields_by_class: Dict[str, List[str]],
    flags_by_cli: Dict[str, Set[str]],
    doc_text: str,
    rule_id: str = "config-drift",
    doc_path: str = OPERATIONS_MD,
    config_path: str = CONFIG_PY,
    port_doc_text: str = "",
    port_doc_path: str = PORT_OPERATIONS_MD,
) -> List[Diagnostic]:
    """Pure cross-check (unit-testable with synthetic inputs).
    ``port_doc_text`` (the port's OPERATIONS.md) adds knob rows and flag
    mentions of what only the port has, and its NOT_DEFINED_HEADING table
    the reference's documented flags the port does not define."""
    out: List[Diagnostic] = []
    tables = knob_tables(doc_text)
    for flag, (cls, knobs) in knob_tables(port_doc_text).items():
        merged = dict(knobs)
        merged.update(tables.get(flag, (cls, {}))[1])
        tables[flag] = (tables.get(flag, (cls, {}))[0], merged)
    doc_flags = documented_flags(doc_text)
    port_flags = documented_flags(port_doc_text)
    not_defined = {
        tok: line for tok, line in table_tokens(port_doc_text, NOT_DEFINED_HEADING).items()
        if tok.startswith("--")
    }
    # 1. override-reachable fields ⊆ knob tables; table rows ⊆ fields;
    #    and the flag itself must exist on the learner CLI (a knob table
    #    for a flag argparse rejects is a broken runbook)
    learner_flags = flags_by_cli.get(OPERATOR_CLIS[0])
    for flag, cls in sorted(OVERRIDE_FLAGS.items()):
        if learner_flags is not None and flag not in learner_flags:
            out.append(
                Diagnostic(
                    OPERATOR_CLIS[0], 0, rule_id,
                    f"override flag {flag} (→ {cls}) is declared in "
                    f"OVERRIDE_FLAGS but the learner CLI does not define "
                    f"it — add the add_argument or drop the mapping",
                    context=flag,
                )
            )
        fields = fields_by_class.get(cls)
        if fields is None:
            continue
        table = tables.get(flag)
        if table is None:
            out.append(
                Diagnostic(
                    doc_path, 0, rule_id,
                    f"no '### {flag} ({cls})' knob table in OPERATIONS.md "
                    f"'Config override knobs' — every {flag} K=V-reachable "
                    f"field must be documented there",
                    context=flag,
                )
            )
            continue
        doc_cls, knobs = table
        if doc_cls != cls:
            out.append(
                Diagnostic(
                    doc_path, 0, rule_id,
                    f"knob table for {flag} names {doc_cls} but the CLI "
                    f"maps it to {cls}",
                    context=flag,
                )
            )
        for field in fields:
            if field not in knobs:
                out.append(
                    Diagnostic(
                        config_path, 0, rule_id,
                        f"{cls}.{field} is reachable via '{flag} "
                        f"{field}=V' but missing from the OPERATIONS.md "
                        f"{flag} knob table — document it",
                        context=f"{flag}.{field}",
                    )
                )
        for knob, line in sorted(knobs.items()):
            if knob not in fields:
                out.append(
                    Diagnostic(
                        doc_path, line, rule_id,
                        f"OPERATIONS.md documents {flag} knob {knob!r} "
                        f"but {cls} has no such field — stale docs or a "
                        f"renamed field",
                        context=f"{flag}.{knob}",
                    )
                )
    # 2. documented flags must exist somewhere (the reference doc's, less
    #    the port's declared exceptions; a stale exception fails too)
    all_flags: Set[str] = set()
    for flags in flags_by_cli.values():
        all_flags |= flags
    for path, flags in ((doc_path, doc_flags), (port_doc_path, port_flags)):
        for flag, line in sorted(flags.items()):
            if flag in all_flags or flag in OVERRIDE_FLAGS or flag in not_defined:
                continue
            out.append(
                Diagnostic(
                    path, line, rule_id,
                    f"{path.rsplit('/', 1)[-1]} mentions {flag} but no "
                    f"entrypoint defines it — broken runbook command",
                    context=flag,
                )
            )
    for flag, line in sorted(not_defined.items()):
        if flag in all_flags or flag not in doc_flags:
            out.append(
                Diagnostic(
                    port_doc_path, line, rule_id,
                    f"stale exception: {flag} is listed as not defined by "
                    f"the port, but "
                    + ("a port entrypoint defines it" if flag in all_flags
                       else "docs/OPERATIONS.md does not mention it")
                    + " — drop the row",
                    context=flag,
                )
            )
    # 3. operator-facing CLI flags must be documented
    for cli in OPERATOR_CLIS:
        for flag in sorted(flags_by_cli.get(cli, ())):
            if flag not in doc_flags and flag not in port_flags:
                out.append(
                    Diagnostic(
                        cli, 0, rule_id,
                        f"{flag} is defined by {cli} but never mentioned "
                        f"in OPERATIONS.md — operators cannot discover "
                        f"it; add it to the topology/debugging sections "
                        f"or the CLI flag table",
                        context=flag,
                    )
                )
    return out


class ConfigCliDriftRule(Rule):
    id = "config-drift"
    summary = (
        "override-reachable config fields and CLI flags match the "
        "OPERATIONS.md tables"
    )

    def paths(self) -> Iterable[str]:
        return (CONFIG_PY, OPERATIONS_MD, PORT_OPERATIONS_MD) + ALL_CLIS

    def check(self, files: Dict[str, FileCtx]) -> List[Diagnostic]:
        cfg = files.get(CONFIG_PY)
        doc = files.get(OPERATIONS_MD)
        if cfg is None or doc is None:
            return []
        port_doc = files.get(PORT_OPERATIONS_MD)
        flags_by_cli = {
            rel: cli_flags(files[rel].source)
            for rel in ALL_CLIS
            if rel in files
        }
        return drift_findings(
            dataclass_fields(cfg.source),
            flags_by_cli,
            doc.source,
            self.id,
            port_doc_text=port_doc.source if port_doc is not None else "",
        )
