"""alert-drift pass: the alert rule table and the OPERATIONS.md runbook agree.

The counterpart of the JAX package's ``lint/alert_drift.py`` over the
port's ``utils/alerts.py``. The alert engine encodes the runbook's failure
thresholds as machine-evaluated rules, and every rule carries a mandatory
runbook anchor: a backticked ``rb:<name>`` token in the "Failure modes"
table of docs/OPERATIONS.md, the operator contract the port promises as
the JAX package does (the port has no failure mode of its own: its
``ALERT_WAIVERS`` and ``RULES`` cover the reference's rows). The two
artifacts drift independently: a reworded runbook row
silently orphans the rule that pages on it, and a newly documented
failure mode ships without anyone deciding whether a machine can watch
it. This pass cross-checks BOTH ways, statically (AST + regex, no import
of alerts.py):

* every ``AlertRule.runbook`` anchor must exist in OPERATIONS.md — a
  rule can never point at a deleted runbook row;
* every runbook-table row must carry exactly one ``rb:`` anchor — new
  failure modes cannot dodge the contract;
* every anchor must be referenced by at least one rule OR waived in
  ``ALERT_WAIVERS`` with a reason — a documented failure mode with a
  watchable signal gets a rule or an explicit decision not to;
* waivers must be live: a waived anchor that no longer exists in the
  doc, or that a rule now covers, is stale and fails;
* the "Alert catalog" table mirrors the rule table row-for-row: every
  rule has a catalog row, every catalog row names a real rule;
* every rule's ``key=`` must name a telemetry key SOME port code actually
  emits (statically extracted, the telemetry-drift machinery) — a rule
  watching a renamed or never-wired key is silent forever, which is worse
  than no rule: the runbook row reads as covered. Pattern keys
  (``fleet/*/...``) are exempt — their members are runtime peer labels.

Rule fields must be LITERALS — a computed ``runbook=`` escapes the
cross-check and is flagged as not statically checkable.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Tuple

from dotaclient_tpu_torch.lint.core import Diagnostic, FileCtx, Rule, section_rows

ALERTS_PY = "dotaclient_tpu_torch/utils/alerts.py"
OPERATIONS_MD = "docs/OPERATIONS.md"

_ANCHOR_RE = re.compile(r"`(rb:[a-z0-9-]+)`")
_RULE_NAME_RE = re.compile(r"`([a-z][a-z0-9_]*)`")

FAILURE_MODES_HEADING = "## Failure modes"
ALERT_CATALOG_HEADING = "## Alert catalog"


# -- extraction ---------------------------------------------------------------


def _assigned_value(node: ast.AST, name: str) -> Optional[ast.AST]:
    """The RHS of ``name = ...`` or ``name: T = ...`` (module level or
    not), else None."""
    if (
        isinstance(node, ast.Assign)
        and len(node.targets) == 1
        and isinstance(node.targets[0], ast.Name)
        and node.targets[0].id == name
    ):
        return node.value
    if (
        isinstance(node, ast.AnnAssign)
        and isinstance(node.target, ast.Name)
        and node.target.id == name
    ):
        return node.value
    return None


def extract_rules(
    tree: ast.AST, path: str = ALERTS_PY
) -> Tuple[List[Dict[str, object]], List[Diagnostic]]:
    """AST-extract the ``RULES`` tuple's ``AlertRule(...)`` entries as
    ``{"name", "runbook", "line"}`` dicts. Non-literal name/runbook
    fields flag — they would silently escape the cross-check."""
    rules: List[Dict[str, object]] = []
    problems: List[Diagnostic] = []
    for node in ast.walk(tree):
        value = _assigned_value(node, "RULES")
        if value is None:
            continue
        elts = value.elts if isinstance(value, (ast.Tuple, ast.List)) else []
        for call in elts:
            if not (
                isinstance(call, ast.Call)
                and isinstance(call.func, ast.Name)
                and call.func.id == "AlertRule"
            ):
                continue
            fields: Dict[str, object] = {"line": call.lineno}
            # positional arg 0 is `name` by the dataclass layout
            if call.args and isinstance(call.args[0], ast.Constant):
                fields["name"] = call.args[0].value
            for kw in call.keywords:
                if kw.arg in ("name", "runbook", "key") and isinstance(
                    kw.value, ast.Constant
                ):
                    fields[kw.arg] = kw.value.value
            for required in ("name", "runbook"):
                if not isinstance(fields.get(required), str):
                    problems.append(
                        Diagnostic(
                            path,
                            call.lineno,
                            "alert-drift",
                            f"AlertRule {required}= is not a string "
                            f"literal — the rules↔runbook cross-check "
                            f"cannot see it; use a literal",
                        )
                    )
            if isinstance(fields.get("name"), str) and isinstance(
                fields.get("runbook"), str
            ):
                rules.append(fields)
    return rules, problems


def extract_waivers(tree: ast.AST) -> Dict[str, str]:
    """Literal-eval the ``ALERT_WAIVERS`` dict (anchor → reason)."""
    for node in ast.walk(tree):
        value = _assigned_value(node, "ALERT_WAIVERS")
        if value is not None:
            try:
                return dict(ast.literal_eval(value))
            except (ValueError, SyntaxError):
                return {}
    return {}


def runbook_anchors(doc: str) -> Tuple[Dict[str, int], List[Diagnostic]]:
    """Anchors (→ line) of the Failure-modes table, plus a diagnostic per
    row that carries none — every failure mode must enter the contract."""
    anchors: Dict[str, int] = {}
    problems: List[Diagnostic] = []
    for line_no, row in section_rows(doc, FAILURE_MODES_HEADING):
        found = _ANCHOR_RE.findall(row)
        if not found:
            problems.append(
                Diagnostic(
                    OPERATIONS_MD,
                    line_no,
                    "alert-drift",
                    "runbook row carries no `rb:<anchor>` token — every "
                    "documented failure mode needs an anchor so the alert "
                    "table (utils/alerts.py RULES) or its waiver list can "
                    "reference it",
                    context=row[:60],
                )
            )
            continue
        for a in found:
            anchors.setdefault(a, line_no)
    return anchors, problems


def catalog_rule_names(doc: str) -> Dict[str, int]:
    """First backticked token of each Alert-catalog row → line no."""
    out: Dict[str, int] = {}
    for line_no, row in section_rows(doc, ALERT_CATALOG_HEADING):
        m = _RULE_NAME_RE.search(row)
        if m:
            out.setdefault(m.group(1), line_no)
    return out


def rule_key_findings(
    rules: List[Dict[str, object]],
    emitted: "set[str]",
    rule_id: str = "alert-drift",
) -> List[Diagnostic]:
    """Every non-pattern rule key must be an emitted telemetry key
    : a rule over a ghost key can never fire, silently
    un-watching its runbook row."""
    out: List[Diagnostic] = []
    for r in rules:
        key = r.get("key")
        if not isinstance(key, str):
            continue
        if any(ch in key for ch in "*?["):
            continue  # runtime-labeled families (per-peer mirrors)
        if key not in emitted:
            out.append(
                Diagnostic(
                    ALERTS_PY, int(r["line"]), rule_id,  # type: ignore[arg-type]
                    f"rule {r['name']!r} watches telemetry key {key!r} "
                    f"but no emission site exists in the package — the "
                    f"rule can never fire; fix the key or the emitter",
                    context=key,
                )
            )
    return out


# -- the cross-check ----------------------------------------------------------


def drift_findings(
    rules: List[Dict[str, object]],
    waivers: Dict[str, str],
    doc: str,
    rule_id: str = "alert-drift",
) -> List[Diagnostic]:
    """Pure cross-check (unit-testable: feed a doctored doc)."""
    out: List[Diagnostic] = []
    anchors, row_problems = runbook_anchors(doc)
    out.extend(row_problems)
    referenced = set()
    seen_names: Dict[str, int] = {}
    for r in rules:
        name, anchor, line = str(r["name"]), str(r["runbook"]), int(r["line"])  # type: ignore[arg-type]
        if name in seen_names:
            out.append(
                Diagnostic(
                    ALERTS_PY, line, rule_id,
                    f"duplicate alert rule name {name!r} (first at line "
                    f"{seen_names[name]}) — rule names key the catalog "
                    f"and the event stream",
                )
            )
        seen_names.setdefault(name, line)
        referenced.add(anchor)
        if anchor not in anchors:
            out.append(
                Diagnostic(
                    ALERTS_PY, line, rule_id,
                    f"rule {name!r} points at runbook anchor {anchor!r} "
                    f"which does not exist in the docs/OPERATIONS.md "
                    f"'Failure modes' table — the row was deleted or "
                    f"renamed; fix the anchor or restore the row",
                    context=anchor,
                )
            )
    for anchor, line_no in sorted(anchors.items()):
        if anchor in referenced:
            if anchor in waivers:
                out.append(
                    Diagnostic(
                        ALERTS_PY, 0, rule_id,
                        f"stale waiver: anchor {anchor!r} is waived in "
                        f"ALERT_WAIVERS but a rule now covers it — delete "
                        f"the waiver",
                        context=anchor,
                    )
                )
            continue
        if anchor not in waivers:
            out.append(
                Diagnostic(
                    OPERATIONS_MD, line_no, rule_id,
                    f"documented failure mode {anchor!r} has neither an "
                    f"alert rule (utils/alerts.py RULES) nor an explicit "
                    f"ALERT_WAIVERS entry naming why it is not "
                    f"machine-watchable",
                    context=anchor,
                )
            )
    for anchor in sorted(waivers):
        if anchor not in anchors:
            out.append(
                Diagnostic(
                    ALERTS_PY, 0, rule_id,
                    f"stale waiver: ALERT_WAIVERS entry {anchor!r} matches "
                    f"no anchor in the docs/OPERATIONS.md 'Failure modes' "
                    f"table",
                    context=anchor,
                )
            )
    # the Alert catalog mirrors the rule table row-for-row
    catalog = catalog_rule_names(doc)
    for r in rules:
        name = str(r["name"])
        if name not in catalog:
            out.append(
                Diagnostic(
                    OPERATIONS_MD, 0, rule_id,
                    f"alert rule {name!r} has no row in the "
                    f"docs/OPERATIONS.md 'Alert catalog' table — operators "
                    f"grep that table during incidents",
                    context=name,
                )
            )
    for name, line_no in sorted(catalog.items()):
        if name not in seen_names:
            out.append(
                Diagnostic(
                    OPERATIONS_MD, line_no, rule_id,
                    f"'Alert catalog' row names rule {name!r} which does "
                    f"not exist in utils/alerts.py RULES — stale docs or a "
                    f"renamed rule",
                    context=name,
                )
            )
    return out


class AlertDriftRule(Rule):
    id = "alert-drift"
    summary = (
        "alert rules and the OPERATIONS.md runbook/catalog agree both ways"
    )

    def paths(self) -> Iterable[str]:
        from dotaclient_tpu_torch.lint.core import package_py_files

        # the whole package: rule keys are validated against the
        # statically-extracted emitted-key set (rule_key_findings)
        return [ALERTS_PY, OPERATIONS_MD] + package_py_files()

    def check(self, files: Dict[str, FileCtx]) -> List[Diagnostic]:
        from dotaclient_tpu_torch.lint.telemetry_drift import extract_emitted

        alerts = files.get(ALERTS_PY)
        doc = files.get(OPERATIONS_MD)
        if alerts is None or alerts.tree is None:
            return []
        rules, problems = extract_rules(alerts.tree)
        waivers = extract_waivers(alerts.tree)
        out = list(problems)
        out.extend(
            drift_findings(
                rules, waivers, doc.source if doc is not None else "", self.id
            )
        )
        # unresolvable-emission diagnostics belong to telemetry-drift;
        # here the extraction only feeds the rule-key existence check
        emitted, _sites, _problems = extract_emitted(files)
        out.extend(rule_key_findings(rules, emitted, self.id))
        return out
