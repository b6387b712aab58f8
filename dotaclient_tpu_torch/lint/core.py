"""graftlint core: shared file walker, diagnostics, waivers, baseline.

The framework behind ``python -m dotaclient_tpu_torch.lint``, a copy of the
JAX package's ``lint/core.py`` with the port's package and baseline as its
defaults. The disciplines the learner's performance and correctness rest
on — the host-sync-free hot path, per-thread state ownership, the
documented telemetry/config contracts — regress silently:
nothing crashes when they break, things just get slow, corrupt, or
undocumented. Each discipline is therefore a *pass* (a :class:`Rule`) over
a shared single-parse AST walk, and every finding is either fixed,
consciously waived at the line, or grandfathered in the committed baseline.

Vocabulary:

* **Diagnostic** — one finding: ``file:line rule-id message``.
* **Waiver** — ``# lint-ok: <rule>(<why>)`` on the finding's line or the
  line above. The why is mandatory: a waiver is a reviewed decision, not a
  mute button. (The host-sync pass additionally honors its historical
  ``# host-sync-ok: <why>`` spelling — see
  :mod:`dotaclient_tpu_torch.lint.host_sync`.)
* **Baseline** — ``dotaclient_tpu_torch/lint/baseline.txt``: fingerprints of
  grandfathered findings (each with a tracking comment). Non-strict runs
  suppress them; ``--strict`` does not. Fingerprints hash the *stripped
  source line text* (plus rule id and context), not the line number, so
  unrelated edits above a finding do not invalidate the baseline.
* **Rule** — a pass. It declares the repo-relative ``paths`` it wants;
  the runner parses each file once into a :class:`FileCtx` and hands every
  rule the same map (the shared walker), so N rules cost one parse per
  file.

Rules live in their own modules and register in ``ALL_RULES``
(``__init__``). They must stay import-light — no torch, no numpy — because
the tier-1 wrapper (``tests/test_torch_lint.py``) runs the full lint
in-process on every test run.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

# the conscious-override escape hatch: rule-scoped, why mandatory (the
# lookahead requires the why to start on the marker line; it may continue
# onto following comment lines — waived() walks contiguous comment blocks)
LINT_OK_RE = re.compile(r"#\s*lint-ok:\s*([a-z0-9-]+)\s*\((?=[^)\s])")

DEFAULT_BASELINE = "dotaclient_tpu_torch/lint/baseline.txt"


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding. ``context`` disambiguates the fingerprint when two
    findings share a source line (e.g. a function name or telemetry key);
    it is part of the baseline identity, never of the display."""

    path: str          # repo-relative, forward slashes
    line: int          # 1-based; 0 for whole-file/doc-level findings
    rule: str          # rule id (kebab-case)
    message: str
    context: str = ""

    def format(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.message}"


class FileCtx:
    """One parsed file, shared by every pass: source, lines, AST (``None``
    for non-Python files), and the ``# lint-ok`` waiver map."""

    def __init__(self, path: str, source: str) -> None:
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree: Optional[ast.AST] = None
        if path.endswith(".py"):
            self.tree = ast.parse(source, path)
        self.lint_ok: Dict[int, Set[str]] = {}
        for i, text in enumerate(self.lines, 1):
            for m in LINT_OK_RE.finditer(text):
                self.lint_ok.setdefault(i, set()).add(m.group(1))

    def waived(self, line: int, rule: str) -> bool:
        """True when ``line`` carries a ``# lint-ok: <rule>(<why>)``
        waiver, or the contiguous comment block directly above it does
        (multi-line whys are encouraged — the why is the point)."""
        if rule in self.lint_ok.get(line, ()):
            return True
        k = line - 1
        while k >= 1 and self.line_text(k).lstrip().startswith("#"):
            if rule in self.lint_ok.get(k, ()):
                return True
            k -= 1
        return False

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1]
        return ""


class Rule:
    """Base class for a pass. Subclasses set ``id``/``summary``, list the
    repo-relative files they scan in :meth:`paths`, and emit diagnostics
    from :meth:`check`. The runner handles waivers and the baseline."""

    id: str = ""
    summary: str = ""

    def paths(self) -> Iterable[str]:
        raise NotImplementedError

    def check(self, files: Dict[str, FileCtx]) -> List[Diagnostic]:
        raise NotImplementedError


def package_py_files(
    root: str = REPO_ROOT, package: str = "dotaclient_tpu_torch"
) -> List[str]:
    """Every .py file of the package, repo-relative, sorted — the default
    scan set for package-wide passes. Generated code is excluded (protos)."""
    out: List[str] = []
    for dirpath, dirnames, filenames in os.walk(os.path.join(root, package)):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in sorted(filenames):
            if not f.endswith(".py") or f.endswith("_pb2.py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), root)
            out.append(rel.replace(os.sep, "/"))
    return sorted(out)


def fingerprint(diag: Diagnostic, ctx: Optional[FileCtx]) -> str:
    """Baseline identity of a finding: path | rule | hash of (rule, the
    stripped source line, context). Line-number-free, so edits elsewhere
    in the file do not churn the baseline."""
    basis = diag.message
    if ctx is not None and diag.line:
        text = ctx.line_text(diag.line).strip()
        if text:
            basis = text
    h = hashlib.sha1(
        f"{diag.rule}|{basis}|{diag.context}".encode()
    ).hexdigest()[:12]
    return f"{diag.path}|{diag.rule}|{h}"


def load_baseline(path: str) -> List[str]:
    """Fingerprint lines (comments/blanks skipped); [] for a missing file."""
    return [fp for _comments, fp in load_baseline_blocks(path)]


def load_baseline_blocks(path: str) -> List[Tuple[List[str], str]]:
    """The baseline as (comment-lines, fingerprint) blocks, preserving
    each entry's tracking comment — the unit ``--update-baseline`` must
    keep intact for entries whose rule did not run."""
    if not os.path.exists(path):
        return []
    blocks: List[Tuple[List[str], str]] = []
    pending: List[str] = []
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line:
                pending = []
                continue
            if line.startswith("#"):
                pending.append(line)
                continue
            blocks.append((pending, line))
            pending = []
    return blocks


def baseline_rule(fp: str) -> str:
    """Rule id a fingerprint belongs to ('' for malformed lines)."""
    parts = fp.split("|")
    return parts[1] if len(parts) == 3 else ""


def write_baseline(
    path: str,
    entries: Sequence[Tuple[str, Diagnostic]],
    preserved: Sequence[Tuple[List[str], str]] = (),
) -> None:
    """Rewrite the baseline: one tracking comment + fingerprint per
    grandfathered finding (``--update-baseline``). ``preserved`` blocks
    (entries of rules that did not run, with their original comments)
    are kept verbatim ahead of the regenerated entries."""
    with open(path, "w") as f:
        f.write(
            "# graftlint baseline — grandfathered findings "
            "(python -m dotaclient_tpu_torch.lint --update-baseline).\n"
            "# Each entry is a fingerprint (path|rule|hash of the source "
            "line) preceded by a\n"
            "# tracking comment; fix the finding and drop its entry. "
            "--strict ignores this file.\n"
        )
        for comments, fp in preserved:
            f.write("\n")
            for c in comments:
                f.write(c + "\n")
            f.write(fp + "\n")
        for fp, diag in sorted(entries, key=lambda e: e[0]):
            f.write(f"\n# TRACKING: {diag.format()}\n{fp}\n")


@dataclasses.dataclass
class LintResult:
    new: List[Tuple[Diagnostic, str]]          # (diag, fingerprint)
    suppressed: List[Tuple[Diagnostic, str]]   # baseline-matched
    stale_baseline: List[str]                  # baselined but no longer found
    per_rule: Dict[str, int]                   # new findings per rule id

    @property
    def failed(self) -> bool:
        return bool(self.new)


def run_rules(
    rules: Sequence[Rule],
    root: str = REPO_ROOT,
    baseline: Optional[Sequence[str]] = None,
    strict: bool = False,
) -> LintResult:
    """The shared walker + runner: parse each requested file once, run
    every rule, apply waivers, then split findings against the baseline.
    ``strict`` disables baseline suppression (waivers still apply — they
    are in-code, reviewed decisions; the baseline is the debt list)."""
    files: Dict[str, FileCtx] = {}
    for rule in rules:
        for rel in rule.paths():
            if rel in files:
                continue
            path = os.path.join(root, rel)
            if not os.path.exists(path):
                continue  # a rule's target may not exist in a pruned tree
            with open(path) as f:
                files[rel] = FileCtx(rel, f.read())
    baseline_set = set(baseline or ())
    matched: Set[str] = set()
    new: List[Tuple[Diagnostic, str]] = []
    suppressed: List[Tuple[Diagnostic, str]] = []
    per_rule: Dict[str, int] = {r.id: 0 for r in rules}
    for rule in rules:
        for diag in rule.check(files):
            ctx = files.get(diag.path)
            if ctx is not None and diag.line and ctx.waived(diag.line, rule.id):
                continue
            fp = fingerprint(diag, ctx)
            if not strict and fp in baseline_set:
                matched.add(fp)
                suppressed.append((diag, fp))
                continue
            per_rule[rule.id] += 1
            new.append((diag, fp))
    # an entry is stale only when its OWN rule ran and no longer produces
    # it — a --rule subset run must not report other rules' entries
    ran = {r.id for r in rules}
    stale = (
        sorted(
            fp
            for fp in baseline_set - matched
            if fp.split("|")[1:2] and fp.split("|")[1] in ran
        )
        if not strict
        else []
    )
    return LintResult(
        new=new, suppressed=suppressed, stale_baseline=stale, per_rule=per_rule
    )


# -- shared AST helpers (used by several passes) ---------------------------


def dotted_name(node: ast.AST) -> Optional[str]:
    """``self.state.params`` → "self.state.params"; None for anything that
    is not a plain Name/Attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def assign_targets(stmt: ast.stmt) -> List[str]:
    """Dotted names a statement (re)binds, tuple targets flattened."""
    targets: List[ast.expr] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    out: List[str] = []

    def _flatten(t: ast.expr) -> None:
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                _flatten(e)
        else:
            name = dotted_name(t)
            if name:
                out.append(name)

    for t in targets:
        _flatten(t)
    return out


def section_rows(doc: str, heading: str) -> List[Tuple[int, str]]:
    """Table body rows (1-based line no, text) of the markdown section
    under the ``## `` heading that starts with ``heading``: header and
    ``|---|`` separator rows skipped."""
    rows: List[Tuple[int, str]] = []
    in_section = False
    seen_table_lines = 0
    for i, line in enumerate(doc.splitlines(), 1):
        stripped = line.strip()
        if stripped.startswith("## "):
            in_section = stripped.startswith(heading)
            seen_table_lines = 0
            continue
        if not in_section or not stripped.startswith("|"):
            continue
        seen_table_lines += 1
        if seen_table_lines <= 2:
            continue   # header + separator
        rows.append((i, stripped))
    return rows


_FIRST_TOKEN_RE = re.compile(r"`([^`\n]+)`")


def table_tokens(doc: str, heading: str) -> Dict[str, int]:
    """The first backticked token of each row of the section's tables →
    its line number."""
    out: Dict[str, int] = {}
    for line_no, row in section_rows(doc, heading):
        m = _FIRST_TOKEN_RE.search(row)
        if m:
            out.setdefault(m.group(1).strip(), line_no)
    return out
