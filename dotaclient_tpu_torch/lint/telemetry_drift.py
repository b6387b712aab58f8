"""telemetry-drift pass: code, schema tiers, and docs agree on every key.

Three places claim to know the port's telemetry key set: the code that
emits it (``.counter("...")`` / ``.gauge("...")`` / ``.span("...")`` /
``.timer("span/...")`` sites in ``dotaclient_tpu_torch/``), the tier lists
of ``utils/schema.py`` (the CI contract), and the operator contract: the
docs/ARCHITECTURE.md "Observability" tables, which the port promises as
the JAX package does, plus ``dotaclient_tpu_torch/OPERATIONS.md`` for what
only the port has. They drift independently: a renamed counter silently
orphans its runbook row, a documented key that was never wired ships a
false promise, and the schema check only notices keys it already knows.

The counterpart of the JAX package's ``lint/telemetry_drift.py``. It
extracts all three sets statically and fails on:

* **documented-but-never-emitted** — a key in a schema tier list (or in
  ARCHITECTURE.md) with no emission site in the package, unless the
  port's OPERATIONS.md lists it in its "Reference keys the port does not
  emit" table with the reason;
* **emitted-but-undocumented** — an emission site whose key appears
  nowhere in ARCHITECTURE.md or the port's OPERATIONS.md (span stages may
  be documented bare, e.g. ``actor/collect``, or rooted,
  ``span/actor/collect``);
* **unresolvable emission** — a key built from an expression the
  extractor cannot expand (see below), which would silently escape both
  checks.

Extraction handles the idioms the code uses: literal strings;
``for key in ("a", "b"): ....gauge(key)`` eager-creation loops (the loop
literals are expanded); and f-string keys whose template (the constant
parts with ``{}`` for each hole) is declared in ``DYNAMIC_KEY_EXPANSIONS``
(e.g. ``"snapshot/{}_coalesced"``). Anything else flags: add the expansion
or use a literal. Doc keys support ``{a,b,c}`` brace expansion and
``*``/``<var>`` wildcards (wildcards document families and satisfy
emitted-key lookups; they are not themselves required to be emitted).

``utils/telemetry.py`` (the registry mechanism: its internal key
composition is not an emission) is excluded from extraction.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple, Union

from dotaclient_tpu_torch.lint.core import (
    Diagnostic,
    FileCtx,
    Rule,
    package_py_files,
    table_tokens,
)

PACKAGE = "dotaclient_tpu_torch/"
ARCHITECTURE_MD = "docs/ARCHITECTURE.md"
PORT_OPERATIONS_MD = "dotaclient_tpu_torch/OPERATIONS.md"
SCHEMA_PY = "dotaclient_tpu_torch/utils/schema.py"

# The registry mechanism itself: composes keys generically, emits nothing.
EXCLUDED_FILES = ("dotaclient_tpu_torch/utils/telemetry.py",)

_EMIT_METHODS = ("counter", "gauge", "timer", "span")

_REWARD_TERMS = (
    "xp", "gold", "hp", "enemy_hp", "last_hits", "denies", "kills",
    "deaths", "tower_damage", "own_tower", "win",
)
# utils/fleet.py AGG_SOURCES x AGG_STATS
_AGG_METRICS = (
    "weight_staleness", "env_fps", "reconnects", "corrupt_frames",
    "ship_wait",
)
_AGG_STATS = ("min", "max", "mean")

# Declared expansions for f-string keys: template (the constant parts,
# ``{}`` for each hole) → the values the holes take (a string for one
# hole, a tuple of strings for several). Keep in sync with the emitting
# site's value tuple, named in the comment.
DYNAMIC_KEY_EXPANSIONS: Dict[str, Tuple[Union[str, Tuple[str, ...]], ...]] = {
    # train/snapshot.py: one coalesce counter per job slot kind (_KINDS)
    "snapshot/{}_coalesced": ("publish", "checkpoint", "metrics"),
    # buffer/trajectory_buffer.py _publish_telemetry's gauges
    "buffer/{}": (
        "occupancy", "capacity", "ingested", "dropped_stale",
        "dropped_overflow", "dropped_skew", "dropped_nonfinite",
        "dropped_bounds",
    ),
    # utils/utilization.py ACTOR_PHASES and SERVE_PHASES
    "util/actor/{}": ("env_step", "featurize", "encode", "ship_wait", "other"),
    "util/serve/{}": ("window_wait", "dispatch", "reply", "other"),
    # utils/fleet.py FleetAggregator rollups: fleet/agg/<metric>/<stat>
    # gauges across live peers (AGG_SOURCES x AGG_STATS, the FLEET_KEYS
    # schema tier)
    "fleet/agg/{}": tuple(f"{m}/{s}" for m in _AGG_METRICS for s in _AGG_STATS),
    "fleet/agg/{}/{}": tuple((m, s) for m in _AGG_METRICS for s in _AGG_STATS),
    # utils/fleet.py per-peer mirror keys: fleet/<peer>/<shipped metric>
    # (peer labels are runtime values: representative members here; the
    # family is documented as the `fleet/<peer>/*` wildcard row)
    "fleet/{}/{}": (("a0", "actor/env_steps"),),
    "fleet/{}/env_fps": ("a0",),
    # serve/router.py per-backend session gauges: backend indices are
    # runtime values (representative members); documented as the
    # `router/backend/<i>/sessions` wildcard row
    "router/backend/{}/sessions": ("0", "1"),
    # the outcome plane (outcome/records.py BUCKETS / SIDES / REWARD_TERMS
    # / N_LEN_BUCKETS, the OUTCOME_KEYS schema tier)
    "outcome/episodes/{}": ("vs_scripted", "vs_league", "vs_selfplay"),
    "outcome/wins/{}": ("vs_scripted", "vs_league", "vs_selfplay"),
    "outcome/win_rate/{}": ("vs_scripted", "vs_league", "overall"),
    "outcome/episodes_side/{}": ("radiant", "dire"),
    "outcome/ep_len_hist/{}": tuple(f"{i:02d}" for i in range(12)),
    "outcome/reward_sum/{}": _REWARD_TERMS,
    "outcome/reward/{}": _REWARD_TERMS,
}

# Token shape of a telemetry key in backticked doc text: slash-separated
# lowercase segments, optional {a,b}/<var>/* holes; no dots (dots mean a
# file path or config field, not a key).
_DOC_KEY_RE = re.compile(
    r"^[a-z][a-z0-9_]*(?:/[a-z0-9_{},<>*]+)+$"
)

# Namespaces telemetry keys live in. Doc tokens outside these are
# key-shaped but not keys (rollout leaf names like `obs/hero_id`,
# `carry0/*`) — never treated as documented-telemetry claims. A NEW
# namespace must be added here when its first key is minted.
KEY_PREFIXES = (
    "actor/", "advantage/", "alerts/", "buffer/", "checkpoint/",
    "compile/", "faults/", "fleet/", "fused/", "health/", "league/",
    "learner/", "mem/", "mesh/", "outcome/", "router/", "serve/",
    "shm/", "snapshot/", "span/", "trace/", "transport/", "util/",
)
# single-line inline code only: multi-line matches would mispair across
# ``` fence lines (odd backtick count flips pairing for the whole doc)
_BACKTICK_RE = re.compile(r"`([^`\n]+)`")


# -- emitted-key extraction -------------------------------------------------


def _loop_literal_bindings(func: ast.AST) -> Dict[int, Dict[str, List[str]]]:
    """For every ``for NAME in (<str literals>):`` in ``func`` (a ``for``
    statement or a comprehension's generator), map the loop body's line
    span to {NAME: literals} so a ``.gauge(NAME)`` call inside resolves."""
    out: Dict[int, Dict[str, List[str]]] = {}
    for node in ast.walk(func):
        if isinstance(node, ast.For):
            loops = [(node.target, node.iter)]
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
            loops = [(g.target, g.iter) for g in node.generators]
        else:
            continue
        for target, it in loops:
            if not isinstance(target, ast.Name):
                continue
            lits = _str_literals(it)
            if lits is None:
                continue
            for line in range(node.lineno, (node.end_lineno or node.lineno) + 1):
                out.setdefault(line, {})[target.id] = lits
    return out


def _str_literals(node: ast.AST) -> Optional[List[str]]:
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                out.append(e.value)
            else:
                return None
        return out
    return None


def extract_emitted(
    files: Dict[str, FileCtx],
) -> Tuple[Set[str], List[Tuple[str, int, str]], List[Diagnostic]]:
    """→ (emitted keys, [(key, line, path)] sites, unresolvable-site
    diagnostics). Span/timer keys are normalized to ``span/<stage>``."""
    keys: Set[str] = set()
    sites: List[Tuple[str, int, str]] = []
    problems: List[Diagnostic] = []
    for rel in sorted(files):
        ctx = files[rel]
        if ctx.tree is None or rel in EXCLUDED_FILES:
            continue
        if not rel.startswith(PACKAGE):
            continue
        loop_bindings = _loop_literal_bindings(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if not isinstance(fn, ast.Attribute) or fn.attr not in _EMIT_METHODS:
                continue
            if not node.args:
                continue
            arg = node.args[0]
            resolved = _resolve_key_arg(arg, node.lineno, loop_bindings)
            if resolved is None:
                problems.append(
                    Diagnostic(
                        rel,
                        node.lineno,
                        "telemetry-drift",
                        f".{fn.attr}(...) key is not statically "
                        f"resolvable — use a literal, the "
                        f"for-over-literals idiom, or declare the "
                        f"f-string in DYNAMIC_KEY_EXPANSIONS "
                        f"(lint/telemetry_drift.py)",
                    )
                )
                continue
            for key in resolved:
                if fn.attr == "span":
                    key = f"span/{key}"
                keys.add(key)
                sites.append((key, node.lineno, rel))
    return keys, sites, problems


def _resolve_key_arg(
    arg: ast.AST, line: int, loop_bindings: Dict[int, Dict[str, List[str]]]
) -> Optional[List[str]]:
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return [arg.value]
    if isinstance(arg, ast.Name):
        lits = loop_bindings.get(line, {}).get(arg.id)
        if lits is not None:
            return lits
        return None
    if isinstance(arg, ast.JoinedStr):
        template = "".join(
            str(part.value).replace("{", "{{").replace("}", "}}")
            if isinstance(part, ast.Constant) else "{}"
            for part in arg.values
        )
        values = DYNAMIC_KEY_EXPANSIONS.get(template)
        if values is not None:
            return [
                template.format(*(v if isinstance(v, tuple) else (v,)))
                for v in values
            ]
        return None
    return None


# -- documented-key extraction ----------------------------------------------


def extract_doc_keys(doc_text: str) -> Tuple[Set[str], List[re.Pattern]]:
    """Backticked key tokens in doc text → (exact keys, wildcard
    patterns). ``{a,b}`` expands; ``*`` and ``<var>`` become wildcards."""
    exact: Set[str] = set()
    patterns: List[re.Pattern] = []
    for m in _BACKTICK_RE.finditer(doc_text):
        token = m.group(1).strip()
        if not _DOC_KEY_RE.match(token):
            continue
        if not token.startswith(KEY_PREFIXES):
            continue
        for expanded in _expand_braces(token):
            if "*" in expanded or "<" in expanded:
                rx = re.escape(expanded)
                rx = rx.replace(r"\*", r"[a-z0-9_/]+")
                rx = re.sub(r"<[a-z0-9_\\]+>", r"[a-z0-9_]+", rx)
                patterns.append(re.compile(f"^{rx}$"))
            else:
                exact.add(expanded)
    return exact, patterns


def _expand_braces(token: str) -> List[str]:
    m = re.search(r"\{([^{}]*)\}", token)
    if not m:
        return [token]
    head, tail = token[: m.start()], token[m.end():]
    out: List[str] = []
    for alt in m.group(1).split(","):
        out.extend(_expand_braces(head + alt.strip() + tail))
    return out


def _documented(
    key: str, exact: Set[str], patterns: List[re.Pattern]
) -> bool:
    candidates = [key]
    if key.startswith("span/"):
        candidates.append(key[len("span/"):])  # stages documented bare
    for c in candidates:
        if c in exact or any(p.match(c) for p in patterns):
            return True
    return False


# -- schema tier lists ------------------------------------------------------


def extract_schema_tiers(script_source: str) -> Dict[str, List[str]]:
    """Module-level ``*_KEYS``/``REQUIRED_KEYS`` tuple assignments of the
    schema checker, literal-evaluated (no import)."""
    tree = ast.parse(script_source)
    tiers: Dict[str, List[str]] = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target = node.targets[0]
        if not isinstance(target, ast.Name):
            continue
        if not (target.id.endswith("_KEYS") or target.id == "REQUIRED_KEYS"):
            continue
        try:
            value = ast.literal_eval(node.value)
        except ValueError:
            continue
        if isinstance(value, (tuple, list)):
            tiers[target.id] = [v for v in value if isinstance(v, str)]
    return tiers


_TIMER_LEAVES = ("count", "total_s", "last_s", "mean_s", "ema_s", "p95_s")


def _tier_key_emitted(key: str, emitted: Set[str]) -> bool:
    if key in emitted:
        return True
    # span-leaf form: span/<stage>/<leaf> is emitted iff its root span is
    parts = key.split("/")
    if parts[0] == "span" and parts[-1] in _TIMER_LEAVES:
        return "/".join(parts[:-1]) in emitted
    return False


# -- the pass ---------------------------------------------------------------

# the port's OPERATIONS.md section listing the reference's documented or
# tier-required keys that the port does not emit, each with its reason
NOT_EMITTED_HEADING = "## Reference telemetry keys the port does not emit"


def drift_findings(
    emitted: Set[str],
    sites: List[Tuple[str, int, str]],
    doc_text: str,
    tiers: Dict[str, List[str]],
    rule_id: str = "telemetry-drift",
    doc_path: str = ARCHITECTURE_MD,
    schema_path: str = SCHEMA_PY,
    port_doc_text: str = "",
    port_doc_path: str = PORT_OPERATIONS_MD,
) -> List[Diagnostic]:
    """Pure cross-check (unit-testable: feed synthetic inputs).
    ``port_doc_text`` (the port's OPERATIONS.md) documents keys only the
    port emits, and its NOT_EMITTED_HEADING table the reference keys the
    port does not emit."""
    out: List[Diagnostic] = []
    exact, patterns = extract_doc_keys(doc_text)
    port_exact, port_patterns = extract_doc_keys(port_doc_text)
    not_emitted = table_tokens(port_doc_text, NOT_EMITTED_HEADING)
    for key in not_emitted:
        port_exact.discard(key)
    # 1. schema tiers: documented-but-never-emitted (the CI contract
    #    promises presence the code cannot deliver)
    for tier, keys in sorted(tiers.items()):
        for key in keys:
            if not _tier_key_emitted(key, emitted):
                out.append(
                    Diagnostic(
                        schema_path,
                        0,
                        rule_id,
                        f"{key!r} is required by schema tier {tier} but "
                        f"no emission site exists in the package — the "
                        f"tier would fail every run; fix the emitter or "
                        f"the tier list",
                        context=key,
                    )
                )
    # 2. the docs: documented-but-never-emitted, less the port's declared
    #    exceptions (a stale exception fails too)
    for path, keys in ((doc_path, exact), (port_doc_path, port_exact)):
        for key in sorted(keys):
            if key in emitted or f"span/{key}" in emitted:
                continue
            if path == doc_path and key in not_emitted:
                continue
            out.append(
                Diagnostic(
                    path,
                    0,
                    rule_id,
                    f"{key!r} is documented in {path.rsplit('/', 1)[-1]} "
                    f"but no emission site exists in the package — stale "
                    f"docs or a renamed key",
                    context=key,
                )
            )
    for key, line in sorted(not_emitted.items()):
        if key in emitted or f"span/{key}" in emitted:
            out.append(
                Diagnostic(
                    port_doc_path, line, rule_id,
                    f"stale exception: {key!r} is listed as not emitted "
                    f"by the port, but the package emits it — drop the row",
                    context=key,
                )
            )
        elif key not in exact:
            out.append(
                Diagnostic(
                    port_doc_path, line, rule_id,
                    f"stale exception: {key!r} is listed as not emitted "
                    f"by the port, but ARCHITECTURE.md does not document "
                    f"it — drop the row",
                    context=key,
                )
            )
    # 3. emitted-but-undocumented (one finding per key, at its first site)
    first_site: Dict[str, Tuple[int, str]] = {}
    for key, line, rel in sites:
        first_site.setdefault(key, (line, rel))
    for key in sorted(emitted):
        if _documented(key, exact, patterns) or _documented(
            key, port_exact, port_patterns
        ):
            continue
        line, rel = first_site.get(key, (0, doc_path))
        out.append(
            Diagnostic(
                rel,
                line,
                rule_id,
                f"telemetry key {key!r} is emitted here but absent from "
                f"the docs/ARCHITECTURE.md 'Observability' tables and "
                f"the port's OPERATIONS.md — document it (operators grep "
                f"those tables during incidents) or rename/remove the "
                f"emission",
                context=key,
            )
        )
    return out


class TelemetryDriftRule(Rule):
    id = "telemetry-drift"
    summary = (
        "emitted telemetry keys, schema tier lists, and ARCHITECTURE.md "
        "tables agree"
    )

    def paths(self) -> Iterable[str]:
        return package_py_files() + [ARCHITECTURE_MD, PORT_OPERATIONS_MD]

    def check(self, files: Dict[str, FileCtx]) -> List[Diagnostic]:
        emitted, sites, problems = extract_emitted(files)
        doc = files.get(ARCHITECTURE_MD)
        port_doc = files.get(PORT_OPERATIONS_MD)
        schema = files.get(SCHEMA_PY)
        tiers = (
            extract_schema_tiers(schema.source) if schema is not None else {}
        )
        out = list(problems)
        out.extend(
            drift_findings(
                emitted,
                sites,
                doc.source if doc is not None else "",
                tiers,
                self.id,
                port_doc_text=port_doc.source if port_doc is not None else "",
            )
        )
        return out
