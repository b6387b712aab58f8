"""graftlint CLI for the port: ``python -m dotaclient_tpu_torch.lint [--strict] [--rule ...]``.

Exit 0 when clean (baseline-suppressed findings are reported as a count),
1 when any new finding exists. ``--strict`` ignores the baseline — every
grandfathered finding fails too (CI escalation: ``LINT_STRICT=1`` in the
tier-1 wrapper). ``--update-baseline``
rewrites the baseline to exactly the current findings (each with a
tracking comment) — run it after triaging a new rule's first findings,
never to silence a regression.

Usage:
    python -m dotaclient_tpu_torch.lint                 # all passes, baseline on
    python -m dotaclient_tpu_torch.lint --strict        # baseline off
    python -m dotaclient_tpu_torch.lint --rule host-sync --rule config-drift
    python -m dotaclient_tpu_torch.lint --list-rules
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from dotaclient_tpu_torch.lint import ALL_RULES
from dotaclient_tpu_torch.lint.core import (
    DEFAULT_BASELINE,
    REPO_ROOT,
    baseline_rule,
    load_baseline,
    load_baseline_blocks,
    run_rules,
    write_baseline,
)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dotaclient_tpu_torch.lint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument(
        "--strict", action="store_true",
        help="ignore the baseline: grandfathered findings fail too",
    )
    p.add_argument(
        "--rule", action="append", default=None, metavar="ID",
        help="run only this rule (repeatable); default: all rules",
    )
    p.add_argument(
        "--baseline", type=str, default=None, metavar="PATH",
        help=f"baseline file (default {DEFAULT_BASELINE})",
    )
    p.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite the baseline to the current findings and exit 0",
    )
    p.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit",
    )
    args = p.parse_args(argv)

    if args.list_rules:
        for cls in ALL_RULES:
            print(f"{cls.id:20s} {cls.summary}")
        return 0

    by_id = {cls.id: cls for cls in ALL_RULES}
    if args.rule:
        unknown = [r for r in args.rule if r not in by_id]
        if unknown:
            p.error(
                f"unknown rule(s) {unknown} — one of {sorted(by_id)}"
            )
        rules = [by_id[r]() for r in args.rule]
    else:
        rules = [cls() for cls in ALL_RULES]

    baseline_path = args.baseline or os.path.join(
        REPO_ROOT, DEFAULT_BASELINE
    )
    baseline = load_baseline(baseline_path)
    result = run_rules(
        rules, REPO_ROOT, baseline=baseline, strict=args.strict
    )

    if args.update_baseline:
        entries = [(fp, d) for d, fp in result.new] + [
            (fp, d) for d, fp in result.suppressed
        ]
        # a --rule subset regenerates ONLY its own rules' entries: blocks
        # belonging to rules that did not run are preserved verbatim,
        # tracking comments included — a partial update must never wipe
        # another rule's grandfathered debt
        ran = {r.id for r in rules}
        preserved = [
            (comments, fp)
            for comments, fp in load_baseline_blocks(baseline_path)
            if baseline_rule(fp) not in ran
        ]
        write_baseline(baseline_path, entries, preserved=preserved)
        print(
            f"graftlint: baseline rewritten with {len(entries)} "
            f"finding(s) ({len(preserved)} entr"
            f"{'y' if len(preserved) == 1 else 'ies'} of non-run rules "
            f"preserved) → {os.path.relpath(baseline_path, REPO_ROOT)}"
        )
        return 0

    for diag, _fp in result.new:
        print(diag.format(), file=sys.stderr)
    if result.stale_baseline:
        # informational: fixed findings should leave the baseline too,
        # but a stale entry must not fail CI (line drift, deleted code)
        print(
            f"graftlint: note — {len(result.stale_baseline)} stale "
            f"baseline entr{'y' if len(result.stale_baseline) == 1 else 'ies'} "
            f"(fixed or moved); run --update-baseline to prune",
        )
    ran = ", ".join(r.id for r in rules)
    if result.new:
        counts = ", ".join(
            f"{rid}: {n}" for rid, n in sorted(result.per_rule.items()) if n
        )
        print(
            f"graftlint FAILED ({len(result.new)} finding(s) — {counts}; "
            f"{len(result.suppressed)} baseline-suppressed) "
            f"[rules: {ran}]",
            file=sys.stderr,
        )
        return 1
    print(
        f"graftlint OK: {len(rules)} passes clean "
        f"({len(result.suppressed)} baseline-suppressed) [rules: {ran}]"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
