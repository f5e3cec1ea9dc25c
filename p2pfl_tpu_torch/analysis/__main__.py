"""CLI gate: ``python -m p2pfl_tpu_torch.analysis [paths…]`` — nonzero on new findings.

Exit codes: 0 clean (or every error finding baselined / suppressed),
1 new error findings, 2 usage error. ``--update-baseline`` rewrites the
baseline to accept the current tree (review the diff — the baseline is
committed debt, and inline ``# p2pfl: allow(rule-id)`` pragmas with a
justification are preferred for deliberate exceptions).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Sequence

from p2pfl_tpu_torch.analysis.engine import analyze, load_baseline, new_findings, write_baseline
from p2pfl_tpu_torch.analysis.findings import Severity

DEFAULT_BASELINE = ".p2pfl-check-baseline.json"


def _rules():
    from p2pfl_tpu_torch.analysis.rules import ALL_RULES

    return ALL_RULES


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m p2pfl_tpu_torch.analysis",
        description="p2pfl-check: enforce the port's concurrency, merge, wire and host-gather contracts",
    )
    parser.add_argument("paths", nargs="*", default=["p2pfl_tpu_torch"], help="files/dirs to analyze")
    parser.add_argument(
        "--baseline",
        default=None,
        help=f"baseline file of accepted findings (default: {DEFAULT_BASELINE} if present)",
    )
    parser.add_argument(
        "--update-baseline",
        action="store_true",
        help=(
            "REWRITE the baseline from this run's findings (run it over the "
            "full tree — a narrowed run would drop accepted entries; "
            "incompatible with --select for the same reason)"
        ),
    )
    parser.add_argument(
        "--select", default=None, help="comma-separated rule ids to run (default: all)"
    )
    parser.add_argument("--list-rules", action="store_true", help="print the rule registry and exit")
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)

    rules = list(_rules())
    if args.list_rules:
        for rule in rules:
            print(f"{rule.id:20s} {rule.summary}")
        return 0
    if args.select and args.update_baseline:
        # a rule-filtered run sees a SUBSET of findings; rewriting the
        # baseline from it would silently drop every other rule's
        # accepted entries and re-gate them on the next full run
        print("--update-baseline requires a full-rule run (drop --select)", file=sys.stderr)
        return 2
    if args.select:
        wanted = {tok.strip() for tok in args.select.split(",") if tok.strip()}
        unknown = wanted - {r.id for r in rules}
        if unknown:
            print(f"unknown rule id(s): {', '.join(sorted(unknown))}", file=sys.stderr)
            return 2
        rules = [r for r in rules if r.id in wanted]

    missing = [p for p in args.paths if not os.path.exists(p)]
    if missing:
        print(f"no such path: {', '.join(missing)}", file=sys.stderr)
        return 2

    findings = analyze(args.paths, rules)

    baseline_path = args.baseline
    if baseline_path is None and os.path.exists(DEFAULT_BASELINE):
        baseline_path = DEFAULT_BASELINE
    if args.update_baseline:
        path = baseline_path or DEFAULT_BASELINE
        write_baseline(path, findings)
        print(f"p2pfl-check: wrote {len(findings)} finding(s) to {path}")
        return 0
    baseline = load_baseline(baseline_path) if baseline_path else {}
    fresh = new_findings(findings, baseline)
    gating: List = [f for f in fresh if f.severity is Severity.ERROR]

    if args.json:
        print(
            json.dumps(
                [
                    {
                        "rule": f.rule,
                        "path": f.path,
                        "line": f.line,
                        "col": f.col,
                        "severity": f.severity.value,
                        "message": f.message,
                        "fingerprint": f.fingerprint,
                        "baselined": f.fingerprint in baseline,
                    }
                    for f in findings
                ],
                indent=2,
            )
        )
    else:
        for f in fresh:
            print(f.format())
    baselined = len(findings) - len(fresh)
    print(
        f"p2pfl-check: {len(findings)} finding(s) "
        f"({baselined} baselined, {len(fresh)} new, {len(gating)} gating) "
        f"over {len(rules)} rule(s)",
        file=sys.stderr,
    )
    return 1 if gating else 0


if __name__ == "__main__":
    sys.exit(main())
