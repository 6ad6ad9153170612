"""CLI: ``python -m repro_torch.analysis [paths...] [--json OUT] [--list-rules]``.

Runs the RPR0xx linter (``analysis/lint.py``) over *paths* (default: the
``repro_torch`` package) and exits 1 on any unwaived finding.  ``--json``
writes a machine-readable report.  The reference's ``--audit`` (its HLO
audit) has no counterpart.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis.lint import NOT_PORTED, RULES, lint_paths

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _print_rules() -> None:
    for code, desc in sorted(RULES.items()):
        print(f"{code}  {desc}")
    for code, why in sorted(NOT_PORTED.items()):
        print(f"{code}  (no counterpart) {why}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                     description="the port's RPR0xx lint rules")
    parser.add_argument("paths", nargs="*", default=None,
                        help="files/directories to lint (default: the repro_torch package)")
    parser.add_argument("--json", metavar="OUT", default=None,
                        help="write a machine-readable JSON report")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the RPR0xx rule table and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        _print_rules()
        return 0
    findings = lint_paths(args.paths or [PACKAGE])
    unwaived = [f for f in findings if not f.waived]
    waived = [f for f in findings if f.waived]
    for f in unwaived:
        print(f, file=sys.stderr)
    for f in waived:
        print(f)
    print(f"lint: {len(unwaived)} unwaived finding(s), {len(waived)} waived")
    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump({"lint": {"findings": [f.to_dict() for f in findings],
                                "unwaived": len(unwaived), "waived": len(waived)},
                       "ok": not unwaived}, fh, indent=2)
        print(f"report written to {args.json}")
    return 1 if unwaived else 0


if __name__ == "__main__":
    raise SystemExit(main())
