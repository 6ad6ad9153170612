"""CLI: ``python -m repro_torch.analysis [paths...] [--audit] [--device
{cuda,cpu}] [--json OUT] [--list-rules]``.

Runs the RPR0xx linter (``analysis/lint.py``) over *paths* (default: the
``repro_torch`` package) and, with ``--audit``, the program audit
(``analysis/audit.py``): the fleet's step and adapt and the engine's
dispatch at the reference's tiny geometry, each body run once and checked
for state written in place, host escapes and 64-bit widening.  The audit
runs on the card unless ``--device cpu`` is given; on the card each entry
is also captured as a CUDA graph and replayed.
Exits 1 on any unwaived finding or failed entry.  ``--json`` writes a
machine-readable report.  The reference's ``--x64`` has no counterpart:
torch's widths are always the ones that run.
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
    print("--x64  (no counterpart) torch's widths are always the ones that run; "
          "the audit's rule (c) checks them")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                     description="the port's RPR0xx lint rules and "
                                                 "program audit")
    parser.add_argument("paths", nargs="*", default=None,
                        help="files/directories to lint (default: the repro_torch package)")
    parser.add_argument("--audit", action="store_true",
                        help="also run the fleet's and the engine's programs and audit "
                             "state written in place, host escapes and 64-bit widening "
                             "(no --x64: torch's widths are always the ones that run)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="device of the audited programs (default: the card, "
                             "raising without one)")
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
    report = {"lint": {"findings": [f.to_dict() for f in findings],
                       "unwaived": len(unwaived), "waived": len(waived)}}
    failed = bool(unwaived)
    if args.audit:
        from repro_torch.analysis.audit import run_audit

        # "cuda" as the default: the current card, raising without one
        audit = run_audit(device="cpu" if args.device == "cpu" else None)
        report["audit"] = audit.to_dict()
        for entry in audit.entries:
            hist = " ".join(f"{t}x{n}" for t, n in sorted(entry.dtype_histogram.items()))
            expected = "-" if entry.expected_in_place is None else entry.expected_in_place
            print(f"audit: [{'ok' if entry.ok else 'FAIL'}] {entry.name}  "
                  f"in_place={entry.in_place}/{expected}  dtypes: {hist}")
            for problem in entry.problems:
                print(f"  - {problem}", file=sys.stderr)
        failed = failed or not audit.ok
    if args.json:
        report["ok"] = not failed
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2)
        print(f"report written to {args.json}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
