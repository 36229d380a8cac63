"""``python -m repro_torch.devtools.replint`` — CLI for the invariant linter.

Exit codes: 0 clean, 1 findings, 2 usage error. ``--json`` emits a
machine-readable document (schema below); the default human format is
one ``path:line:col: [rule] message`` per finding plus per-rule counts.

JSON schema::

    {"findings": [{"rule": str, "path": str, "line": int,
                   "col": int, "message": str}, ...],
     "counts": {rule: int, ...},       # only rules with findings
     "files_scanned": int}
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.devtools.replint.core import RULES, lint_paths, rule_names


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.devtools.replint",
        description="AST-based invariant linter for this repo "
                    "(DESIGN.md §13)")
    p.add_argument("paths", nargs="*",
                   help="files or directories to lint")
    p.add_argument("--select", metavar="RULES", default=None,
                   help="comma-separated rule names to run "
                        "(default: all)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit JSON instead of human-readable output")
    p.add_argument("--list-rules", action="store_true",
                   help="list available rules and exit")
    p.add_argument("--design", metavar="PATH", default=None,
                   help="DESIGN.md to resolve §N citations against "
                        "(default: nearest DESIGN.md up from each file)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    parser = _build_parser()
    args = parser.parse_args(argv)
    names = rule_names()

    if args.list_rules:
        for name in names:
            print(f"{name:14s} {RULES[name][1]}")
        return 0

    if not args.paths:
        print("error: no paths given (try: "
              "python -m repro_torch.devtools.replint src/)", file=sys.stderr)
        return 2

    select = None
    if args.select is not None:
        select = [r.strip() for r in args.select.split(",") if r.strip()]
        unknown = [r for r in select if r not in names]
        if unknown or not select:
            print(f"error: unknown rule(s) {', '.join(unknown) or '<none>'}"
                  f"; available: {', '.join(names)}", file=sys.stderr)
            return 2

    findings, n_files = lint_paths(args.paths, select=select,
                                   design=args.design)
    counts: dict = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1

    if args.as_json:
        doc = {"findings": [f.to_json() for f in findings],
               "counts": counts, "files_scanned": n_files}
        print(json.dumps(doc, indent=2, sort_keys=True))
    else:
        for f in findings:
            print(f.render())
        if findings:
            per_rule = ", ".join(f"{r}: {n}" for r, n in sorted(counts.items()))
            print(f"\nreplint: {len(findings)} finding(s) in {n_files} "
                  f"file(s) — {per_rule}")
        else:
            print(f"replint: clean ({n_files} file(s) scanned)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
