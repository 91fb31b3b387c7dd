"""CLI of the port's invariant linter: ``python -m repro_torch.analysis``
(DESIGN.md §15).

Exit status is the gate: 0 when no live findings, 1 otherwise. ``--json``
emits the machine-readable result; explicit
PATH arguments bypass the per-rule default filters (how the fixture tests
point one rule at one deliberately-bad file).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis import framework


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's invariant linter + CUDA kernel sanitizer")
    p.add_argument("paths", nargs="*", type=Path,
                   help="explicit files to scan (default: the standard "
                        "root walk; explicit paths bypass per-rule scopes)")
    p.add_argument("--root", type=Path, default=Path.cwd(),
                   help="repo root (default: cwd)")
    p.add_argument("--rule", action="append", dest="rules", metavar="NAME",
                   help="run only this rule (repeatable)")
    p.add_argument("--json", action="store_true",
                   help="emit the machine-readable result on stdout")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule table and exit")
    return p


def _list_rules() -> int:
    for rule in framework.all_rules():
        scope = f"{rule.scope}-scoped"
        origin = f" [{rule.origin}]" if rule.origin else ""
        print(f"{rule.name:24s} ({rule.severity}, {scope}){origin}\n"
              f"    {rule.invariant}")
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        return _list_rules()

    rules = None
    if args.rules:
        rules = [framework.get_rule(n) for n in args.rules]

    result = framework.run(args.root, paths=args.paths or None,
                           rules=rules)

    if args.json:
        print(json.dumps(result.to_json(), indent=2))
    else:
        for f in result.findings:
            print(f.render())
        parts = [f"{result.files_scanned} files",
                 f"{len(result.rules_run)} rules",
                 f"{len(result.findings)} findings"]
        if result.suppressed:
            parts.append(f"{len(result.suppressed)} suppressed")
        status = "ok" if result.ok else "FAIL"
        print(f"repro_torch.analysis: {', '.join(parts)} — {status}",
              file=sys.stderr if not result.ok else sys.stdout)
    return 0 if result.ok else 1


if __name__ == "__main__":  # pragma: no cover - exercised via __main__
    sys.exit(main())
