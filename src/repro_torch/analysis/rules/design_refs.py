"""design-refs: every ``DESIGN.md §N`` citation in the port's files
resolves (DESIGN.md §15).

The port's docstrings cite the design document by section, as the JAX
package's do (``DESIGN.md §4``, ``DESIGN.md §5(ii)``, ...); a citation of
a section that does not exist means either the code drifted or the doc
did — both are diff-time errors:

  * ``§N``      -> a ``## §N`` heading must exist;
  * ``§N(sub)`` -> a ``### §N(sub)`` heading, or ``## §N`` plus the
    literal ``§N(sub)`` anywhere in the doc.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Optional

from repro_torch.analysis.framework import FileContext, Finding, Rule, register

CITE = re.compile(r"DESIGN\.md\s+(§\d+(?:\([a-z]+\))?)")
HEADING = re.compile(r"^#{2,3}\s+(§\d+(?:\([a-z]+\))?)(?=[\s—-]|$)", re.M)

# per-root cache: root -> (headings, full text), or None when DESIGN.md is
# missing
_CACHE: dict[Path, Optional[tuple[set, str]]] = {}


def _design(root: Path) -> Optional[tuple[set, str]]:
    if root not in _CACHE:
        path = root / "DESIGN.md"
        if not path.is_file():
            _CACHE[root] = None
        else:
            text = path.read_text(encoding="utf-8")
            _CACHE[root] = (set(HEADING.findall(text)), text)
    return _CACHE[root]


def check(ctx: FileContext) -> list[Finding]:
    doc = _design(ctx.root)
    out: list[Finding] = []
    for lineno, line in enumerate(ctx.lines, 1):
        for ref in CITE.findall(line):
            if doc is None:
                out.append(ctx.finding(
                    RULE, lineno,
                    f"cites DESIGN.md {ref} but DESIGN.md does not exist"))
                continue
            headings, text = doc
            base = ref.split("(")[0]
            ok = ref in headings or (
                "(" in ref and base in headings and ref in text)
            if not ok:
                out.append(ctx.finding(
                    RULE, lineno,
                    f"cites DESIGN.md {ref} but no such section heading — "
                    f"the code or the doc drifted"))
    return out


RULE = register(Rule(
    name="design-refs",
    invariant="every DESIGN.md §N citation in the port's files resolves "
              "to a real section heading",
    check=check,
    origin="the JAX package's docs gate (tools/check_design_refs.py)",
))
