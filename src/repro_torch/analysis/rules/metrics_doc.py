"""metrics-doc: every metric the port declares is documented in DESIGN.md
§14.

The port's metric surface is declared in exactly three places, as the
JAX package's is (DESIGN.md §14): ``repro_torch.obs.metrics.OBS_METRICS``,
``repro_torch.runtime.ingest.IngestStats._SPEC`` (``ingest.<field>``) and
``repro_torch.runtime.serve_loop.ServeStats._SPEC`` (``serve.<field>``);
every qualified name must appear verbatim in the §14 table so the doc can
never silently drift from the code.

Unlike the AST rules this one IMPORTS the live modules (the specs are
data, not syntax) — which is also why it is repo-scoped and why the
pure comparison core (``missing_metrics``) is split out for the fixture
tests to exercise without the imports.
"""
from __future__ import annotations

import re
import sys
from pathlib import Path

from repro_torch.analysis.framework import Finding, RepoContext, Rule, register

SECTION_RE = re.compile(r"^##\s+§14\b.*?(?=^##\s+§|\Z)", re.M | re.S)


def section_14(design_text: str) -> str:
    m = SECTION_RE.search(design_text)
    return m.group(0) if m else ""


def missing_metrics(names: list[str], design_text: str) -> list[str]:
    """Pure core: declared metric names absent from the §14 section text
    (all of them when the section itself is missing)."""
    sec = section_14(design_text)
    if not sec:
        return sorted(names)
    return sorted(n for n in names if n not in sec)


def declared_metrics(root: Path) -> list[str]:
    src = str(root / "src")
    if src not in sys.path and Path(src).is_dir():
        sys.path.insert(0, src)
    from repro_torch.obs.metrics import OBS_METRICS
    from repro_torch.runtime.ingest import IngestStats
    from repro_torch.runtime.serve_loop import ServeStats

    names = set(OBS_METRICS)
    for view in (IngestStats, ServeStats):
        names.update(view._qual(f) for f in view._SPEC)
    return sorted(names)


def check(ctx: RepoContext) -> list[Finding]:
    design = ctx.root / "DESIGN.md"
    if not design.is_file():
        return [ctx.finding(RULE, design, 0, "DESIGN.md does not exist")]
    text = design.read_text(encoding="utf-8")
    m = SECTION_RE.search(text)
    if not m:
        return [ctx.finding(RULE, design, 0,
                            "DESIGN.md has no `## §14` section — the "
                            "metric table lives there")]
    heading_line = text[:m.start()].count("\n") + 1
    try:
        names = declared_metrics(ctx.root)
    except Exception as e:  # import failure IS a finding, not a crash
        return [ctx.finding(RULE, design, 0,
                            f"could not import the metric specs: {e!r}")]
    return [ctx.finding(RULE, design, heading_line,
                        f"declared metric {n!r} missing from the "
                        f"DESIGN.md §14 table — document it or drop the "
                        f"declaration")
            for n in missing_metrics(names, text)]


RULE = register(Rule(
    name="metrics-doc",
    invariant="every metric declared by the port's OBS_METRICS / "
              "IngestStats._SPEC / ServeStats._SPEC appears verbatim in "
              "DESIGN.md §14",
    check=check,
    scope="repo",
    origin="the JAX package's metric registry (tools/check_metrics_doc.py)",
))
