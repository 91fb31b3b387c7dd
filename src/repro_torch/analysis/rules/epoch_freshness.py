"""epoch-freshness: index label reads flow through freshness validation
(DESIGN.md §9, §13, §15).

The 2-hop label matrices are only meaningful at the epoch they were built
from; ``index/freshness.py`` owns the validation (live version-vector
compare, epoch-ring pinning, BFS fallback). A consumer that imports
``repro_torch.index.query`` directly — or calls ``query_reach`` /
``reach_counts`` outside the index package — serves answers with no
staleness story at all: exactly the silent-stale-read class the
freshness layer exists to kill. Consumers use ``reach_session`` /
``reach_counts_session`` / ``index_fresh`` instead.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import astutil
from repro_torch.analysis.framework import FileContext, Finding, Rule, register

# the raw-label surface only index/ itself may touch
RAW_CALLS = ("query_reach", "reach_counts")
RAW_MODULE = "repro_torch.index.query"
INDEX_PKG = "src/repro_torch/index/"


def check(ctx: FileContext) -> list[Finding]:
    if ctx.relpath.startswith(INDEX_PKG):
        return []
    out: list[Finding] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod == RAW_MODULE or (mod == "repro_torch.index"
                                     and any(a.name == "query"
                                             for a in node.names)):
                out.append(ctx.finding(
                    RULE, node,
                    f"direct import of {RAW_MODULE} outside the index "
                    f"package — label reads must flow through "
                    f"index/freshness.py (reach_session / "
                    f"reach_counts_session / index_fresh), which owns "
                    f"epoch validation (DESIGN.md §9)"))
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == RAW_MODULE:
                    out.append(ctx.finding(
                        RULE, node,
                        f"direct import of {RAW_MODULE} outside the index "
                        f"package — use the freshness-validated sessions "
                        f"(DESIGN.md §9)"))
        elif isinstance(node, ast.Call):
            name = astutil.call_name(node).split(".")[-1]
            if name in RAW_CALLS:
                out.append(ctx.finding(
                    RULE, node,
                    f"{name}() called outside the index package — raw "
                    f"label joins skip epoch validation; route through "
                    f"index/freshness.py sessions (DESIGN.md §9)"))
    return out


RULE = register(Rule(
    name="epoch-freshness",
    invariant="index label reads outside src/repro_torch/index/ go "
              "through freshness-validated sessions",
    check=check,
    origin="the JAX package's stale-index fallback design",
    default_filter=lambda rel: rel.startswith(("src/repro_torch/",
                                               "tools/ab_")),
))
