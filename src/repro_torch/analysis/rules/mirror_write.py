"""mirror-write: adjacency mirrors must be written together (DESIGN.md §11,
§15).

``GraphState.adj_in_packed`` is maintained FIRST-CLASS — every mutation
path that writes ``adj_packed`` must mirror the write into
``adj_in_packed`` or the transpose invariant
(``repro_torch.core.graph.transpose_invariant``) silently breaks and
every pull-phase BFS and backward index closure reads garbage. Any
``GraphState(...)`` / ``ShardedGraphState(...)`` construction or
``._replace(...)`` that names one packed-adjacency field must name the
other. The positions below are those of ``repro_torch.core.graph.
GraphState``'s fields (tests/test_torch_analysis.py pins them).

Positional ``GraphState(...)`` calls must either cover both trailing
fields (>= 6 positional args, or a *args splat) or pass both as
keywords. Constructions that touch NEITHER field (metadata-only
``_replace``) are fine — the mirrors move together or not at all.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import astutil
from repro_torch.analysis.framework import FileContext, Finding, Rule, register

FIELDS = ("adj_packed", "adj_in_packed")
# positions of (adj_packed, adj_in_packed) in the GraphState NamedTuple
# (ShardedGraphState's __init__ takes the mesh first, then the same six)
ADJ_POS, ADJ_IN_POS = 4, 5


def check(ctx: FileContext) -> list[Finding]:
    out: list[Finding] = []
    for call in astutil.iter_calls(ctx.tree):
        name = astutil.call_name(call).split(".")[-1]
        if name == "_replace":
            kws = astutil.keyword_names(call)
            for present, missing in ((FIELDS[0], FIELDS[1]),
                                     (FIELDS[1], FIELDS[0])):
                if present in kws and missing not in kws:
                    out.append(ctx.finding(
                        RULE, call,
                        f"._replace writes {present} without {missing} — "
                        f"mirrored adjacency updates must move together "
                        f"(transpose invariant, DESIGN.md §11)"))
        elif name in ("GraphState", "ShardedGraphState"):
            if any(isinstance(a, ast.Starred) for a in call.args):
                continue  # splat: the full field tuple is forwarded
            kws = astutil.keyword_names(call)
            # ShardedGraphState prepends a mesh argument before the fields
            off = 1 if name == "ShardedGraphState" else 0
            writes_adj = FIELDS[0] in kws or len(call.args) > ADJ_POS + off
            writes_in = FIELDS[1] in kws or len(call.args) > ADJ_IN_POS + off
            if writes_adj and not writes_in:
                out.append(ctx.finding(
                    RULE, call,
                    f"{name} constructed with {FIELDS[0]} but no "
                    f"{FIELDS[1]} — the in-adjacency mirror must be "
                    f"written by every mutation path (DESIGN.md §11)"))
    return out


RULE = register(Rule(
    name="mirror-write",
    invariant="every GraphState construction/_replace writing adj_packed "
              "also writes adj_in_packed",
    check=check,
    origin="the JAX package's transpose invariant",
    default_filter=lambda rel: rel.startswith(("src/repro_torch/",
                                               "tools/ab_"))
    or rel == "chip_smoke.py",
))
