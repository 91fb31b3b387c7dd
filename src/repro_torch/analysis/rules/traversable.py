"""traversable-predicate: no raw adjacency liveness tests (DESIGN.md §1,
§15).

A BFS step testing ``adj > 0`` bare while the expansion applies the
endpoint-liveness mask is the bug class this rule kills: exactly ONE
predicate, ``repro_torch.core.graph.traversable`` (and its packed twin
``traversable_packed``), may decide whether an edge is logically present.
Any other comparison of an adjacency expression against a constant is
either a liveness test that forgot the alive mask, or physical-bit
bookkeeping that must say so with an inline allow.

Heuristic: a Compare / BinOp whose operand's dotted source involves a
name containing ``adj`` (``adj``, ``adj_packed``, ``adj_in``, ``adj_l``,
``adjw_ref``, ...) tested against a numeric constant, outside the
predicate's home ``core/graph.py`` and the host-side spec oracle.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.framework import FileContext, Finding, Rule, register

# files allowed to test adjacency raw: the predicate definition site and
# the host-side python spec oracle (definitionally correct by inspection)
ALLOWED = ("src/repro_torch/core/graph.py", "src/repro_torch/core/oracle.py")


def _mentions_adj(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and "adj" in n.id:
            return True
        if isinstance(n, ast.Attribute) and "adj" in n.attr:
            return True
    return False


def _is_const_num(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and isinstance(
        node.value, (int, float)) and not isinstance(node.value, bool)


def check(ctx: FileContext) -> list[Finding]:
    if ctx.relpath in ALLOWED:
        return []
    out: list[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Compare):
            continue
        sides = [node.left] + list(node.comparators)
        if not any(_is_const_num(s) for s in sides):
            continue
        exprs = [s for s in sides if not _is_const_num(s)]
        if any(_mentions_adj(e) for e in exprs):
            out.append(ctx.finding(
                RULE, node,
                "raw adjacency test — edge liveness must come from "
                "core.graph.traversable()/traversable_packed() (or be an "
                "explicitly allowed physical-bit read); a parent scan "
                "that forgets the alive mask is exactly this pattern"))
    return out


RULE = register(Rule(
    name="traversable-predicate",
    invariant="edge liveness is decided only by repro_torch.core.graph."
              "traversable / traversable_packed",
    check=check,
    origin="the JAX package's parent-scan liveness drift",
    default_filter=lambda rel: rel.startswith("src/repro_torch/"),
))
