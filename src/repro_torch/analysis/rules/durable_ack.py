"""durable-ack: no ack/epoch-flip without a preceding WAL append (§16, §15).

The crash-recovery guarantee (DESIGN.md §16) hangs on ONE ordering
discipline in the port's ``runtime/ingest.py``, as in the JAX package's:
a round's WAL record is append-fsync durable BEFORE the epoch flips
(``self._publish(...)``) and BEFORE any client ticket is acknowledged
(``t.status = "applied"``). A refactor that
moves either site above the ``self._wal_commit(...)`` call reintroduces
acknowledged-batch loss — the exact bug class the WAL exists to kill —
and no test catches it deterministically unless the kill lands in the
reordered window. This rule makes the ordering structural: inside any
function that flips the epoch or acks a ticket, a ``_wal_commit`` call
must appear on an earlier line (straight-line dominance; the admission
loop is one basic block between these points).

Functions that neither publish nor ack are ignored, as are the
``_publish``/``_wal_commit`` definitions themselves. The recovery path
intentionally bypasses admission: it rebuilds pool slots directly
(``resume_pool``) and re-appends nothing, so it never trips this rule.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import astutil
from repro_torch.analysis.framework import FileContext, Finding, Rule, register


def _wal_commit_lines(fn: ast.AST) -> list[int]:
    return [c.lineno for c in astutil.iter_calls(fn)
            if astutil.call_name(c).split(".")[-1] == "_wal_commit"]


def check(ctx: FileContext) -> list[Finding]:
    out: list[Finding] = []
    commit_lines: dict[ast.AST, list[int]] = {}

    def dominated(node: ast.AST) -> bool:
        fn = astutil.enclosing_function(node)
        if fn is None:
            return False
        if fn not in commit_lines:
            commit_lines[fn] = _wal_commit_lines(fn)
        return any(line < node.lineno for line in commit_lines[fn])

    for call in astutil.iter_calls(ctx.tree):
        if astutil.call_name(call).split(".")[-1] != "_publish":
            continue
        if not dominated(call):
            out.append(ctx.finding(
                RULE, call,
                "epoch flip (._publish) not dominated by a _wal_commit "
                "call — a kill -9 here loses the round after clients "
                "could observe it (DESIGN.md §16)"))
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Assign):
            continue
        if not (isinstance(node.value, ast.Constant)
                and node.value.value == "applied"):
            continue
        if not any(isinstance(t, ast.Attribute) and t.attr == "status"
                   for t in node.targets):
            continue
        if not dominated(node):
            out.append(ctx.finding(
                RULE, node,
                "ticket ack (.status = \"applied\") not dominated by a "
                "_wal_commit call — an acked batch must already be "
                "fsync-durable (DESIGN.md §16)"))
    return out


RULE = register(Rule(
    name="durable-ack",
    invariant="every epoch flip / ticket ack in repro_torch/runtime/"
              "ingest.py is dominated by a WAL append-fsync",
    check=check,
    origin="DESIGN.md §16 WAL ordering discipline",
    default_filter=lambda rel: rel == "src/repro_torch/runtime/ingest.py",
))
