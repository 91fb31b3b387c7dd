"""lock-order: entity locks route through EntityLockTable (DESIGN.md §12, §15).

Admission is deadlock-free *by construction* only because every acquirer
orders its entity locks identically — ascending acquire, descending
release, all-or-nothing backout — and that discipline lives in exactly
one class, ``repro_torch.runtime.ingest.EntityLockTable``. A new bare
``.acquire()`` / ``.release()`` site (or a privately constructed
``threading.Lock`` pool) in the runtime layer reopens the wait-cycle
argument the proof closed, so every such site outside the table class is
flagged at diff time.

``with lock:`` blocks are exempt: context-managed guards cannot leak a
partial acquire and are how the table protects its own dict.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import astutil
from repro_torch.analysis.framework import FileContext, Finding, Rule, register

TABLE_CLASS = "EntityLockTable"
_LOCK_METHODS = ("acquire", "release")


def _inside_table(node: ast.AST) -> bool:
    cls = astutil.enclosing_class(node)
    return cls is not None and cls.name == TABLE_CLASS


def check(ctx: FileContext) -> list[Finding]:
    out: list[Finding] = []
    for call in astutil.iter_calls(ctx.tree):
        if not isinstance(call.func, ast.Attribute):
            continue
        meth = call.func.attr
        if meth in _LOCK_METHODS and not _inside_table(call):
            out.append(ctx.finding(
                RULE, call,
                f"bare .{meth}() outside {TABLE_CLASS} — entity locks "
                f"must go through the table's sorted ascending-acquire/"
                f"descending-release discipline (deadlock-freedom proof, "
                f"DESIGN.md §12)"))
        elif meth == "Lock" and astutil.dotted(call.func).startswith(
                "threading") and not _inside_table(call):
            out.append(ctx.finding(
                RULE, call,
                f"threading.Lock() constructed outside {TABLE_CLASS} — "
                f"new lock pools bypass the sorted-entity discipline "
                f"(DESIGN.md §12); add the lock to the table or justify "
                f"with an inline allow"))
    return out


RULE = register(Rule(
    name="lock-order",
    invariant="entity-lock acquire/release sites live only inside "
              "EntityLockTable's sorted discipline",
    check=check,
    origin="the admission deadlock-freedom proof (DESIGN.md §12)",
    default_filter=lambda rel: rel.startswith("src/repro_torch/runtime/"),
))
