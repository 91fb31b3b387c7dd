"""Shared AST helpers for ``repro_torch.analysis`` rules (DESIGN.md §15).

Pure ``ast``-level utilities: dotted-name rendering, call resolution, the
``torch.autograd.Function`` methods and the intra-module reachability walk
the trace-purity rule is built on (the port has no ``jit``, so the JAX
linter's jit-entry detection has no counterpart here). No imports of the
analyzed code ever happen here — rules that need live objects
(metrics-doc) do their own importing and say so.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional


def dotted(node: ast.AST) -> str:
    """Render a Name/Attribute chain as 'a.b.c' ('' when not a plain
    chain). Subscripts and calls inside the chain end the rendering at
    that point — good enough for pattern rules."""
    parts: list[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return ""


def call_name(call: ast.Call) -> str:
    """Dotted name of a call's callee ('' when dynamic)."""
    return dotted(call.func)


def keyword_names(call: ast.Call) -> set[str]:
    return {kw.arg for kw in call.keywords if kw.arg is not None}


def parent(node: ast.AST) -> Optional[ast.AST]:
    """Parent link attached by ``FileContext.tree``."""
    return getattr(node, "_repro_parent", None)


def enclosing_class(node: ast.AST) -> Optional[ast.ClassDef]:
    cur = parent(node)
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur
        cur = parent(cur)
    return None


def enclosing_function(node: ast.AST) -> Optional[ast.AST]:
    cur = parent(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = parent(cur)
    return None


def module_functions(tree: ast.Module) -> dict[str, ast.FunctionDef]:
    """All function defs in the module keyed by BARE name (module level,
    methods and nested defs alike — bare-name resolution is the documented
    heuristic of the reachability walk; a miss only widens the scanned
    set, never narrows it)."""
    out: dict[str, ast.FunctionDef] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            out.setdefault(node.name, node)
    return out


def autograd_function_methods(tree: ast.Module
                              ) -> dict[str, ast.FunctionDef]:
    """``forward`` / ``backward`` of every class deriving from
    ``torch.autograd.Function`` (any spelling ending in
    ``autograd.Function``), keyed ``Class.method``."""
    out: dict[str, ast.FunctionDef] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        if not any(dotted(b).endswith("autograd.Function")
                   for b in node.bases):
            continue
        for item in node.body:
            if isinstance(item, ast.FunctionDef) and item.name in (
                    "forward", "backward"):
                out[f"{node.name}.{item.name}"] = item
    return out


def reachable_functions(funcs: dict[str, ast.FunctionDef],
                        roots: dict[str, ast.FunctionDef]
                        ) -> dict[str, ast.FunctionDef]:
    """``roots`` plus the functions of ``funcs`` (a module's
    ``module_functions``) they reach through bare-name calls,
    transitively. Nested defs are covered implicitly (a FunctionDef's walk
    includes its nested bodies)."""
    reached: dict[str, ast.FunctionDef] = {}
    work = list(roots.items())
    while work:
        name, fn = work.pop()
        if name in reached:
            continue
        reached[name] = fn
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                callee = call_name(node)
                if callee and "." not in callee and callee in funcs \
                        and callee not in reached:
                    work.append((callee, funcs[callee]))
    return reached


def iter_calls(node: ast.AST) -> Iterator[ast.Call]:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            yield n


def literal_assignment(tree: ast.Module, name: str):
    """(value, node) of a module-level ``NAME = <literal>`` assignment;
    (None, node) when present but not a pure literal; (None, None) when
    absent. Used by the kernel-shape sanitizer and ``ptxas.py`` to read
    KERNEL_META without importing the package."""
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Name) and t.id == name:
                try:
                    return ast.literal_eval(node.value), node
                except (ValueError, SyntaxError):
                    return None, node
    return None, None
