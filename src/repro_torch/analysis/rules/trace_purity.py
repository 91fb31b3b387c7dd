"""trace-purity: no host syncs, wall-clock reads or host RNG draws on the
port's device path (DESIGN.md §10, §14, §15).

The port has no ``jit``. Its counterpart of traced code is the *device
path*: code that enqueues work on the card, where a host sync stalls the
stream's feed and a host clock or RNG draw makes a run depend on the host.
The device path is, per module:

  * every function of ``src/repro_torch/kernels/*/ops.py`` (the kernel
    wrappers);
  * ``forward`` / ``backward`` of every ``torch.autograd.Function``
    subclass;
  * ``TRACED_TWINS``: the port functions whose JAX twins are jit entry
    points (``astutil.jit_entry_names`` of the twin module) and that the
    port defines under the same name in the twin module, and
    ``RENAMED_TWINS``: the port functions that stand for jit entries of
    the twin module under another name (the superstep loop ``_run`` for
    ``_bfs_jit`` / ``_multi_bfs_jit``; tests/test_torch_analysis.py holds
    both lists against the JAX package);

plus every module function those reach through bare-name calls, as in
the JAX package's rule. Banned there: ``time.*``, ``random.*`` and
``np.random.*`` (the port draws only from explicit generators), and the
host syncs ``.item()``, ``.tolist()``, ``.cpu()``, ``bool(...)``,
``np.asarray(...)`` and ``torch.cuda.synchronize()``. A sync the design
needs (a superstep loop that reads its frontier count) carries an inline
allow with its reason; ROADMAP.md lists them as measured host costs. The
obs layer (``src/repro_torch/obs/``) owns the clocks and is exempt, as is
its null-span surface (``_trace.*``).
"""
from __future__ import annotations

import ast

from repro_torch.analysis import astutil
from repro_torch.analysis.framework import FileContext, Finding, Rule, register

# port module -> the functions whose JAX twins are jit entry points
TRACED_TWINS: dict[str, tuple[str, ...]] = {
    "src/repro_torch/core/bfs.py": ("extract_path",),
    "src/repro_torch/core/graph.py": ("version_vector",),
    "src/repro_torch/core/ops.py": (
        "add_edge", "add_edge_undirected", "add_vertex", "apply_ops",
        "apply_ops_fast", "compact", "degree", "neighbors", "remove_edge",
        "remove_edge_undirected", "remove_vertex"),
    "src/repro_torch/core/partition.py": (
        "_push_local", "apply_ops_fast", "compact", "scrub"),
    "src/repro_torch/core/snapshot.py": ("compare_collects",),
    "src/repro_torch/index/labels.py": ("_prune",),
    "src/repro_torch/kernels/bfs_multi_step/ops.py": (
        "multi_bfs_step", "multi_bfs_step_packed"),
    "src/repro_torch/kernels/bfs_pull_step/ops.py": (
        "bfs_pull_step", "multi_bfs_pull_step"),
    "src/repro_torch/kernels/bfs_step/ops.py": ("bfs_step",
                                                "bfs_step_packed"),
    "src/repro_torch/kernels/edge_update/ops.py": ("edge_update",
                                                   "edge_update_packed"),
    "src/repro_torch/kernels/label_join/ops.py": ("label_join",
                                                  "label_join_packed"),
    "src/repro_torch/launch/dryrun.py": ("step",),
    "src/repro_torch/models/moe.py": ("combine",),
}
# port function -> the JAX jit entries of the twin module it stands for,
# where the port folded them into a function of another name
RENAMED_TWINS: dict[str, dict[str, tuple[str, ...]]] = {
    "src/repro_torch/core/bfs.py": {
        "_run": ("_bfs_jit", "_multi_bfs_jit", "_multi_superstep_jit")},
    "src/repro_torch/core/partition.py": {"_run": ("_multi_bfs_jit",)},
    "src/repro_torch/core/snapshot.py": {
        "collect": ("_collect_jit",),
        "collect_batch": ("_collect_batch_jit", "_collect_batch_finish_jit"),
        "get_path": ("_get_path_jit",),
        "interleaved_getpath": ("_interleaved_getpath_jit",)},
}
KERNEL_OPS = ("src/repro_torch/kernels/", "/ops.py")
OBS_PKG = "src/repro_torch/obs/"

# dotted-prefix bans: wall clocks and host RNGs on the device path
BANNED_PREFIXES = (
    ("time.", "wall-clock read"),
    ("random.", "host RNG draw"),
    ("np.random.", "host RNG draw"),
    ("numpy.random.", "host RNG draw"),
)
# exact-callee bans: host syncs
BANNED_CALLS = {
    "np.asarray": "host-sync materialization (np.asarray copies a device "
                  "tensor to the host)",
    "numpy.asarray": "host-sync materialization (copies to the host)",
    "bool": "host-sync truthiness (bool(tensor) waits for the device "
            "value)",
    "torch.cuda.synchronize": "explicit host sync (waits for the whole "
                              "device)",
}
BANNED_METHODS = {
    "item": "host-sync scalar read (.item() waits for the device value)",
    "tolist": "host-sync copy (.tolist() waits for the device values)",
    "cpu": "host-sync copy (.cpu() waits for the device tensor)",
}
# the obs layer's null-span surface is exempt (host-free disabled path)
EXEMPT_PREFIXES = ("_trace.",)


def _banned(call: ast.Call) -> str | None:
    if isinstance(call.func, ast.Attribute) and \
            call.func.attr in BANNED_METHODS:   # on any receiver
        meth = call.func.attr
        return f".{meth}() — {BANNED_METHODS[meth]}"
    name = astutil.call_name(call)
    if not name:
        return None
    if any(name.startswith(p) for p in EXEMPT_PREFIXES):
        return None
    if name in BANNED_CALLS:
        return f"{name}() — {BANNED_CALLS[name]}"
    for prefix, why in BANNED_PREFIXES:
        if name.startswith(prefix):
            return f"{name}() — {why}"
    return None


def device_entries(relpath: str, tree: ast.Module,
                   funcs: dict[str, ast.FunctionDef]
                   ) -> dict[str, ast.FunctionDef]:
    """The device-path roots of one module (see the module docstring);
    ``funcs`` is its ``astutil.module_functions``."""
    roots = dict(astutil.autograd_function_methods(tree))
    if relpath.startswith(KERNEL_OPS[0]) and relpath.endswith(KERNEL_OPS[1]):
        roots.update((n.name, n) for n in tree.body
                     if isinstance(n, ast.FunctionDef))
    for name in (*TRACED_TWINS.get(relpath, ()),
                 *RENAMED_TWINS.get(relpath, {})):
        if name in funcs:
            roots.setdefault(name, funcs[name])
    return roots


def check(ctx: FileContext) -> list[Finding]:
    if ctx.relpath.startswith(OBS_PKG):
        return []  # the obs layer owns the clocks (null-span exemption)
    funcs = astutil.module_functions(ctx.tree)
    missing = [n for n in (*TRACED_TWINS.get(ctx.relpath, ()),
                           *RENAMED_TWINS.get(ctx.relpath, {}))
               if n not in funcs]
    out: list[Finding] = [ctx.finding(
        RULE, 0, f"TRACED_TWINS names {name}(), which this module no "
                 f"longer defines — update the list") for name in missing]
    reached = astutil.reachable_functions(
        funcs, device_entries(ctx.relpath, ctx.tree, funcs))
    seen_lines: set[int] = set()
    for fname, fn in sorted(reached.items()):
        for call in astutil.iter_calls(fn):
            why = _banned(call)
            if why is None or call.lineno in seen_lines:
                continue
            seen_lines.add(call.lineno)
            out.append(ctx.finding(
                RULE, call,
                f"{why} inside {fname}(), which is on the device path (a "
                f"kernel wrapper, an autograd Function or the twin of a "
                f"JAX jit entry; DESIGN.md §14 trace-purity)"))
    return out


RULE = register(Rule(
    name="trace-purity",
    invariant="no time/random/host-sync calls in functions reachable from "
              "the device path: kernel wrappers, autograd Functions and "
              "the twins of JAX jit entries",
    check=check,
    origin="the JAX package's obs-layer zero-overhead pins",
    default_filter=lambda rel: rel.startswith("src/repro_torch/"),
))
