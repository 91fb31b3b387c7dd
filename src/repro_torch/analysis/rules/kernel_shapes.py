"""kernel-shape: the port's CUDA kernel packages carry checkable metadata
(DESIGN.md §10, §15).

Every kernel package (a directory with ``kernel.cu`` + ``ops.py`` +
``ref.py``) ships a ``meta.py`` whose module-level ``KERNEL_META`` is a
PURE LITERAL describing the package's C launchers and device kernels. The
sanitizer reads the CUDA sources (``cudasrc.py``: the ``kernel.cu`` and
the headers it includes) and the Python wrappers (``ast``), and holds the
declaration against both, so neither can drift from the other:

  * ``constants``: each launch constant the design depends on equals its
    ``constexpr`` in the sources, resolved by namespace (``dense::SLICE``
    and ``single::SLICE`` differ; a template variable maps each instance
    to its value);
  * ``c_args``: the launcher's C parameter count, the trailing
    ``void* stream`` included. Every ``_build.launch("<pkg>", "<fn>",
    dev, *args)`` in ``ops.py`` names an ``extern "C"`` function of the
    package's sources and passes ``c_args - 1`` arguments (``_build``
    builds the ctypes signature from the call itself, so a missing
    argument would otherwise reach the card as a garbage pointer);
  * ``operands``: dtype and shape symbols of the wrapper's
    ``_build.check_tensor`` tuples; ``outputs``: in order, the wrapper's
    ``torch.empty(..., dtype=...)`` allocations;
  * ``ref``: the plain version exists in ``ref.py``, takes the public
    ``wrapper``'s operands (parameters without a default) and accepts
    each of its options;
  * ``packed`` launchers declare their padding story: ``"mask"`` (the
    sources write single bits through shifted masks) or ``"slice"`` (the
    named ``wrapper`` depads with a bounded slice);
  * ``device_kernels``: every ``__global__`` kernel of the package's own
    files, each template instance the build emits, its static shared
    memory (``static_smem_bytes``, the ``__shared__`` declarations with
    resolved constants at natural alignment) within the 48 KB static cap,
    its ``min_blocks_per_sm`` equal to the ``__launch_bounds__`` one with
    blocks x (static + dynamic + 1 KB reserved) within the SM's shared
    memory, an optional ``max_registers`` that fits the register file at
    those blocks, and, where the kernel declares ``extern __shared__``,
    the most dynamic shared memory a launch requests: ``dynamic_smem``, a
    C expression over the package's constants (its launcher's formula at
    its largest), and ``dynamic_smem_bytes``, its value, which static +
    dynamic keeps within the block's opt-in cap. ``ptxas_smem_bytes`` (on
    the kernel or one instance) records where the compiler's layout
    differs from the declarations (an instance that never touches an
    array, padding the compiler adds); ``chip_smoke.py`` holds every
    number here against the build's ``ptxas -v`` report
    (``repro_torch.analysis.ptxas``).

``KERNEL_META`` schema (plain int literals; ``ast.literal_eval`` is the
parser)::

    KERNEL_META = {
        "package": "bfs_pull_step",
        "smem_budget_bytes": {"static": 49152, "dynamic": 232448},
        "kernels": {                      # extern "C" launchers
            "bfs_pull_step_launch": {
                "constants": {"LIST": 256, ...},
                "c_args": 12,
                "operands": {"alive": {"dtype": "bool",
                                       "shape": ["rows"]}, ...},
                "outputs": {"new": {"dtype": "bool",
                                    "shape": ["q", "rows"]}, ...},
                "packed": False,
                "pad_safety": None,       # "mask" | "slice" when packed
                "wrapper": "bfs_pull_step_rows",
                "ref": "bfs_pull_step_ref",
            },
        },
        "device_kernels": {               # __global__, by namespace
            "pull_rows": {"static_smem_bytes": 46340,
                          "min_blocks_per_sm": 4, "max_registers": 64,
                          "instances": {"<true, true>": {}, ...}},
        },
    }

A launcher that no ``ops.py`` call reaches declares ``"wrapper": None``
and only its ``constants`` and ``c_args``.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Optional

from repro_torch.analysis import astutil, cudasrc
from repro_torch.analysis.framework import Finding, RepoContext, Rule, register

PAD_SAFETY = ("slice", "mask")
_TOP_KEYS = ("package", "smem_budget_bytes", "kernels", "device_kernels")
# H100 (sm_90): 1 KB of each block's shared memory is reserved by the
# system, and an SM holds at most dynamic cap + 1 KB; 64 K registers an SM
RESERVED_SMEM_PER_BLOCK = 1024
REGISTERS_PER_SM = 65536


def _parse(path: Path) -> Optional[ast.Module]:
    try:
        return ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    except (OSError, SyntaxError):
        return None


def _fn_defs(tree: Optional[ast.Module]) -> dict[str, ast.FunctionDef]:
    if tree is None:
        return {}
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def read_meta(path: Path) -> tuple[Optional[dict], Optional[ast.AST], str]:
    """(KERNEL_META, its node, problem) of a ``meta.py``."""
    tree = _parse(path)
    if tree is None:
        return None, None, "meta.py unreadable or syntactically invalid"
    meta, node = astutil.literal_assignment(tree, "KERNEL_META")
    if node is None:
        return None, None, "meta.py defines no KERNEL_META"
    if meta is None:
        return None, node, ("KERNEL_META must be a pure literal (plain "
                            "ints, no arithmetic or names) — "
                            "ast.literal_eval is the parser")
    if not isinstance(meta, dict) or not all(k in meta for k in _TOP_KEYS):
        return None, node, f"KERNEL_META missing required keys {_TOP_KEYS}"
    budget = meta["smem_budget_bytes"]
    if (not isinstance(budget, dict)
            or set(budget) != {"static", "dynamic"}
            or not all(isinstance(v, int) and v > 0
                       for v in budget.values())):
        return None, node, ("smem_budget_bytes must map 'static' and "
                            "'dynamic' to positive int bytes")
    for key in ("kernels", "device_kernels"):
        if not isinstance(meta[key], dict) or not meta[key] or not all(
                isinstance(v, dict) for v in meta[key].values()):
            return None, node, (f"KERNEL_META[{key!r}] must be a non-empty "
                                f"dict of dicts")
    return meta, node, ""


def instances(entry: dict) -> dict[str, dict]:
    """``{instance key: effective entry}`` of one device kernel ("" for a
    kernel that is no template)."""
    inst = entry.get("instances")
    base = {k: v for k, v in entry.items() if k != "instances"}
    if not inst:
        return {"": base}
    return {key: {**base, **over} for key, over in inst.items()}


# ----------------------------------------------------------------------------
# ops.py: launch sites, operands, outputs
# ----------------------------------------------------------------------------
def _call_bindings(tree: ast.Module, fn: ast.FunctionDef
                   ) -> list[dict[str, ast.AST]]:
    """Per bare-name call of ``fn`` in its module: parameter -> argument
    node ([{}] when nothing calls it)."""
    params = [a.arg for a in fn.args.args]
    out = []
    for call in astutil.iter_calls(tree):
        if astutil.call_name(call) != fn.name:
            continue
        b: dict[str, ast.AST] = dict(zip(params, call.args))
        b.update((kw.arg, kw.value) for kw in call.keywords if kw.arg)
        out.append(b)
    return out or [{}]


def _string(node: ast.AST, env: dict) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name) and node.id in env:
        return _string(env[node.id], {})
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            s = _string(v.value if isinstance(v, ast.FormattedValue) else v,
                        env)
            if s is None:
                return None
            parts.append(s)
        return "".join(parts)
    return None


def _dtype(node: ast.AST, env: dict) -> str:
    if isinstance(node, ast.Name) and node.id in env:
        return _dtype(env[node.id], {})
    name = astutil.dotted(node)
    return name.split(".")[-1] if name.startswith("torch.") else "?"


def _shape(node: ast.AST) -> list[str]:
    if isinstance(node, (ast.Tuple, ast.List)):
        return [ast.unparse(e) for e in node.elts]
    return [ast.unparse(node)]


def _loop_envs(fn: ast.FunctionDef, call: ast.Call) -> list[dict]:
    """Bindings of the ``for a, b in ((x, y), ...)`` loop around ``call``
    ([{}] outside such a loop)."""
    loops = [n for n in ast.walk(fn) if isinstance(n, ast.For)
             and any(c is call for c in ast.walk(n))]
    if not loops:
        return [{}]
    loop = max(loops, key=lambda n: n.lineno)
    if not (isinstance(loop.target, ast.Tuple)
            and isinstance(loop.iter, (ast.Tuple, ast.List))):
        return [{}]
    names = [t.id if isinstance(t, ast.Name) else "" for t in
             loop.target.elts]
    envs = []
    for elt in loop.iter.elts:
        if isinstance(elt, ast.Tuple) and len(elt.elts) == len(names):
            envs.append(dict(zip(names, elt.elts)))
    return envs or [{}]


def operands(fn: ast.FunctionDef, env: dict) -> dict[str, dict]:
    """``{name: {"dtype", "shape"}}`` of the ``check_tensor`` calls."""
    out: dict[str, dict] = {}
    for call in astutil.iter_calls(fn):
        if not astutil.call_name(call).endswith("check_tensor") \
                or len(call.args) < 4:
            continue
        for loop_env in _loop_envs(fn, call):
            full = {**env, **loop_env}
            args = [full.get(a.id, a) if isinstance(a, ast.Name) else a
                    for a in call.args]
            name = _string(args[1], full) or ast.unparse(args[1])
            out[name] = {"dtype": _dtype(call.args[2], full),
                         "shape": _shape(args[3])}
    return out


def outputs(fn: ast.FunctionDef, env: dict) -> list[tuple[str, dict]]:
    """``[(target, {"dtype", "shape"})]`` of the wrapper's
    ``torch.empty(..., dtype=...)`` allocations, in source order."""
    found = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign) or not isinstance(
                node.targets[0], ast.Name):
            continue
        for call in astutil.iter_calls(node.value):
            if astutil.call_name(call) != "torch.empty" or not call.args:
                continue
            dt = [kw.value for kw in call.keywords if kw.arg == "dtype"]
            found.append((node.lineno, node.targets[0].id, {
                "dtype": _dtype(dt[0], env) if dt else "?",
                "shape": _shape(call.args[0])}))
    return [(name, spec) for _, name, spec in sorted(found,
                                                      key=lambda x: x[0])]


class Site:
    """One ``_build.launch`` call, resolved for one binding of its
    wrapper's parameters."""

    def __init__(self, wrapper: ast.FunctionDef, call: ast.Call,
                 package: Optional[str], launcher: Optional[str], env: dict):
        self.wrapper = wrapper
        self.call = call
        self.package = package
        self.launcher = launcher
        self.env = env
        self.n_args = len(call.args) - 3
        self.starred = any(isinstance(a, ast.Starred) for a in call.args)


def launch_sites(tree: ast.Module) -> list[Site]:
    sites: list[Site] = []
    seen: set = set()
    for fn in _fn_defs(tree).values():
        for call in astutil.iter_calls(fn):
            if astutil.call_name(call) != "_build.launch" \
                    or len(call.args) < 3:
                continue
            for env in _call_bindings(tree, fn):
                site = Site(fn, call, _string(call.args[0], env),
                            _string(call.args[1], env), env)
                key = (id(call), site.launcher,
                       repr(sorted(operands(fn, env).items())))
                if key not in seen:
                    seen.add(key)
                    sites.append(site)
    return sites


# ----------------------------------------------------------------------------
# One package
# ----------------------------------------------------------------------------
class _Pkg:
    def __init__(self, ctx: RepoContext, directory: Path):
        self.ctx = ctx
        self.dir = directory
        self.findings: list[Finding] = []

    def flag(self, where, line: int, msg: str) -> None:
        """A finding in ``where``: a file name of the package, or the
        path of an included header."""
        path = where if isinstance(where, Path) else self.dir / where
        self.findings.append(self.ctx.finding(RULE, path, line, msg))

    def run(self) -> None:
        for name in ("ops.py", "ref.py"):
            if not (self.dir / name).is_file():
                self.flag("kernel.cu", 0,
                          f"kernel package has no {name} — a kernel ships "
                          f"its wrappers (ops.py) and its plain version "
                          f"(ref.py)")
                return
        if not (self.dir / "meta.py").is_file():
            self.flag("kernel.cu", 0,
                      "kernel package has no meta.py — declare "
                      "KERNEL_META (launch constants, C arity, operands, "
                      "shared memory) so the sanitizer can gate drift "
                      "(DESIGN.md §15)")
            return
        meta, node, problem = read_meta(self.dir / "meta.py")
        if meta is None:
            self.flag("meta.py", getattr(node, "lineno", 0), problem)
            return
        if meta["package"] != self.dir.name:
            self.flag("meta.py", node.lineno,
                      f"KERNEL_META['package'] is {meta['package']!r}, the "
                      f"directory is {self.dir.name!r}")
        try:
            unit = cudasrc.read_unit(self.dir / "kernel.cu")
        except (OSError, cudasrc.Unresolved) as e:
            self.flag("kernel.cu", 0, f"kernel.cu unreadable: {e}")
            return
        ops_tree = _parse(self.dir / "ops.py")
        ref_tree = _parse(self.dir / "ref.py")
        if ops_tree is None or ref_tree is None:
            self.flag("ops.py", 0, "ops.py or ref.py unparseable")
            return
        self.check_launchers(meta, unit, ops_tree, ref_tree)
        self.check_device_kernels(meta, unit)

    # -- launchers ----------------------------------------------------------
    def check_launchers(self, meta: dict, unit: cudasrc.Unit,
                        ops_tree: ast.Module, ref_tree: ast.Module) -> None:
        ops_fns = _fn_defs(ops_tree)
        ref_fns = _fn_defs(ref_tree)
        own = {f.name: f for f in unit.c_functions.values()
               if f.path.parent == self.dir.resolve()}
        for name in sorted(own):
            if name.endswith("_launch") and name not in meta["kernels"]:
                self.flag("kernel.cu", own[name].line,
                          f"extern \"C\" {name}() is not declared in "
                          f"KERNEL_META['kernels']")
        sites = launch_sites(ops_tree)
        by_launcher: dict[str, list[Site]] = {}
        for site in sites:
            line = site.call.lineno
            if site.package is None or site.launcher is None:
                self.flag("ops.py", line,
                          "_build.launch names its package or launcher "
                          "through something the sanitizer cannot resolve "
                          "to a string — pass a literal, or a wrapper "
                          "parameter that every call binds to one")
                continue
            if site.starred:
                self.flag("ops.py", line,
                          "_build.launch with a *splat — the argument "
                          "count cannot be held against the C launcher")
                continue
            if site.package != self.dir.name:
                self.flag("ops.py", line,
                          f"_build.launch builds package "
                          f"{site.package!r} from package {self.dir.name!r}")
            cfn = unit.c_functions.get(site.launcher)
            if cfn is None:
                self.flag("ops.py", line,
                          f"unknown launcher symbol {site.launcher!r}: no "
                          f"extern \"C\" function of that name in "
                          f"kernel.cu or the headers it includes")
                continue
            if site.n_args + 1 != cfn.n_params:
                self.flag("ops.py", line,
                          f"c_args mismatch: {site.wrapper.name}() passes "
                          f"{site.n_args} arguments + the stream to "
                          f"{site.launcher}(), which takes {cfn.n_params} "
                          f"C parameters ({cfn.path.name}:{cfn.line}) — "
                          f"the launcher would read garbage")
            by_launcher.setdefault(site.launcher, []).append(site)
        for name, entry in meta["kernels"].items():
            self.check_launcher(name, entry, unit, by_launcher.get(name, []),
                                ops_fns, ref_fns)

    def check_launcher(self, name: str, entry: dict, unit: cudasrc.Unit,
                       sites: list[Site], ops_fns: dict, ref_fns: dict
                       ) -> None:
        cfn = unit.c_functions.get(name)
        if cfn is None:
            self.flag("meta.py", 0,
                      f"KERNEL_META declares launcher {name} but the "
                      f"sources define no extern \"C\" {name}()")
            return
        if entry.get("c_args") != cfn.n_params:
            self.flag("meta.py", 0,
                      f"{name}: c_args drift — meta.py says "
                      f"{entry.get('c_args')}, {cfn.path.name}:{cfn.line} "
                      f"takes {cfn.n_params} C parameters")
        self.check_constants(name, entry.get("constants", {}), unit)
        if entry.get("wrapper") is None:
            if sites:
                self.flag("ops.py", sites[0].call.lineno,
                          f"{name}: ops.py launches it but KERNEL_META "
                          f"names no wrapper")
            return
        if not sites:
            self.flag("meta.py", 0,
                      f"{name}: KERNEL_META names wrapper "
                      f"{entry['wrapper']}() but no _build.launch in ops.py "
                      f"reaches {name}")
            return
        for site in sites:
            self.check_site(name, entry, site)
        self.check_ref(name, entry, ops_fns, ref_fns)
        self.check_padding(name, entry, unit, ops_fns)

    def check_constants(self, name: str, constants: dict,
                        unit: cudasrc.Unit) -> None:
        for key, want in constants.items():
            c = unit.constants.get(key)
            if c is None:
                same = sorted(q for q in unit.constants
                              if q.split("::")[-1] == key.split("::")[-1])
                hint = (f" (by namespace: {', '.join(same)})" if same
                        else "")
                self.flag("meta.py", 0,
                          f"{name}: constant {key} is not a constexpr of "
                          f"the sources{hint}")
                continue
            cases = want.items() if isinstance(want, dict) else [(None,
                                                                  want)]
            for inst, value in cases:
                try:
                    targs = None
                    if inst is not None:
                        env = cudasrc.bind(c.tparams, inst)
                        targs = [env[p] for _, p in c.tparams]
                    got = unit.constant(key, targs)
                except cudasrc.Unresolved as e:
                    self.flag("meta.py", 0,
                              f"{name}: constant {key}"
                              f"{inst or ''} does not resolve: {e}")
                    continue
                if got != value:
                    self.flag(c.path, c.line,
                              f"{name}: constant drift — meta.py says "
                              f"{key}{inst or ''} = {value}, "
                              f"{c.path.name}:{c.line} says {got}")

    def check_site(self, name: str, entry: dict, site: Site) -> None:
        line = site.wrapper.lineno
        want = entry.get("operands", {})
        got = operands(site.wrapper, site.env)
        for op in sorted(set(want) | set(got)):
            if op not in got:
                self.flag("ops.py", line,
                          f"{name}: operand {op!r} declared in meta.py is "
                          f"not checked by {site.wrapper.name}()")
            elif op not in want:
                self.flag("ops.py", line,
                          f"{name}: {site.wrapper.name}() checks operand "
                          f"{op!r}, which meta.py does not declare")
            else:
                for key in ("dtype", "shape"):
                    if want[op].get(key) != got[op][key]:
                        self.flag("ops.py", line,
                                  f"{name}: operand {op!r} {key} drift — "
                                  f"meta.py says {want[op].get(key)}, "
                                  f"{site.wrapper.name}() checks "
                                  f"{got[op][key]}")
        want_out = list(entry.get("outputs", {}).items())
        got_out = outputs(site.wrapper, site.env)
        if [n for n, _ in want_out] != [n for n, _ in got_out]:
            self.flag("ops.py", line,
                      f"{name}: outputs drift — meta.py declares "
                      f"{[n for n, _ in want_out]}, {site.wrapper.name}() "
                      f"allocates {[n for n, _ in got_out]}")
            return
        for (out, spec), (_, got_spec) in zip(want_out, got_out):
            for key in ("dtype", "shape"):
                if spec.get(key) != got_spec[key]:
                    self.flag("ops.py", line,
                              f"{name}: output {out!r} {key} drift — "
                              f"meta.py says {spec.get(key)}, "
                              f"{site.wrapper.name}() allocates "
                              f"{got_spec[key]}")

    def check_ref(self, name: str, entry: dict, ops_fns: dict,
                  ref_fns: dict) -> None:
        wrapper = ops_fns.get(entry["wrapper"])
        if wrapper is None:
            self.flag("ops.py", 0,
                      f"{name}: KERNEL_META names wrapper "
                      f"{entry['wrapper']}(), which ops.py does not define")
            return
        ref_name = entry.get("ref")
        ref = ref_fns.get(ref_name or "")
        if ref is None:
            self.flag("ref.py", 0,
                      f"{name}: declared plain version {ref_name}() not "
                      f"found in ref.py — every kernel ships one "
                      f"(DESIGN.md §10)")
            return

        def split(fn):
            args = fn.args.args
            n_req = len(args) - len(fn.args.defaults)
            return ([a.arg for a in args[:n_req]],
                    {a.arg for a in args[n_req:]}
                    | {a.arg for a in fn.args.kwonlyargs})

        w_ops, w_opts = split(wrapper)
        r_ops, r_opts = split(ref)
        if len(w_ops) != len(r_ops):
            self.flag("ref.py", ref.lineno,
                      f"{ref_name}() takes {len(r_ops)} operands but "
                      f"{wrapper.name}() takes {len(w_ops)} — "
                      f"kernel/plain-version contract drift")
        for opt in sorted(w_opts - r_opts):
            self.flag("ref.py", ref.lineno,
                      f"{ref_name}() has no option {opt!r}, which "
                      f"{wrapper.name}() takes")

    def check_padding(self, name: str, entry: dict, unit: cudasrc.Unit,
                      ops_fns: dict) -> None:
        if not entry.get("packed"):
            return
        safety = entry.get("pad_safety")
        if safety not in PAD_SAFETY:
            self.flag("meta.py", 0,
                      f"{name}: packed launcher must declare pad_safety "
                      f"in {PAD_SAFETY} — int32 padding bits need an "
                      f"explicit story")
        elif safety == "slice":
            wrapper = ops_fns[entry["wrapper"]]
            if not any(isinstance(n, ast.Slice) and n.upper is not None
                       for n in ast.walk(wrapper)):
                self.flag("ops.py", wrapper.lineno,
                          f"{wrapper.name}(): pad_safety='slice' but no "
                          f"bounded slice ([:v]-style depad) found — "
                          f"padded lanes would leak to callers")
        elif not unit.shifts:
            self.flag("kernel.cu", 0,
                      f"{name}: pad_safety='mask' but the sources build no "
                      f"shifted bit masks (<<) — whole-word writes would "
                      f"clobber padding bits")

    # -- device kernels -----------------------------------------------------
    def check_device_kernels(self, meta: dict, unit: cudasrc.Unit) -> None:
        budget = meta["smem_budget_bytes"]
        sm_smem = budget["dynamic"] + RESERVED_SMEM_PER_BLOCK
        own = {q: k for q, k in unit.kernels.items()
               if k.path.parent == self.dir.resolve()}
        declared = meta["device_kernels"]
        for q in sorted(set(own) - set(declared)):
            self.flag(own[q].path, own[q].line,
                      f"__global__ {q} is not declared in "
                      f"KERNEL_META['device_kernels']")
        for q, entry in declared.items():
            kernel = own.get(q)
            if kernel is None:
                self.flag("meta.py", 0,
                          f"KERNEL_META declares device kernel {q}, which "
                          f"the package's own sources do not define (a "
                          f"kernel is declared by the package that owns "
                          f"its file)")
                continue
            self.check_device_kernel(q, entry, kernel, unit, budget, sm_smem)

    def check_device_kernel(self, q: str, entry: dict,
                            kernel: cudasrc.Kernel, unit: cudasrc.Unit,
                            budget: dict, sm_smem: int) -> None:
        where = kernel.path
        if bool(kernel.tparams) != bool(entry.get("instances")):
            self.flag("meta.py", 0,
                      f"{q}: " + ("a template kernel lists the instances "
                                  "the build emits under 'instances'"
                                  if kernel.tparams else
                                  "no template: it has no 'instances'"))
            return
        declared = entry.get("static_smem_bytes")
        for inst, eff in instances(entry).items():
            label = f"{q}{inst}"
            try:
                env = cudasrc.bind(kernel.tparams, inst) if inst else {}
            except cudasrc.Unresolved as e:
                self.flag("meta.py", 0, f"{label}: {e}")
                continue
            dynamic = self.dynamic_smem(label, eff, kernel, unit, env)
            try:
                static = unit.static_smem(kernel, env)
                threads, blocks = unit.launch_bounds(kernel, env)
            except cudasrc.Unresolved as e:
                if not isinstance(declared, int):
                    self.flag("meta.py", 0,
                              f"{label}: static shared memory does not "
                              f"resolve ({e}) — declare static_smem_bytes")
                    continue
                static, threads, blocks = declared, None, eff.get(
                    "min_blocks_per_sm")
            if declared != static:
                self.flag(where, kernel.line,
                          f"{label}: static smem drift — meta.py says "
                          f"{declared} bytes, the __shared__ declarations "
                          f"take {static}")
            worst = max(static, eff.get("ptxas_smem_bytes", 0))
            if worst > budget["static"]:
                self.flag(where, kernel.line,
                          f"{label}: {worst} bytes of static shared memory "
                          f"exceed the {budget['static']}-byte static cap "
                          f"— move it to dynamic shared memory or shrink "
                          f"the tiles")
            if eff.get("min_blocks_per_sm") != blocks:
                self.flag(where, kernel.line,
                          f"{label}: min_blocks_per_sm drift — meta.py "
                          f"says {eff.get('min_blocks_per_sm')}, "
                          f"__launch_bounds__ says {blocks}")
            if worst + dynamic > budget["dynamic"]:
                self.flag(where, kernel.line,
                          f"{label}: {worst} static + {dynamic} dynamic "
                          f"bytes exceed the {budget['dynamic']} bytes of "
                          f"shared memory a block may opt in to")
            if blocks:
                need = blocks * (worst + dynamic + RESERVED_SMEM_PER_BLOCK)
                if need > sm_smem:
                    self.flag(where, kernel.line,
                              f"{label}: {blocks} blocks x ({worst} static "
                              f"+ {dynamic} dynamic + "
                              f"{RESERVED_SMEM_PER_BLOCK} reserved) = "
                              f"{need} bytes overflow the SM's {sm_smem} "
                              f"bytes of shared memory — min_blocks_per_sm "
                              f"cannot hold")
            regs = eff.get("max_registers")
            if regs is not None and threads and blocks and \
                    regs * threads * blocks > REGISTERS_PER_SM:
                self.flag(where, kernel.line,
                          f"{label}: max_registers {regs} x {threads} "
                          f"threads x {blocks} blocks overflow the SM's "
                          f"{REGISTERS_PER_SM} registers")

    def dynamic_smem(self, label: str, eff: dict, kernel: cudasrc.Kernel,
                     unit: cudasrc.Unit, env: dict) -> int:
        """Declared dynamic shared memory of one instance (0 where the
        kernel has none), held against its expression."""
        expr, size = eff.get("dynamic_smem"), eff.get("dynamic_smem_bytes")
        where = kernel.path
        if not kernel.dynamic:
            if expr is not None or size is not None:
                self.flag(where, kernel.line,
                          f"{label}: dynamic shared memory declared but the "
                          f"kernel declares no extern __shared__")
            return 0
        if not isinstance(expr, str) or not isinstance(size, int):
            self.flag(where, kernel.line,
                      f"{label}: declares extern __shared__; give the most "
                      f"a launch requests as 'dynamic_smem' (a C expression "
                      f"over the package's constants) and "
                      f"'dynamic_smem_bytes' (its value)")
            return size if isinstance(size, int) else 0
        try:
            value = unit.evaluate(cudasrc.tokenize(expr), kernel.ns, env,
                                  kernel.locals)
        except cudasrc.Unresolved as e:
            self.flag("meta.py", 0,
                      f"{label}: dynamic_smem {expr!r} does not resolve "
                      f"({e})")
            return size
        if value != size:
            self.flag(where, kernel.line,
                      f"{label}: dynamic smem drift — meta.py says {size} "
                      f"bytes, {expr} is {value} in the sources")
        return max(value, size)


def check(ctx: RepoContext) -> list[Finding]:
    dirs = sorted({p.parent for p in ctx.files
                   if p.name in ("ops.py", "ref.py", "meta.py")
                   and (p.parent / "kernel.cu").is_file()})
    out: list[Finding] = []
    for directory in dirs:
        pkg = _Pkg(ctx, directory)
        pkg.run()
        out.extend(pkg.findings)
    return out


RULE = register(Rule(
    name="kernel-shape",
    invariant="every CUDA kernel package's KERNEL_META agrees with its "
              "sources and wrappers: launch constants, C launcher arity "
              "at every _build.launch, operand and output dtypes, the "
              "plain version's signature, packed padding safety, static "
              "shared memory and launch bounds",
    check=check,
    scope="repo",
    origin="the JAX package's Pallas tiling contracts; the ctypes "
           "launcher boundary of the port's _build",
))
