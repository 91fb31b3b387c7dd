"""Tests for repro_torch.analysis, the port's linter and CUDA kernel
sanitizer (DESIGN.md §15).

Every rule fires on its deliberately-bad fixture at the marked lines
(``# LINT-EXPECT: <rule>``) and is silent on its suppressed twin; each
kernel-shape check trips on a drifted kernel package; unused allows are
reported; the port's ``TRACED_TWINS`` agree with the JAX
package's jit entries; the ptxas check agrees with a saved report of the
H100 build; the linter runs with ``jax`` and ``repro`` blocked; and the
port itself gates clean.
"""
from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import cudasrc, framework, get_rule, modwalk, ptxas
from repro_torch.analysis.rules import kernel_shapes, trace_purity
from repro_torch.analysis.rules.metrics_doc import missing_metrics, section_14

ROOT = Path(__file__).resolve().parent.parent
FIX = ROOT / "tests" / "lint_fixtures_torch"
KERNELS = ROOT / "src" / "repro_torch" / "kernels"
EXPECT_RE = re.compile(r"#\s*LINT-EXPECT:\s*([a-z\-]+)")

# (rule name, fixture stem) for the rules with one fixture file each
FILE_RULES = [
    ("mirror-write", "mirror_write"),
    ("traversable-predicate", "traversable"),
    ("lock-order", "lock_order"),
    ("trace-purity", "trace_purity"),
    ("epoch-freshness", "epoch_freshness"),
    ("design-refs", "design_refs"),
    ("durable-ack", "durable_ack"),
    ("metrics-doc", "metrics_doc"),
]
# drifted kernel package -> what its findings must say
KERNEL_DRIFTS = [
    ("kernel_constant_drift",
     ["constant drift — meta.py says TILE = 64, kernel.cu:9 says 32"]),
    ("kernel_c_args",
     ["c_args mismatch: _launch() passes 3 arguments + the stream to "
      "toy_launch(), which takes 5 C parameters"]),
    ("kernel_unknown_symbol", ["unknown launcher symbol 'toy_lanch'"]),
    ("kernel_operand_dtype",
     ["operand 'x' dtype drift — meta.py says int32, _launch() checks "
      "int64"]),
    ("kernel_output_dtype",
     ["output 'y' dtype drift — meta.py says int32, _launch() allocates "
      "float32"]),
    ("kernel_ref_arity",
     ["toy_ref() takes 2 operands but toy() takes 1",
      "toy_ref() has no option 'wide'"]),
    ("kernel_static_smem",
     ["51360 bytes of static shared memory exceed the 49152-byte static "
      "cap"]),
    ("kernel_min_blocks",
     ["8 blocks x (33056 static + 0 dynamic + 1024 reserved) = 272640 "
      "bytes overflow the SM's 233472 bytes"]),
    ("kernel_dynamic_smem",
     ["4 blocks x (4384 static + 65536 dynamic + 1024 reserved) = 283776 "
      "bytes overflow the SM's 233472 bytes"]),
    ("kernel_dynamic_drift",
     ["dynamic smem drift — meta.py says 32768 bytes, TILE * TILE * 64 is "
      "65536 in the sources"]),
]


def expected_lines(path: Path, rule: str) -> list[int]:
    out = []
    for i, line in enumerate(path.read_text().splitlines(), 1):
        m = EXPECT_RE.search(line)
        if m and m.group(1) == rule:
            out.append(i)
    return out


def run_rule(rule: str, paths: list[Path], root: Path = ROOT):
    return framework.run(root, paths=paths, rules=[get_rule(rule)])


def fixture(stem: str, kind: str) -> tuple[Path, Path, list[Path]]:
    """(analysis root, the file holding the marks, paths to scan)."""
    if stem == "metrics_doc":  # repo-scoped: its fixture is a DESIGN.md
        root = FIX / f"{stem}_{kind}"
        return root, root / "DESIGN.md", []
    path = FIX / f"{stem}_{kind}.py"
    return ROOT, path, [path]


def kernel_pkg(name: str) -> list[Path]:
    return sorted((FIX / name).glob("*.py"))


# ---------------------------------------------------------------------------
# every rule fires on its fixture, at exactly the marked lines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rule,stem", FILE_RULES)
def test_rule_fires_at_marked_lines(rule, stem):
    root, marked, paths = fixture(stem, "bad")
    want = expected_lines(marked, rule)
    assert want, f"fixture {marked} has no LINT-EXPECT markers"
    result = run_rule(rule, paths, root)
    got = sorted({f.line for f in result.findings})
    assert got == want, [f.render() for f in result.findings]
    assert all(f.rule == rule for f in result.findings)


@pytest.mark.parametrize("rule,stem", FILE_RULES)
def test_rule_suppressed_variant_is_silent(rule, stem):
    root, _, paths = fixture(stem, "sup")
    result = run_rule(rule, paths, root)
    assert result.findings == [], [f.render() for f in result.findings]
    assert result.suppressed, "the allow() should have caught a finding"


def test_jax_marker_does_not_silence_the_port(tmp_path):
    """The two linters share the tree, each with its own marker: the JAX
    package's allow is not the port's."""
    path = tmp_path / "one_sided.py"
    jax_allow = "# " + "repro-lint: allow(mirror-write)"
    path.write_text(f"def f(state, adj):\n"
                    f"    return state._replace(adj_packed=adj)  "
                    f"{jax_allow}\n")
    result = run_rule("mirror-write", [path], tmp_path)
    assert [f.line for f in result.findings] == [2]
    assert not framework.ALLOW_RE.search(jax_allow)


# ---------------------------------------------------------------------------
# kernel-shape: one drifted package per check
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,messages", KERNEL_DRIFTS)
def test_kernel_shape_fires_on_drifted_package(name, messages):
    assert (FIX / name / "kernel.cu").is_file()
    result = run_rule("kernel-shape", kernel_pkg(name))
    got = " | ".join(f.message for f in result.findings)
    for m in messages:
        assert m in got, [f.render() for f in result.findings]
    assert all(f.path.startswith(f"tests/lint_fixtures_torch/{name}/")
               for f in result.findings)
    # the ops.py/ref.py-anchored findings land on the marked lines
    for py in kernel_pkg(name):
        want = set(expected_lines(py, "kernel-shape"))
        lines = {f.line for f in result.findings
                 if f.path.endswith(f"{name}/{py.name}")}
        assert want <= lines, (py.name, want, lines)


def test_kernel_shape_consistent_package_is_silent():
    result = run_rule("kernel-shape", kernel_pkg("kernel_pkg_ok"))
    assert result.findings == [], [f.render() for f in result.findings]


def test_kernel_shape_suppressed_variant_is_silent():
    result = run_rule("kernel-shape", kernel_pkg("kernel_pkg_sup"))
    assert result.findings == [], [f.render() for f in result.findings]
    assert [f.message.split(":")[0] for f in result.suppressed] == [
        "c_args mismatch"]


def _copy_package(tmp_path: Path, name: str) -> Path:
    dst = tmp_path / "kernels" / name
    shutil.copytree(KERNELS / name, dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def test_list_mutation_trips_constant_drift_and_static_cap(tmp_path):
    """B2's LIST 256 -> 512 on a copy: meta.py's LIST drifts, and pull_rows
    needs 58,628 bytes of static shared memory, over the 48 KB cap."""
    pkg = _copy_package(tmp_path, "bfs_pull_step")
    cu = pkg / "kernel.cu"
    src = cu.read_text()
    assert "constexpr int LIST = 256;" in src
    cu.write_text(src.replace("constexpr int LIST = 256;",
                              "constexpr int LIST = 512;"))
    result = run_rule("kernel-shape", sorted(pkg.glob("*.py")), tmp_path)
    got = " | ".join(f.message for f in result.findings)
    assert "constant drift — meta.py says LIST = 256" in got
    assert "says 512" in got
    assert ("58628 bytes of static shared memory exceed the 49152-byte "
            "static cap") in got
    assert "meta.py says 46340 bytes, the __shared__ declarations take " \
           "58628" in got
    # unmutated, the copy is clean
    cu.write_text(src)
    assert run_rule("kernel-shape", sorted(pkg.glob("*.py")),
                    tmp_path).findings == []


def test_group_mutation_trips_dynamic_residency(tmp_path):
    """B6's GROUP 64 -> 128 on a copy: dense_push<true> asks for 133,120
    bytes of dynamic shared memory a block, and 3 blocks an SM no longer
    fit although its static shared memory did not change."""
    pkg = _copy_package(tmp_path, "bfs_multi_step")
    cuh = pkg / "dense.cuh"
    src = cuh.read_text()
    assert "constexpr int GROUP = 64;" in src
    cuh.write_text(src.replace("constexpr int GROUP = 64;",
                               "constexpr int GROUP = 128;"))
    result = run_rule("kernel-shape", sorted(pkg.glob("*.py")), tmp_path)
    got = " | ".join(f.message for f in result.findings)
    assert "dense::dense_push<true>: dynamic smem drift — meta.py says " \
           "67584 bytes, SLICE * 8 + GROUP * SLICE * 4 is 133120" in got
    assert "dense::dense_push<true>: 3 blocks x (0 static + 133120 " \
           "dynamic + 1024 reserved) = 402432 bytes overflow" in got
    assert "dense::dense_push<false>" not in got
    cuh.write_text(src)
    assert run_rule("kernel-shape", sorted(pkg.glob("*.py")),
                    tmp_path).findings == []


@pytest.mark.parametrize("drop", ["dynamic_smem", "dynamic_smem_bytes"])
def test_undeclared_dynamic_smem_is_a_finding(tmp_path, drop):
    """one_block declares extern __shared__: its meta must give both the
    expression and its value."""
    pkg = _copy_package(tmp_path, "edge_update")
    meta = pkg / "meta.py"
    text = meta.read_text()
    lines = [ln for ln in text.splitlines(keepends=True)
             if f'"{drop}":' not in ln]
    assert len(lines) == len(text.splitlines()) - 1
    meta.write_text("".join(lines))
    result = run_rule("kernel-shape", sorted(pkg.glob("*.py")), tmp_path)
    got = [f.message for f in result.findings]
    assert len(got) == 2 and all(
        "declares extern __shared__; give the most a launch requests" in m
        for m in got), got


def test_constants_resolve_by_namespace(tmp_path):
    """bfs_step's unit holds single::SLICE (16) and dense::SLICE (256): a
    bare SLICE names neither, and the finding lists both."""
    pkg = _copy_package(tmp_path, "bfs_step")
    _copy_package(tmp_path, "bfs_multi_step")   # the headers it includes
    meta = pkg / "meta.py"
    meta.write_text(meta.read_text().replace('"single::SLICE": 16',
                                             '"SLICE": 16'))
    result = run_rule("kernel-shape", sorted(pkg.glob("*.py")), tmp_path)
    assert [f.message for f in result.findings] == [
        "bfs_step_packed_launch: constant SLICE is not a constexpr of the "
        "sources (by namespace: dense::SLICE, single::SLICE)"]


def test_cudasrc_reads_the_port_sources():
    step = cudasrc.read_unit(KERNELS / "bfs_step" / "kernel.cu")
    assert [f.name for f in step.files] == ["kernel.cu", "dense.cuh",
                                            "push.cuh"]
    assert step.constant("single::SLICE") == 16
    assert step.constant("dense::SLICE") == 256
    assert step.constant("dense::UNROLL", [1]) == 4
    assert step.constant("dense::UNROLL", [0]) == 8
    with pytest.raises(cudasrc.Unresolved):
        step.constant("dense::UNROLL")
    assert step.static_smem(step.kernels["single::push_single"], {}) == 19808
    assert step.c_functions["bfs_step_packed_launch"].n_params == 10
    pull = cudasrc.read_unit(KERNELS / "bfs_pull_step" / "kernel.cu")
    rows = pull.kernels["pull_rows"]
    env = cudasrc.bind(rows.tparams, "<true, false>")
    assert env == {"VEC": 1, "PARENTS": 0}
    assert pull.static_smem(rows, env) == 46340
    assert pull.launch_bounds(rows, env) == (256, 4)
    assert pull.c_functions["bfs_pull_step_launch"].n_params == 12
    dense = cudasrc.read_unit(KERNELS / "bfs_multi_step" / "kernel.cu")
    push = dense.kernels["dense::dense_push"]
    assert push.dynamic
    assert dense.launch_bounds(push, {"PARENTS": 1}) == (256, 3)
    assert dense.launch_bounds(push, {"PARENTS": 0}) == (256, 2)


def test_every_launch_site_matches_its_launcher():
    """The 10 ``_build.launch`` sites of the port's ops.py files, resolved
    through their wrappers' callers to 12 launchers, each pass the C
    parameter count of their launcher less the stream."""
    sites = []
    for ops in sorted(KERNELS.glob("*/ops.py")):
        unit = cudasrc.read_unit(ops.parent / "kernel.cu")
        tree = ast.parse(ops.read_text())
        calls = {id(c) for c in ast.walk(tree) if isinstance(c, ast.Call)
                 and ast.unparse(c.func) == "_build.launch"}
        found = kernel_shapes.launch_sites(tree)
        assert {id(s.call) for s in found} == calls
        for s in found:
            assert s.package == ops.parent.name
            assert s.n_args + 1 == unit.c_functions[s.launcher].n_params
            # a site by where it stands: an id() of a node of a tree
            # already freed may be taken again by the next file's nodes
            sites.append(((ops.parent.name, s.call.lineno,
                           s.call.col_offset), s.launcher))
    assert len({c for c, _ in sites}) == 10
    assert len({name for _, name in sites}) == 12


def test_every_kernel_package_has_a_meta():
    for cu in sorted(KERNELS.glob("*/kernel.cu")):
        meta, _, problem = kernel_shapes.read_meta(cu.parent / "meta.py")
        assert meta is not None, (cu.parent.name, problem)
        assert meta["package"] == cu.parent.name
        assert meta["smem_budget_bytes"] == {"static": 49152,
                                             "dynamic": 232448}


# ---------------------------------------------------------------------------
# unused allows
# ---------------------------------------------------------------------------
def test_unused_suppression_is_flagged():
    path = FIX / "unused_allow.py"
    want = expected_lines(path, "unused-suppression")
    result = run_rule("mirror-write", [path])
    assert [f.line for f in result.findings] == want
    assert result.findings[0].rule == framework.UNUSED_SUPPRESSION


def test_unused_check_scoped_to_active_rules():
    # running a DIFFERENT rule must not call the mirror-write allow dead
    result = run_rule("design-refs", [FIX / "unused_allow.py"])
    assert result.findings == [], [f.render() for f in result.findings]


# ---------------------------------------------------------------------------
# metrics-doc, trace-purity twins, mirror-write positions
# ---------------------------------------------------------------------------
def test_missing_metrics_core():
    doc = "## §14 — metrics\n\n| `ingest.batches` |\n\n## §1 — other\n"
    assert section_14(doc).startswith("## §14")
    assert missing_metrics(["ingest.batches"], doc) == []
    assert missing_metrics(["serve.lost"], doc) == ["serve.lost"]
    assert missing_metrics(["a", "b"], "no section") == ["a", "b"]


def _jax_twins() -> dict[str, tuple[str, ...]]:
    """Port module -> the names it defines whose JAX twins are jit entry
    points, by the JAX package's own ``jit_entry_names``."""
    from repro.analysis import astutil as jax_astutil

    out = {}
    jax_src = ROOT / "src" / "repro"
    for path in sorted(jax_src.rglob("*.py")):
        rel = path.relative_to(jax_src)
        twin = ROOT / "src" / "repro_torch" / rel
        if rel.parts[0] == "analysis" or not twin.is_file():
            continue
        entries = jax_astutil.jit_entry_names(ast.parse(path.read_text()))
        defs = {n.name for n in ast.walk(ast.parse(twin.read_text()))
                if isinstance(n, ast.FunctionDef)}
        if entries & defs:
            out[twin.relative_to(ROOT).as_posix()] = tuple(
                sorted(entries & defs))
    return out


def test_traced_twins_match_jax_jit_entries():
    want = _jax_twins()
    assert sum(len(v) for v in want.values()) == 31
    assert {k: tuple(sorted(v)) for k, v in
            trace_purity.TRACED_TWINS.items()} == want


def test_renamed_twins_are_jax_jit_entries():
    from repro.analysis import astutil as jax_astutil

    for rel, renamed in trace_purity.RENAMED_TWINS.items():
        port = ast.parse((ROOT / rel).read_text())
        jax_rel = rel.replace("src/repro_torch/", "src/repro/")
        entries = jax_astutil.jit_entry_names(
            ast.parse((ROOT / jax_rel).read_text()))
        defs = {n.name for n in ast.walk(port)
                if isinstance(n, ast.FunctionDef)}
        for name, jax_names in renamed.items():
            assert name in defs, (rel, name)
            for j in jax_names:
                assert j in entries and j not in defs, (rel, j)


def test_trace_purity_roots():
    tree = ast.parse((FIX / "trace_purity_bad.py").read_text())
    roots = trace_purity.device_entries("x.py", tree, {})
    assert sorted(roots) == ["_Scale.backward", "_Scale.forward"]
    ops = "src/repro_torch/kernels/label_join/ops.py"
    roots = trace_purity.device_entries(ops, ast.parse(
        (ROOT / ops).read_text()), {})
    assert {"label_join", "label_join_slots", "_launch"} <= set(roots)


def test_mirror_write_positions_match_graph_state():
    from repro_torch.core.graph import GraphState
    from repro_torch.analysis.rules import mirror_write

    assert GraphState._fields.index("adj_packed") == mirror_write.ADJ_POS
    assert GraphState._fields.index("adj_in_packed") == \
        mirror_write.ADJ_IN_POS


# ---------------------------------------------------------------------------
# ptxas report vs KERNEL_META
# ---------------------------------------------------------------------------
SAMPLE = FIX / "ptxas"
SAMPLE_LIBS = {p.stem: p.with_suffix(".so")
               for p in sorted(SAMPLE.glob("*.log"))}


@pytest.mark.parametrize("mangled,name", [
    ("_ZN41_GLOBAL__N__b1d2d167_9_kernel_cu_1a294ec49pull_rowsILb1ELb0EEEv"
     "PKjS2_PKiS2_PKhS6_iiibPhPi", "pull_rows<true, false>"),
    ("_ZN5dense10dense_pushILb1EEEvPKyPKiS4_PKhiiibS6_S6_PhPi",
     "dense::dense_push<true>"),
    ("_ZN6single11push_singleEPKhPKjS1_S1_iibbPhPiPj",
     "single::push_single"),
    ("_ZN41_GLOBAL__N__0a1b2c3d_9_kernel_cu_0a1b2c3d17label_join_kernelILi8E"
     "Li4EEEvPKiS2_iiPiS3_", "label_join_kernel<8, 4>"),
    ("_Z10wide_clearPvi", "wide_clear"),
    ("not_mangled", "not_mangled"),
])
def test_ptxas_demangle(mangled, name):
    assert ptxas.demangle(mangled) == name


def test_ptxas_sample_report_matches_meta():
    """The saved ``ptxas -v`` report of the seven libraries, built for
    sm_90a with ``_build.NVCC_FLAGS`` from this tree's sources, agrees
    with every KERNEL_META. A change to a kernel's sources refreshes the
    sample from its build's ``.log`` files."""
    assert sorted(SAMPLE_LIBS) == sorted(p.parent.name for p in
                                         KERNELS.glob("*/kernel.cu"))
    rows, failures = ptxas.check_build(SAMPLE_LIBS)
    assert failures == []
    assert len(rows) == 48
    by = {(r["package"], r["kernel"]): r for r in rows}
    assert by["bfs_pull_step", "pull_rows<true, true>"]["smem"] == 46340
    assert by["bfs_step", "single::push_single"]["smem"] == 19808
    assert by["bfs_multi_step", "dense::dense_push<true>"]["registers"] == 80
    assert by["bfs_step", "dense::dense_push<true>"]["owner"] == \
        "bfs_multi_step"
    assert by["path_walk", "walk_paths"]["smem"] == 0


@pytest.mark.parametrize("case", ["smem", "registers", "unknown", "missing",
                                  "no_log"])
def test_ptxas_check_fails_on_drift(tmp_path, case):
    libs = {}
    for pkg, lib in SAMPLE_LIBS.items():
        shutil.copy(lib.with_suffix(".log"), tmp_path / f"{pkg}.log")
        libs[pkg] = tmp_path / f"{pkg}.so"
    log = tmp_path / "bfs_pull_step.log"
    text = log.read_text()
    if case == "smem":
        text = text.replace("4224 bytes smem", "4240 bytes smem")
        want = "transpose_frontier takes 4240 bytes"
    elif case == "registers":
        text = text.replace("Used 58 registers", "Used 72 registers")
        want = "uses 72 registers, over its max_registers 64"
    elif case == "unknown":
        text = text.replace("18transpose_frontier", "18transpose_frontiez")
        want = "transpose_frontiez"
    elif case == "missing":
        keep = [ln for ln in text.splitlines(keepends=True)
                if "transpose_frontier" not in ln]
        text = "".join(keep)
        want = "declares transpose_frontier, which is not in the ptxas report"
    else:
        want = "no ptxas report"
    log.write_text(text)
    if case == "no_log":
        log.unlink()
    rows, failures = ptxas.check_build(libs)
    assert any(want in f for f in failures), failures


def test_ptxas_render_on_the_sample():
    rows, _ = ptxas.check_build(SAMPLE_LIBS)
    out = "\n".join(ptxas.render(r) for r in rows)
    assert "bfs_pull_step: pull_rows<true, true>: smem 46340 B (meta 46340)" \
           ", 58 registers (cap 64), spills 0/0 B" in out


# ---------------------------------------------------------------------------
# modwalk, CLI and the repo-wide gate
# ---------------------------------------------------------------------------
def test_modwalk_preflight():
    mods = dict(modwalk.iter_package_modules(
        ROOT / "src" / "repro_torch" / "analysis", "repro_torch.analysis"))
    assert {"repro_torch.analysis", "repro_torch.analysis.rules.lock_order",
            "repro_torch.analysis.ptxas"} <= set(mods)
    names = [m for m in mods if not m.endswith("__main__")]
    assert modwalk.preflight_imports(names) == []
    errors = modwalk.preflight_imports(["repro_torch.no_such_module",
                                        "repro_torch.analysis"])
    assert len(errors) == 1 and "import failed" in errors[0]


def test_cli_json_output(capsys):
    from repro_torch.analysis.cli import main
    rc = main(["--root", str(ROOT), "--rule", "mirror-write",
               "--json",
               str(FIX / "mirror_write_bad.py")])
    data = json.loads(capsys.readouterr().out)
    assert rc == 1 and data["ok"] is False and data["findings"]
    assert data["rules"] == ["mirror-write"]


def test_cli_list_rules(capsys):
    from repro_torch.analysis.cli import main
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in framework.all_rules():
        assert rule.name in out
    assert len(framework.all_rules()) == 9


def test_repo_gates_clean():
    """The acceptance criterion itself: the port's files have zero live
    findings."""
    result = framework.run(ROOT)
    assert result.findings == [], [f.render() for f in result.findings]
    assert result.files_scanned > 100
    assert len(result.rules_run) == 9
    scanned = {str(p.relative_to(ROOT)) for p in framework.default_files(
        ROOT)}
    assert "chip_smoke.py" in scanned
    assert not any(p.startswith(("src/repro/", "tests/lint_fixtures"))
                   for p in scanned)


def test_linter_runs_without_jax():
    """With ``jax`` and ``repro`` unimportable the linter still gates the
    tree: it imports neither (the card's machine has no jax)."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "from repro_torch.analysis.cli import main\n"
            f"rc = main(['--root', {str(ROOT)!r}])\n"
            "assert not [m for m, mod in sys.modules.items()\n"
            "            if mod is not None and (m in ('jax', 'repro') or\n"
            "            m.startswith(('jax.', 'repro.')))], 'imported jax'\n"
            "sys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={**__import__("os").environ,
                               "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "9 rules, 0 findings" in proc.stdout
