"""What the benchmark loads: no JAX, no JAX package and no old benchmark
in a run; a reference that imports nothing of the program; and a run that
refuses to start without a card."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "graphbench"

CHILD = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from graphbench.harness import bench, spec
orig = spec.read_json
def read_json(kind, name):
    d = orig(kind, name)
    if kind == "configs":
        return dict(d, scale=8, capacity=256 + 512)
    return dict(d, churn_keys=512)
spec.read_json = read_json
line, _ = bench.run("g500-s18.equal-gp2", 5, 0.3, False, device="cpu",
                    log=lambda m: None)
print(json.dumps({{"correct": line["correct"],
                  "tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def _imports(path: Path) -> set:
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_run_loads_no_jax_nor_jax_package():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", CHILD.format(root=str(ROOT),
                                            src=str(ROOT / "src"))],
        capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert "repro_torch" in res["tops"]
    for name in ("jax", "jaxlib", "flax", "repro", "benchmarks"):
        assert name not in res["tops"], name


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_benchmark_imports_no_old_benchmark_nor_jax(path):
    assert not _imports(path) & {"benchmarks", "jax", "jaxlib", "flax",
                                 "repro"}


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "traffic.py", "graph500.py", "check.py",
                 "stats.py", "roofline.py", "spec.py"):
        assert "repro_torch" not in _imports(BENCH / "harness" / name), name
    # every configuration's reference has no import of the program, even
    # deferred, and lies under the benchmark's folder
    refs = {json.loads(p.read_text())["reference"]
            for p in sorted((BENCH / "configs").glob("*.json"))}
    assert "graphbench/harness/reference.py" in refs
    for ref in refs:
        path = (ROOT / ref).resolve()
        assert path.is_file() and BENCH in path.parents, ref
        assert "repro_torch" not in path.read_text(), ref


def test_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA (or with too few cards) the run exits non-zero and
    prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "g500-s18.update", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert out.returncode != 0
    assert "correct" not in out.stdout


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs on the card only")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "g500-s18.update", "--seed", "3", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"


def test_forbidden_modules_named_by_top_level():
    """Whole top-level names are compared: ``repro_torch`` is not
    ``repro``, ``jaxlib.xla_client`` is ``jaxlib``."""
    sys.path.insert(0, str(ROOT))
    from graphbench.harness import bench

    loaded = dict.fromkeys(["numpy", "repro_torch.core.ops", "jaxlib.xla_client",
                            "repro.core", "benchmarks_extra", "flaxen"])
    assert bench.forbidden_modules(loaded) == ["jaxlib", "repro"]
    assert bench.forbidden_modules({"torch": None, "repro_torch": None}) == []


def test_run_fixes_the_allocator(monkeypatch):
    """The run starts again once with glibc's malloc thresholds fixed,
    keeping any tunables it was given, and not again after that."""
    sys.path.insert(0, str(BENCH))
    import run

    calls = []
    monkeypatch.setattr(run.os, "execve",
                        lambda exe, args, env: calls.append((args, env)))
    monkeypatch.setenv("GLIBC_TUNABLES", "glibc.malloc.arena_max=2")
    run.fixed_allocator(["--seed", "1"])
    (args, env), = calls
    assert args[1:] == [str(BENCH / "run.py"), "--seed", "1"]
    assert env["GLIBC_TUNABLES"] == "glibc.malloc.arena_max=2:" + run.ALLOCATOR
    monkeypatch.setenv("GLIBC_TUNABLES", env["GLIBC_TUNABLES"])
    run.fixed_allocator(["--seed", "1"])
    assert len(calls) == 1
