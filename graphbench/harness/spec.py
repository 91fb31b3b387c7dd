"""Where a cell's pieces live, found by the names in ``BENCHMARK.json``.

A cell ``<config>.<mix>`` reads ``configs/<config>.json`` and
``traffic/<mix>.json``; an end-to-end metric ``<name>`` is computed by
``endtoend/<name>.py`` and a per-layer metric by ``metrics/<name>.py``,
each a module with ``read(ctx)`` that returns a number, or None where it
finds nothing to read. A configuration's ``reference`` key names the file
of its plain reference (relative to the checkout's root), whose
``ReferenceStore`` the check and the control use.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def read_json(kind: str, name: str) -> dict:
    return json.loads((BENCH_DIR / kind / f"{name}.json").read_text())


def metrics_of(bench: dict, kind: str, workload: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that ``workload``
    reports: those without a ``workloads`` key, and those that list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(folder: str, name: str):
    """``read`` of ``graphbench/<folder>/<name>.py``."""
    return _module(
        BENCH_DIR / folder / f"{name}.py",
        f"graphbench_{folder}_{name.replace('.', '_').replace('-', '_')}").read


def reference_store(cfg: dict):
    """``ReferenceStore`` of the file the configuration's ``reference``
    key names."""
    return _module(ROOT / cfg["reference"],
                   f"graphbench_reference_{cfg['name']}".replace(
                       ".", "_").replace("-", "_")).ReferenceStore
