"""Run one cell of the port's benchmark once and print its result line.

    python3 graphbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. A cell is ``<config>.<mix>`` of
``BENCHMARK.json``. Set-up builds the configuration's Graph500 graph from
the seed in the program's store (``repro_torch``'s ``GraphCoServer`` on
the card) and warms it with the mix's own rounds; the window then drives
the mix for ``--seconds``; the plain reference checks what the program
answered; the last line of standard output is the result as JSON, and the
numbers compared, each beside its limit, are the last lines of standard
error. Exits 2 without a result where there is no card, or fewer than the
cell asks for, 3 where a forbidden module was loaded, and 4 where set-up
stopped because the configuration asks the server for a setting the
harness does not know or the program refuses (one line on standard error
says which).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "graphbench"
# glibc's malloc thresholds, fixed (the mmap threshold at the most that
# glibc's own rule raises it to): left dynamic, they follow what the run
# has freed so far, and a run's rounds switched between two speeds in the
# middle of its window
ALLOCATOR = ("glibc.malloc.mmap_threshold=33554432:"
             "glibc.malloc.trim_threshold=1073741824")


def cache_env() -> None:
    """Every compiler and kernel cache in fixed directories of the
    checkout (the port's own kernel libraries build under
    ``build/repro_torch_kernels``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(CACHE / sub)


def fixed_allocator(argv: list) -> None:
    """Run this script again, in this process, with ``ALLOCATOR`` in
    ``GLIBC_TUNABLES`` (glibc reads it only when a process starts)."""
    tunables = os.environ.get("GLIBC_TUNABLES", "")
    if ALLOCATOR in tunables:
        return
    env = dict(os.environ,
               GLIBC_TUNABLES=":".join(filter(None, (tunables, ALLOCATOR))))
    os.execve(sys.executable,
              [sys.executable, str(Path(__file__).resolve()), *argv], env)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fixed_allocator(sys.argv[1:] if argv is None else list(argv))
    cache_env()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from graphbench.harness import bench, loop, spec

    chips = spec.cell(spec.load_benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"graphbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    log(f"card: {card_line()}")
    try:
        line, checks = bench.run(args.workload, args.seed, args.seconds,
                                 bool(args.trace), log=log)
    except loop.SetupRefused as exc:
        log(f"graphbench: set-up stopped: {exc}")
        return 4
    found = bench.forbidden_modules()
    if found:
        log(f"graphbench: modules loaded that the run may not load: "
            f"{', '.join(found)}")
        return 3
    for name, (value, limit) in checks.items():
        log(f"check {name} {value} limit {limit}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
