#!/usr/bin/env python3
"""Time the port's plain LM paths (no mesh) against a parent commit's, on
one NVIDIA GPU: the host cost of the model code on the paths
``chip_smoke.py`` phases 11-13 drive.

    git archive <parent> | tar -x -C build/parent
    python3 tools/ab_lm_host.py --parent build/parent [--seed 0]

Each tree runs in a child process of its own (the two packages share a
name), in turns parent, change, change, parent. A child measures, at
each config's published width in bfloat16 with random weights from
``--seed``:
- the decode step of qwen2-1.5b, olmoe-1b-7b and mamba2-780m: 8 prompts
  of 512 random tokens prefilled into a 1,024-slot cache, 4 untimed
  steps, then the wall of each of 32 greedy steps (the argmax and a
  synchronize included), as phases 11 and 12 time them;
- the train step of qwen2-1.5b (``launch.steps.make_train_step``, remat,
  lr 3e-4) on 8 x 512 random tokens: 2 untimed steps, then the wall of
  each of 6 (the loss read back included), as phase 13 times them
  without its data source.
After its timed steps a child runs one more step of each under a
``TorchDispatchMode`` that counts the aten ops it dispatches and a
``sys.setprofile`` hook that counts the Python calls it makes: counts
that the host's load does not move, as walls on a shared host do.
No graph kernel runs on these paths, so nothing is built. Prints one
line per metric (median and p90 of each run, and the counts) and writes
every step's wall to ``build/ab_lm_host.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "ab_lm_host.json"
DECODE_ARCHS = ("qwen2-1.5b", "olmoe-1b-7b", "mamba2-780m")
TRAIN_ARCH = "qwen2-1.5b"
BATCH, PROMPT, CACHE, WARM, STEPS = 8, 512, 1024, 4, 32
TRAIN_SEQ, TRAIN_WARM, TRAIN_STEPS, LR = 512, 2, 6, 3e-4
CHILD_TIMEOUT_S = 600


def counted(fn) -> dict:
    """``fn()``, counting the aten ops it dispatches and the Python calls
    it makes (C functions not included); called twice, the first call
    taking what a first use imports and caches."""
    _count(fn)
    return _count(fn)


def _count(fn) -> dict:
    from torch.utils._python_dispatch import TorchDispatchMode

    n = {"aten_ops": 0, "py_calls": 0}

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            n["aten_ops"] += 1
            return func(*args, **(kwargs or {}))

    def prof(frame, event, arg):
        if event == "call":
            n["py_calls"] += 1

    with Ops():
        sys.setprofile(prof)
        try:
            fn()
        finally:
            sys.setprofile(None)
    n["py_calls"] -= 1            # the hook's own ``finally`` frame
    return n


def child(tree: Path, seed: int) -> dict:
    """Every metric of one tree, in this process: {metric: step walls},
    and under "counts" {metric: aten ops and Python calls of one step}."""
    sys.path.insert(0, str(tree / "src"))
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models.model import build_model

    def sync():
        torch.cuda.synchronize()

    out = {"counts": {}}
    for arch in DECODE_ARCHS:
        model = build_model(get_config(arch))
        params = model.init(torch.Generator("cuda").manual_seed(seed))
        g = torch.Generator("cuda").manual_seed(seed + 1)
        toks = torch.randint(0, model.cfg.vocab, (BATCH, PROMPT),
                             generator=g, device="cuda", dtype=torch.int32)
        walls = []
        with torch.inference_mode():
            last, caches = model.prefill(params, {"tokens": toks})
            caches = model.cache_from_prefill(caches, CACHE)
            tok = torch.argmax(last, dim=-1).to(torch.int32)
            for i in range(WARM + STEPS):
                sync()
                t0 = time.perf_counter()
                logits, caches = model.decode_step(params, caches, tok,
                                                   PROMPT + i)
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
                sync()
                if i >= WARM:
                    walls.append((time.perf_counter() - t0) * 1e3)
            out["counts"][f"decode {arch}"] = counted(
                lambda: model.decode_step(params, caches, tok,
                                          PROMPT + WARM + STEPS))
        out[f"decode {arch}"] = walls
        del model, params, caches, logits, last, tok
        torch.cuda.empty_cache()

    model = build_model(get_config(TRAIN_ARCH))
    params = model.init(torch.Generator("cuda").manual_seed(seed))
    opt = steps_mod.init_opt_state(params)
    step = steps_mod.make_train_step(model, lr=LR, remat=True)
    g = torch.Generator("cuda").manual_seed(seed + 2)
    walls = []
    for i in range(TRAIN_WARM + TRAIN_STEPS + 1):
        toks = torch.randint(0, model.cfg.vocab, (BATCH, TRAIN_SEQ),
                             generator=g, device="cuda", dtype=torch.int32)
        sync()
        if i == TRAIN_WARM + TRAIN_STEPS:
            out["counts"][f"train {TRAIN_ARCH}"] = counted(
                lambda: step(params, opt, {"tokens": toks}))
            break
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, {"tokens": toks})
        float(m["loss"])
        if i >= TRAIN_WARM:
            walls.append((time.perf_counter() - t0) * 1e3)
    out[f"train {TRAIN_ARCH}"] = walls
    return out


def run_child(tree: Path, seed: int) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, __file__, "--child", str(tree), "--seed", str(seed)],
        env=env, capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
    if res.returncode != 0:
        raise SystemExit(f"child on {tree} failed ({res.returncode}):\n"
                         + res.stderr[-4000:])
    return json.loads(res.stdout.strip().splitlines()[-1])


def p90(xs) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(0.9 * (len(xs) - 1))))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(child(args.child.resolve(), args.seed)))
        return 0
    if args.parent is None:
        ap.error("--parent is required")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ab_lm_host.py needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    order = [("parent", args.parent.resolve()), ("change", ROOT),
             ("change", ROOT), ("parent", args.parent.resolve())]
    runs = []
    for name, tree in order:
        t0 = time.perf_counter()
        runs.append({"tree": name, "walls": run_child(tree, args.seed),
                     "child_s": time.perf_counter() - t0})
    print(f"card: {card}; order: " + ", ".join(n for n, _ in order))
    for metric in runs[0]["walls"]["counts"]:
        cells = [f"{r['tree']} {statistics.median(r['walls'][metric]):.3f}"
                 f" / {p90(r['walls'][metric]):.3f}" for r in runs]
        print(f"{metric} ms, median / p90: " + "; ".join(cells))
        counts = [f"{r['tree']} {r['walls']['counts'][metric]['aten_ops']}"
                  f" / {r['walls']['counts'][metric]['py_calls']}"
                  for r in runs]
        print(f"{metric}, one step's aten ops / Python calls: "
              + "; ".join(counts))
    print("child wall s: " + ", ".join(f"{r['tree']} {r['child_s']:.1f}"
                                       for r in runs))
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({"card": card, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
