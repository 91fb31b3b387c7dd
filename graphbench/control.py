"""The control of the check that decides ``correct``: the plain reference
put in the program's place, with one guarantee of the configuration
broken, driven through a whole run of a cell. Its check has to come out
as not correct.

    python3 graphbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 30 --mode shallow|reorder

Modes (each breaks one guarantee the configurations state):
  reorder   a batch's lanes are applied in reverse lane order, where the
            store linearizes them in lane order; it shows in the result
            codes wherever two lanes of a batch name one key
  shallow   GetPath searches at most two levels deep, where the store's
            answer is exact; it shows as paths reported missing

The benchmark's own runs never run this; it prints one line of readings
(every number compared) per seed. It needs no card: the reference runs on
the host, its searches on the card where there is one, at the cell's own
sizes.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SHALLOW_DEPTH = 2


class ReferenceServer:
    """The reference behind the program's serving surface (``submit``,
    ``get_paths``, ``get_metrics``)."""

    def __init__(self, graph, capacity: int, n_keys: int, mode: str,
                 churn=(), device="cpu"):
        from graphbench.harness.reference import ReferenceStore

        if mode not in ("reorder", "shallow"):
            raise ValueError(f"unknown control mode {mode!r}")
        self.store = ReferenceStore(graph.n, n_keys, capacity, graph.u,
                                    graph.v, churn, device=device)
        self.mode = mode

    def submit(self, ops) -> np.ndarray:
        batch = np.asarray(ops, np.int64).reshape(-1, 3)
        if self.mode != "reorder":
            return self.store.apply_batch(batch)
        return self.store.apply_batch(batch[::-1])[::-1].copy()

    def get_paths(self, pairs):
        depth = SHALLOW_DEPTH if self.mode == "shallow" else None
        return self.store.paths(pairs, max_depth=depth), 2

    def get_metrics(self) -> dict:
        return {"server.grow_events": 0}

    def sets(self):
        st = self.store
        alive = np.flatnonzero(np.frombuffer(bytes(st.alive), np.uint8))
        u, v = st.live_edges()
        ids = u * st.nk + v
        return alive, ids, ids


def run_control(workload: str, seed: int, seconds: float, mode: str,
                log=print) -> dict:
    """One run of ``workload`` with the control in the program's place:
    its result line."""
    import torch

    from graphbench.harness import bench, spec

    device = "cuda" if torch.cuda.is_available() else "cpu"
    mix = spec.read_json("traffic",
                         spec.cell(spec.load_benchmark(), workload)["traffic"])
    held = {}

    def make_server(graph, capacity, device, churn):
        server = ReferenceServer(graph, capacity,
                                 graph.n + int(mix["churn_keys"]), mode,
                                 churn, device)
        held["server"] = server
        return server, server.store.compact

    line, _ = bench.run(workload, seed, seconds, False, device=device,
                        make_server=make_server,
                        final_sets=lambda s: held["server"].sets(), log=log)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--mode", choices=("reorder", "shallow"), required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    for seed in (int(x) for x in args.seeds.split(",")):
        line = run_control(args.workload, seed, args.seconds, args.mode,
                           log=lambda m: print(m, file=sys.stderr))
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "correct": line["correct"],
                          "attempted": line["attempted"],
                          "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
