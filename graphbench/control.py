"""The control of the check that decides ``correct``: the plain reference
put in the program's place, with one guarantee of the configuration
broken, driven through a whole run of a cell. Its check has to come out
as not correct.

    python3 graphbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 30 --mode shallow|reorder|hold

Modes (each breaks one guarantee the configurations state):
  reorder   a batch's lanes are applied in reverse lane order, where the
            store linearizes them in lane order; it shows in the result
            codes wherever two lanes of a batch name one key
  shallow   GetPath searches at most two levels deep, where the store's
            answer is exact; it shows as paths reported missing
  hold      (a ``clients`` mix) every other batch of client c0 is held
            back and applied after that client's next one, where a
            client's batches land in the order it sent them; it shows as
            ``order_wrong``

The reference is the ``ReferenceStore`` of the file the cell's
configuration names. Behind ``submit_client`` it applies one queued batch
a ``pump``, each pump an epoch of its own.

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
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SHALLOW_DEPTH = 2
MODES = ("reorder", "shallow", "hold")


class ReferenceServer:
    """The reference behind the program's serving surface (``submit``,
    ``submit_client`` and ``pump``, ``get_paths``, ``get_metrics``)."""

    def __init__(self, store_cls, graph, capacity: int, n_keys: int,
                 mode: str, churn=(), device="cpu"):
        if mode not in MODES:
            raise ValueError(f"unknown control mode {mode!r}")
        self.store = store_cls(graph.n, n_keys, capacity, graph.u, graph.v,
                               churn, device=device)
        self.mode = mode
        self.queue = []           # tickets in the order they will land
        self.held = None          # hold: client c0's batch held back
        self.epoch = 0
        self.next_id = 0

    def submit(self, ops) -> np.ndarray:
        batch = np.asarray(ops, np.int64).reshape(-1, 3)
        if self.mode != "reorder":
            return self.store.apply_batch(batch)
        return self.store.apply_batch(batch[::-1])[::-1].copy()

    def submit_client(self, client: str, ops):
        t = SimpleNamespace(client_id=str(client), ops=ops, status="queued",
                            epoch=0, batch_id=-1, results=None)
        lands = [t]
        if self.mode == "hold" and t.client_id == "c0":
            if self.held is None:
                self.held, lands = t, []
            else:
                lands, self.held = [t, self.held], None
        for q in lands:
            q.batch_id, self.next_id = self.next_id, self.next_id + 1
            self.queue.append(q)
        return t

    def pump(self) -> int:
        if not self.queue:
            return 0
        t = self.queue.pop(0)
        self.epoch += 1
        t.results, t.epoch, t.status = self.submit(t.ops), self.epoch, "applied"
        return 1

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
    entry = spec.cell(spec.load_benchmark(), workload)
    mix = spec.read_json("traffic", entry["traffic"])
    store_cls = spec.reference_store(spec.read_json("configs",
                                                    entry["config"]))
    held = {}

    def make_server(graph, capacity, device, churn):
        server = ReferenceServer(store_cls, graph, capacity,
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
    ap.add_argument("--mode", choices=MODES, required=True)
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
