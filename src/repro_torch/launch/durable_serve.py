"""Durable graph serving on the port: WAL-backed ingest with crash/recover.

The port's counterpart of the JAX package's ``launch/serve.py``, with the
same flags and the same JSONL report, plus ``--device`` (default
``cuda``). It runs a multi-client mutation workload through
``GraphCoServer`` with the write-ahead log and cadence checkpoints enabled
(DESIGN.md §16) and writes one fsynced JSON line per admitted round: the
"ack" record a client of this process would hold. Two modes compose into
a kill -9 round trip:

  # serve 12 rounds, checkpoint every 4, SIGKILL ourselves after round 7:
  PYTHONPATH=src python -m repro_torch.launch.durable_serve --wal-dir d \\
      --ckpt-every 4 --steps 12 --crash-at-step 7 --report d/report.jsonl

  # come back up from checkpoint + WAL replay and keep serving:
  PYTHONPATH=src python -m repro_torch.launch.durable_serve --wal-dir d \\
      --recover --steps 3 --report d/report.jsonl

The crash is a real ``os.kill(getpid(), SIGKILL)``: no interpreter
cleanup, no atexit, exactly the failure the WAL discipline claims to
survive. Every round acked before the kill must be in the recovered
linearization, and serving must resume past the crash epoch.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys

import numpy as np

from repro_torch.core.graph import OP_ADD_E, OP_ADD_V, OP_REM_E
from repro_torch.runtime.serve_loop import GraphCoServer


def _report_line(f, payload: dict) -> None:
    """One durable JSONL record: the process may be SIGKILLed right after
    this returns, so flush + fsync before handing the ack on."""
    f.write(json.dumps(payload) + "\n")
    f.flush()
    os.fsync(f.fileno())


def _client_batches(rng: np.random.Generator, clients: int, lanes: int,
                    keys: int) -> list[tuple[str, list]]:
    out = []
    for c in range(clients):
        ops = []
        for _ in range(lanes):
            r = rng.random()
            a, b = (int(x) for x in rng.integers(0, keys, 2))
            if r < 0.35:
                ops.append((OP_ADD_V, a))
            elif r < 0.85:
                ops.append((OP_ADD_E, a, b))
            else:
                ops.append((OP_REM_E, a, b))
        out.append((f"c{c}", ops))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wal-dir", required=True,
                    help="directory for wal.log + ckpt/ (created if absent)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint cadence in admitted rounds (0 = never)")
    ap.add_argument("--steps", type=int, default=8,
                    help="admission rounds to serve")
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--lanes", type=int, default=4,
                    help="ops per client batch")
    ap.add_argument("--keys", type=int, default=24,
                    help="entity key space for the workload")
    ap.add_argument("--capacity", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--crash-at-step", type=int, default=None,
                    help="SIGKILL this process after acking round N")
    ap.add_argument("--recover", action="store_true",
                    help="restore from the wal-dir's checkpoint + WAL "
                         "before serving")
    ap.add_argument("--report", default=None,
                    help="JSONL report path (default: <wal-dir>/report.jsonl)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the graph state (cuda or cpu)")
    args = ap.parse_args(argv)

    os.makedirs(args.wal_dir, exist_ok=True)
    report_path = args.report or os.path.join(args.wal_dir, "report.jsonl")

    srv = GraphCoServer(capacity=args.capacity, ingest=True,
                        wal_dir=args.wal_dir, ckpt_every=args.ckpt_every,
                        device=args.device)
    rng = np.random.default_rng(args.seed + (1000 if args.recover else 0))

    with open(report_path, "a") as rep:
        if args.recover:
            srv.enter_degraded()
            srv.recover_now()
            pool = srv.pool
            _report_line(rep, {
                "type": "recovered",
                "epoch": int(pool.epoch),
                "linearization": [int(b) for b in pool.linearization],
            })
            print(f"recovered at epoch {pool.epoch} "
                  f"({len(pool.linearization)} batches durable)")

        for step in range(args.steps):
            tickets = [srv.submit_client(cid, ops) for cid, ops in
                       _client_batches(rng, args.clients, args.lanes,
                                       args.keys)]
            srv.flush()
            acked = sorted(int(t.batch_id) for t in tickets
                           if t.status == "applied")
            _report_line(rep, {"type": "round", "step": step,
                               "epoch": int(srv.pool.epoch),
                               "acked": acked})
            if args.crash_at_step is not None and step == args.crash_at_step:
                # a real kill -9: no cleanup, no flushes beyond the report
                # line above; exactly what the WAL must survive
                os.kill(os.getpid(), signal.SIGKILL)

        _report_line(rep, {
            "type": "done",
            "epoch": int(srv.pool.epoch),
            "linearization": [int(b) for b in srv.pool.linearization],
        })
    print(f"served {args.steps} rounds to epoch {srv.pool.epoch}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
