"""Distributed graph example on the PyTorch/CUDA port: row-sharded state,
collective BFS, owner-routed mutations — the paper's algorithm as a
multi-device service; the port of ``examples/distributed_graph.py``.

    PYTHONPATH=src python examples/distributed_graph_torch.py
    PYTHONPATH=src python examples/distributed_graph_torch.py --device cpu

The port's graph mesh is single-controller, like JAX's ``shard_map``: one
process holds every shard. ``--shards`` row blocks (default 8) are placed
round-robin over the visible cards (``core.distributed.make_graph_mesh``),
so on one card all eight share it and the collectives move nothing; a
mesh of several cards runs the same code.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (
    OP_ADD_E, OP_ADD_V, OP_REM_E, GraphOracle, make_graph, make_op_batch,
)
from repro_torch.core.distributed import (
    dapply_ops, dget_path_session, make_graph_mesh, shard_graph,
)
from repro_torch.core.graph import resolve_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=8)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    devices = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if dev.type == "cuda" else [dev])
    print(f"devices: {len(devices)}")
    mesh = make_graph_mesh(devices, shards=args.shards)
    g = shard_graph(mesh, make_graph(128, device=mesh.device))
    oracle = GraphOracle(128)
    rng = np.random.default_rng(0)

    ops = [(OP_ADD_V, k, -1, -1) for k in range(32)]
    ops += [((OP_ADD_E if rng.random() < 0.8 else OP_REM_E),
             int(a), int(b), -1) for a, b in rng.integers(0, 32, (96, 2))]
    for i in range(0, len(ops), 16):
        chunk = ops[i:i + 16]
        g, res = dapply_ops(mesh, g, make_op_batch(chunk, device=mesh.device))
        want = oracle.apply_batch(chunk)
        assert [int(x) for x in res.cpu().numpy()] == want
    print(f"applied {len(ops)} owner-routed ops across "
          f"{mesh.size} shard(s); results match the oracle")

    hits = 0
    for (s, d) in [(0, 31), (5, 9), (30, 2), (1, 17)]:
        ok, n, keys, rounds = dget_path_session(mesh, lambda: g, s, d)
        assert ok == oracle.reachable(s, d)
        status = "->".join(map(str, keys)) if ok else "unreachable"
        print(f"GetPath({s},{d}) [{rounds} collects, psum-validated]: "
              f"{status}")
        hits += ok
    print(f"{hits}/4 reachable; distributed double-collect verified vs "
          "oracle")


if __name__ == "__main__":
    main()
