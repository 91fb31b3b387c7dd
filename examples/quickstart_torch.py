"""Quickstart on the PyTorch/CUDA port: the concurrent non-blocking graph in
60 lines; the port of ``examples/quickstart.py``, step for step and line
for line.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Demonstrates the paper's full ADT — batched concurrent mutations from many
logical actors, wait-free lookups, and the obstruction-free double-collect
GetPath — including the §3.5 adversary that version counters catch. On the
card the traversals run through the hand-written BFS kernels.
"""
import argparse


from repro_torch.core import (
    OP_ADD_E, OP_ADD_V, OP_CON_E, OP_REM_E,
    RESULT_NAMES, add_edge, apply_ops_fast, collect, compare_collects,
    contains_vertex, get_path, get_path_session, get_paths_session,
    make_graph, make_op_batch, remove_edge,
)
from repro_torch.core.graph import resolve_device


def keys_of(pr):
    return list(pr.keys.cpu().numpy()[: int(pr.length)])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args().device)

    # -- build a graph with one vectorized batch of 'concurrent' ops ---------
    g = make_graph(64, device=dev)
    ops = [(OP_ADD_V, k) for k in range(8)]
    ops += [(OP_ADD_E, a, b) for a, b in [(0, 1), (1, 2), (2, 3), (3, 7),
                                          (0, 5), (5, 6), (6, 7)]]
    ops += [(OP_CON_E, 0, 1), (OP_ADD_E, 0, 1)]   # conflicting lanes are fine
    g, results = apply_ops_fast(g, make_op_batch(ops, device=dev))
    print("batch results:", [RESULT_NAMES[int(r)] for r in results[-2:]])
    print("contains_vertex(3):", bool(contains_vertex(g, 3)))

    # -- reachability ----------------------------------------------------------
    print("path 0->7:", keys_of(get_path(g, 0, 7)))

    # -- the paper's §3.5 adversary: mutate and restore between collects -----
    # break all paths to 7 first, so GetPath(0,7) explores the full component
    g, _ = remove_edge(g, 3, 7)
    g, _ = remove_edge(g, 6, 7)
    c1 = collect(g, 0, 7)            # not found: every reachable row was read
    g2, _ = add_edge(g, 3, 7)        # adversary briefly creates a path...
    g3, _ = remove_edge(g2, 3, 7)    # ...and removes it again
    c2 = collect(g3, 0, 7)           # same edge set as c1 saw
    print("adjacency identical:", bool((g.adj == g3.adj).all()),
          "| found:", bool(c1.found), bool(c2.found),
          "| double collect matches:", bool(compare_collects(c1, c2)),
          "(False = mutate-and-restore caught by ecnt, paper §3.5)")

    # -- obstruction-free session against a live mutator ---------------------
    g3, _ = add_edge(g3, 6, 7)       # restore a real path for the session demo
    state = {"g": g3}
    calls = {"n": 0}

    def fetch():
        # a mutator toggles an edge under the first two fetches, then quiesces
        if 0 < calls["n"] <= 2:
            op = OP_REM_E if calls["n"] == 1 else OP_ADD_E
            state["g"], _ = apply_ops_fast(
                state["g"], make_op_batch([(op, 5, 6)], device=dev))
        calls["n"] += 1
        return state["g"]

    pr = get_path_session(fetch, 0, 7)
    print(f"session path 0->7 after {int(pr.rounds)} collects "
          f"(>2 means the query retried past concurrent mutations):",
          keys_of(pr))

    # -- batched reachability: Q queries under ONE shared double collect -----
    # the fused multi-source BFS engine advances all frontiers together
    out, rounds = get_paths_session(lambda: state["g"],
                                    [(0, 7), (1, 3), (6, 0)])
    print(f"batched paths after {rounds} shared collects:", out)


if __name__ == "__main__":
    main()
