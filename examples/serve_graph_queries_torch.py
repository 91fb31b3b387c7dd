"""Serving example on the PyTorch/CUDA port: batched LM decode co-hosted
with non-blocking graph queries; the port of
``examples/serve_graph_queries.py``.

    PYTHONPATH=src python examples/serve_graph_queries_torch.py
    PYTHONPATH=src python examples/serve_graph_queries_torch.py --device cpu

The serving runtime interleaves three traffic classes with zero locking:
LM decode steps, graph mutation batches, and snapshot-consistent
reachability queries. With ``index=True`` the server additionally maintains
a versioned 2-hop reachability index (DESIGN.md §9): query batches are
answered from the index whenever its epoch stamp matches the live version
metadata and fall back to the paper's obstruction-free BFS protocol after
mutations, while ``serve`` refreshes the index in the gaps between decode
steps. Reports decode throughput, per-query collect rounds, and the index
hit/miss/refresh balance. The graph traffic is drawn from the same numpy
seed as the JAX example's, so its answers are the same; the LM's weights
are the port's own draw.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import OP_ADD_E, OP_ADD_V, OP_REM_E
from repro_torch.core.graph import resolve_device
from repro_torch.models.model import build_model
from repro_torch.runtime.serve_loop import GraphCoServer, serve


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args().device)
    cfg = get_config("qwen2-1.5b").smoke()
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0))
    rng = np.random.default_rng(0)

    graph = GraphCoServer(capacity=128, index=True, device=dev)
    graph.submit([(OP_ADD_V, k) for k in range(24)])
    graph.submit([(OP_ADD_E, int(a), int(b))
                  for a, b in rng.integers(0, 24, (40, 2))])

    def mutator(i):
        if i % 4 != 3:        # read-heavy mix: mutate every 4th step only
            return []
        a, b = (int(x) for x in rng.integers(0, 24, 2))
        return [(OP_ADD_E if rng.random() < 0.6 else OP_REM_E, a, b)]

    def queries(i):
        if i % 3 == 1:        # a BATCH of pairs: index-served when fresh
            return [tuple(int(x) for x in rng.integers(0, 24, 2))
                    for _ in range(4)]
        return None

    prompts = rng.integers(0, cfg.vocab, (4, 12)).astype(np.int32)
    out, stats = serve(model, params, prompts, max_new_tokens=24,
                       cache_len=64, graph=graph, mutator=mutator,
                       query_stream=queries)
    print(f"decoded {stats.decode_tokens} tokens in {stats.wall_s:.2f}s "
          f"({stats.decode_tokens / stats.wall_s:.1f} tok/s)")
    print(f"graph mutations applied: {stats.graph_ops}")
    print(f"reachability queries: {stats.getpath_calls} "
          f"(index hits {stats.index_hits}, BFS fallbacks "
          f"{stats.index_misses}, refreshes {stats.index_refreshes})")
    counts = graph.get_reach_counts(list(range(6)))
    print(f"reachable-set sizes of vertices 0..5: {list(counts)}")


if __name__ == "__main__":
    main()
