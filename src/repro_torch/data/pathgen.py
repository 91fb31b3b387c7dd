"""Graph -> LM corpus: reachability-query supervision from the live engine;
the port of ``repro.data.pathgen``.

This is the paper-integration workload (DESIGN.md §5(i)): a mutator stream
evolves a concurrent graph (core.ops batches); each training example
serializes the current edge set, a (src, dst) query, and the GetPath answer
obtained from the snapshot engine, teaching an LM the reachability task the
paper's data structure serves, while exercising the engine's concurrent API
as a production data pipeline would.

The graph lives on the training device: on the card, ``get_path`` runs the
``"hybrid_cuda"`` backend, so every example launches the hand-written BFS
kernels: B2 (pull) where the direction test picks pull, as it does at
every superstep at the default sizes (24 vertices in 64 slots), and B3
(push) elsewhere. The random draws are numpy's, as in JAX, so both
packages emit the same tokens.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import (OP_ADD_E, OP_ADD_V, OP_REM_E, apply_ops_fast,
                              get_path, make_graph, make_op_batch)
from repro_torch.core.graph import resolve_device, to_networkx_like
from repro_torch.data import tokenizer as tok


class PathTaskGenerator:
    """Deterministic, restart-safe stream of token examples; the graph on
    the card unless ``device`` names another."""

    def __init__(self, *, n_vertices: int = 24, capacity: int = 64,
                 mutate_lanes: int = 16, seed: int = 0,
                 backend: str | None = None, device=None):
        self.nv = n_vertices
        self.capacity = capacity
        self.lanes = mutate_lanes
        self.backend = backend
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)
        self.state = make_graph(capacity, device=self.device)
        boot = [(OP_ADD_V, k) for k in range(n_vertices)]
        for i in range(0, len(boot), mutate_lanes):
            self.state, _ = apply_ops_fast(
                self.state, self._batch(boot[i:i + mutate_lanes]))

    def _batch(self, ops):
        return make_op_batch(ops, self.lanes, device=self.device)

    def _mutate(self):
        ops = []
        for _ in range(self.lanes):
            u, v = self.rng.integers(0, self.nv, 2)
            op = OP_ADD_E if self.rng.random() < 0.7 else OP_REM_E
            ops.append((op, int(u), int(v)))
        self.state, _ = apply_ops_fast(self.state, self._batch(ops))

    def example(self) -> list[int]:
        self._mutate()
        src, dst = (int(x) for x in self.rng.integers(0, self.nv, 2))
        pr = get_path(self.state, src, dst, backend=self.backend)
        found, length = bool(pr.found), int(pr.length)
        path = pr.keys[:length].tolist() if found else []
        _, edges = to_networkx_like(self.state)
        return tok.encode_example(edges, src, dst, path)

    def batch(self, batch_size: int, seq_len: int):
        """-> tokens int32 [batch, seq_len] padded/truncated (numpy)."""
        out = np.zeros((batch_size, seq_len), np.int32)
        for i in range(batch_size):
            ex = self.example()[:seq_len]
            out[i, : len(ex)] = ex
        return out
