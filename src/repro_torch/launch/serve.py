"""Serving launcher: batched LM decode co-hosted with graph queries; the
port of ``repro.launch.serve`` with the same flags and the same lines,
plus ``--device`` (default ``cuda``) and ``--seed``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --smoke --batch 4 --new 32 [--device cpu]

``--ingest`` switches the graph side to the multi-tenant admission pool
(DESIGN.md §12) and exercises the retained epoch ring (DESIGN.md §13):
several simulated clients stream conflicting mutation batches, query
sessions resolve wait-free against the published epoch when starved, and
after the decode loop the launcher issues time-travel reachability and
epoch-diff queries against retained (and one evicted) epochs.

``--seed`` seeds both the params' ``torch.Generator`` (on ``--device``)
and the numpy stream of prompts and graph traffic; at 0 the traffic is
the JAX launcher's. Without a card the default ``--device cuda`` fails:
there is no fallback to the CPU.

``REPRO_TRACE=1`` arms the observability recorder (DESIGN.md §14): the
run writes a Perfetto-loadable trace (``REPRO_TRACE_PATH``, default
``repro_trace.json``) and a ``get_metrics`` dump.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.graph import OP_ADD_E, OP_ADD_V, resolve_device
from repro_torch.models.model import build_model
from repro_torch.obs import trace
from repro_torch.runtime.serve_loop import GraphCoServer, serve


def _demo_epoch_ring(graph: GraphCoServer, rng) -> None:
    """Post-serve tour of the epoch-ring endpoints (DESIGN.md §13)."""
    lo, hi = graph.epoch_window()
    mid = (lo + hi) // 2
    u, v = (int(x) for x in rng.integers(0, 16, 2))
    tt = graph.get_reach_at([(u, v)], mid)
    print(f"time-travel: reach({u},{v}) at epoch {mid} -> "
          f"{'evicted' if tt.evicted else bool(tt.found[0])} "
          f"(window {lo}..{hi})")
    gone = graph.get_reach_at([(u, v)], lo - 1)
    print(f"time-travel: epoch {lo - 1} -> "
          f"{'evicted' if gone.evicted else 'retained?!'} (typed, no raise)")
    d = graph.epoch_diff(mid, hi)
    print(f"epoch-diff {mid}->{hi}: {len(d.rows)} rows touched")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="tiny config (default; --no-smoke for full size)")
    ap.add_argument("--index", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="maintain the 2-hop reachability index "
                         "(DESIGN.md §9) so queries take the index fast "
                         "path / ring-validate / fallback routes")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--ingest", action="store_true",
                    help="multi-tenant admission pool + epoch-ring demo "
                         "(DESIGN.md §12, §13)")
    ap.add_argument("--clients", type=int, default=3,
                    help="simulated mutation clients under --ingest")
    ap.add_argument("--retain-epochs", type=int, default=16,
                    help="epoch-ring retention window under --ingest")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the params and the graph state "
                         "(cuda or cpu)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the params' generator and of the traffic")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(args.seed))

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)

    graph = GraphCoServer(ingest=args.ingest, index=args.index,
                          retain_epochs=args.retain_epochs, device=dev)
    for k in range(16):
        graph.submit([(OP_ADD_V, k)])

    def mutator(i):
        u, v = rng.integers(0, 16, 2)
        return [(OP_ADD_E, int(u), int(v))]

    def clients(i):
        # every decode step each tenant streams one edge batch; overlapping
        # entity footprints force admission conflicts so the coalescing and
        # retry paths (and the epoch ring behind them) get exercised
        batches = []
        for c in range(args.clients):
            u, v = rng.integers(0, 16, 2)
            batches.append((f"tenant{c}", [(OP_ADD_E, int(u), int(v))]))
        return batches

    def queries(i):
        if i % 4 == 0:
            u, v = rng.integers(0, 16, 2)
            return int(u), int(v)
        return None

    out, stats = serve(model, params, prompts, max_new_tokens=args.new,
                       cache_len=args.cache_len, graph=graph,
                       mutator=None if args.ingest else mutator,
                       clients=clients if args.ingest else None,
                       query_stream=queries)
    tps = stats.decode_tokens / max(stats.wall_s, 1e-9)
    print(f"decoded {stats.decode_tokens} tokens in {stats.wall_s:.2f}s "
          f"({tps:.1f} tok/s); graph ops {stats.graph_ops}, "
          f"getpath calls {stats.getpath_calls} "
          f"(avg rounds {stats.getpath_rounds / max(stats.getpath_calls, 1):.1f})")
    if args.ingest:
        print(f"ingest: {stats.ingest_batches} batches in "
              f"{stats.ingest_fused_calls} fused applies, "
              f"{stats.ingest_epochs} epochs published; "
              f"starved sessions {stats.getpath_starved} "
              f"(epoch-resolved {stats.epoch_resolved})")
        _demo_epoch_ring(graph, rng)
        print(f"ring endpoints: tt_calls {graph.tt_calls} "
              f"(evicted {graph.tt_evicted}), "
              f"epoch_diff_calls {graph.epoch_diff_calls}")
    if args.index:
        # one query against a deliberately stale index (mutate, don't
        # refresh): the ring-validate / BFS-fallback routes that the
        # in-loop queries skip because index_tick refreshes first
        u, v = (int(x) for x in rng.integers(0, 16, 2))
        graph.submit([(OP_ADD_E, u, v)])
        res = graph.get_reach([(u, v)])
        print(f"stale-index reach({u},{v}) -> {res.found[0]} "
              f"(from_index {res.from_index}, fellback {res.fellback}, "
              f"pinned {res.pinned_epoch})")
    if trace.enabled():
        path = trace.save()
        n = len(trace.recorder().events())
        print(f"trace: {n} events -> {path} "
              f"(load at https://ui.perfetto.dev, or "
              f"`python tools/trace_view.py --summarize {path}`)")
        print("metrics:", json.dumps(graph.get_metrics(), indent=2,
                                     default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
