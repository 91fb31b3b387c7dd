"""End-to-end example on the PyTorch/CUDA port: train an LM on
reachability queries produced by the concurrent graph engine (the
paper-integration workload); the port of ``examples/train_path_lm.py``.

    PYTHONPATH=src python examples/train_path_lm_torch.py --steps 200
    PYTHONPATH=src python examples/train_path_lm_torch.py --device cpu

Every batch is generated live: a mutator stream evolves the graph
(apply_ops_fast batches) on the device, and GetPath answers (on the card,
through the hand-written BFS kernels) supervise the model. Checkpoints,
crash-resume and straggler detection come from the port's runtime. Use
``--arch`` to pick any assigned architecture (reduced config).
"""
import argparse
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.core.graph import resolve_device
from repro_torch.data.pipeline import GraphPathData
from repro_torch.models.model import build_model
from repro_torch.runtime.train_loop import TrainLoopConfig, train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=160)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_pathlm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).smoke()
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0))
    data = GraphPathData(n_vertices=12, seed=0, device=dev)
    tl = TrainLoopConfig(total_steps=args.steps, checkpoint_every=50,
                         checkpoint_dir=args.ckpt, log_every=10, lr=args.lr)
    _, _, hist = train(model, data, batch_size=args.batch, seq_len=args.seq,
                       cfg=tl, params=params)
    first, last = hist[0][1], hist[-1][1]
    print(f"\nloss {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"({'learning' if last < first else 'NOT learning'})")


if __name__ == "__main__":
    main()
