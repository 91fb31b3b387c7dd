"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]``; the port of ``repro.launch.train`` with the same flags, plus
``--device`` (default ``cuda``) and ``--seed``.

Examples:
  # smoke-size run on the CPU
  python -m repro_torch.launch.train --arch qwen3-4b --smoke --steps 50 \\
      --batch 8 --seq 128 --device cpu
  # graph path-task corpus (the paper-integration workload) on the card
  python -m repro_torch.launch.train --arch olmo-1b --smoke --data graph \\
      --steps 100

``--seed`` seeds the params' ``torch.Generator`` (on ``--device``) and the
data stream; at 0 the data is the JAX launcher's. With ``--data graph``
the corpus's graph lives on ``--device`` too, so on the card every batch
runs GetPath through the hand-written BFS kernels. Without a card the
default ``--device cuda`` fails: there is no fallback to the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.core.graph import resolve_device
from repro_torch.data.pipeline import GraphPathData, SyntheticLMData
from repro_torch.models.model import build_model
from repro_torch.runtime.train_loop import TrainLoopConfig, train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--data", default="synthetic",
                    choices=["synthetic", "graph"])
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="torch device for the params, the batches and the "
                         "corpus's graph (cuda or cpu)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(args.seed))
    if args.data == "graph":
        data = GraphPathData(seed=args.seed, device=dev)
    else:
        data = SyntheticLMData(cfg.vocab, seed=args.seed)

    tl = TrainLoopConfig(
        total_steps=args.steps, checkpoint_every=args.ckpt_every,
        checkpoint_dir=args.ckpt_dir, microbatches=args.microbatches,
        lr=args.lr)
    params, opt_state, history = train(
        model, data, batch_size=args.batch, seq_len=args.seq, cfg=tl,
        params=params)
    print(f"done; final loss {history[-1][1]:.4f}" if history else "done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
