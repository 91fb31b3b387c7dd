"""Host data pipeline: deterministic, restart-safe, prefetching; the port of
``repro.data.pipeline``.

Determinism: batch b is a pure function of (seed, b), so a restarted worker
resumes mid-epoch exactly; the train loop passes its step counter. Batches
are numpy int32 arrays, the JAX package's, and the train loop or the
``Prefetcher`` moves them to the card.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from repro_torch.data.pathgen import PathTaskGenerator


class SyntheticLMData:
    """Random-token LM batches (benchmarks, memory tests)."""

    def __init__(self, vocab: int, seed: int = 0):
        self.vocab = vocab
        self.seed = seed

    def batch(self, step: int, batch_size: int, seq_len: int):
        rng = np.random.default_rng((self.seed, step))
        return rng.integers(0, self.vocab, (batch_size, seq_len),
                            dtype=np.int32)


class GraphPathData:
    """Reachability-task batches from the concurrent graph engine, whose
    state lives on the card unless ``device`` names another."""

    def __init__(self, *, n_vertices=24, seed=0, device=None):
        self.kw = dict(n_vertices=n_vertices, device=device)
        self.seed = seed
        self._gens: dict[int, PathTaskGenerator] = {}

    def batch(self, step: int, batch_size: int, seq_len: int):
        gen = self._gens.get(step)
        if gen is None:
            gen = PathTaskGenerator(seed=self.seed + step, **self.kw)
            self._gens = {step: gen}  # keep only current (deterministic per step)
        return gen.batch(batch_size, seq_len)


class Prefetcher:
    """Background-thread prefetch + device placement: with ``device``,
    each batch goes there through pinned host memory with a non-blocking
    copy (JAX's ``device_put`` under a sharding); without, it stays a
    numpy array, as JAX's does without a sharding."""

    def __init__(self, source, *, batch_size: int, seq_len: int,
                 device=None, depth: int = 2, start_step: int = 0):
        self.source = source
        self.bs, self.sl = batch_size, seq_len
        self.device = None if device is None else torch.device(device)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = False
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        while not self._stop:
            arr = self.source.batch(self.step, self.bs, self.sl)
            if self.device is not None:
                t = torch.from_numpy(arr)
                if self.device.type == "cuda":
                    t = t.pin_memory()
                arr = t.to(self.device, non_blocking=True)
            self.q.put({"tokens": arr, "step": self.step})
            self.step += 1

    def __next__(self):
        return self.q.get()

    def stop(self):
        self._stop = True
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
