"""repro_torch: the PyTorch/CUDA port of ``repro`` (Chatterjee et al.
2018's concurrent non-blocking unbounded graph with reachability queries),
for one NVIDIA H100.

Subpackages: core (the graph ADT: packed state, batched mutations, BFS,
double-collect GetPath), kernels (hand-written CUDA kernels with their
plain PyTorch versions), index, runtime (serving, ingest, durability),
configs and models (the co-served decoder-only LM), launch (the entry
points), obs (spans and counters), and ``convert`` (state, indexes and LM
params across the numpy boundary). It imports nothing of JAX or of
``repro``.
"""

__version__ = "0.1.0"
