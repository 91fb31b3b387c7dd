"""Hand-written CUDA kernels of the port, one package per TPU kernel:

  bfs_multi_step  B1 and B6, the packed and dense Q-frontier push supersteps
  bfs_pull_step   B2, the bottom-up pull superstep
  bfs_step        B3 and B7, the packed and dense single-frontier push
                  supersteps
  edge_update     B5 and B9, the packed and dense lane-ordered edge writes
  label_join      B4 and B8, the packed and dense 2-hop label joins

Each package holds ``kernel.cu`` (the kernel, built by ``_build``),
``ref.py`` (its plain PyTorch version) and ``ops.py`` (the wrappers: a CUDA
tensor launches the kernel, a CPU tensor takes the plain version).
"""
