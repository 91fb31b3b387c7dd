"""B1 and B6: the packed and the dense Q-frontier push supersteps
(kernel.cu with push.cuh and dense.cuh, ref.py, ops.py)."""
