"""B4 and B8: the packed and dense 2-hop label joins (kernel.cu, ref.py,
ops.py)."""
