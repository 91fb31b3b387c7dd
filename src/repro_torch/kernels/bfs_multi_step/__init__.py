"""B1: the packed Q-frontier push superstep (kernel.cu, ref.py, ops.py)."""
