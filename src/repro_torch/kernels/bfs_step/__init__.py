"""B3: the packed single-frontier push superstep (kernel.cu, ref.py, ops.py)."""
