"""B2: the bottom-up pull superstep (kernel.cu, ref.py, ops.py)."""
