"""B3 and B7: the packed and the dense single-frontier push supersteps
(kernel.cu, ref.py, ops.py)."""
