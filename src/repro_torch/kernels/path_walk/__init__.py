"""GetPath's path walk on the card: every query's parent chain and the keys
on it, one launch a session (kernel.cu, ref.py, ops.py)."""
