"""The serial correction pass of ``core.ops.apply_ops_fast`` on the card:
the conflicting lanes of a batch in lane order, one launch (kernel.cu,
ref.py, ops.py)."""
# ref.py, the host pass, builds on core.graph, and core.ops imports this
# package's modules: load core first, so that either side may be imported
# first without meeting a half-initialized module
import repro_torch.core  # noqa: F401
