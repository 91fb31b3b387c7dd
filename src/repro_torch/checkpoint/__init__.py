"""The port's checkpointer (DESIGN.md §16): ``Checkpointer``, the port of
``repro.checkpoint``."""
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: F401
