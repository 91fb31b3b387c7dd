"""The port's training data (DESIGN.md §5(i)): ``tokenizer``, ``pathgen``
(LM examples from GetPath answers on a live graph) and ``pipeline``
(deterministic batches and a prefetcher); the port of ``repro.data``."""
from repro_torch.data import pathgen, pipeline, tokenizer  # noqa: F401
