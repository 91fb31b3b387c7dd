"""Placement and collectives of the port's single-controller mesh: the
graph half of ``repro.parallel`` (DESIGN.md §8).

  sharding     ``GRAPH_ROW_AXIS``, ``Placement``, ``graph_state_specs``,
               ``graph_state_shardings``, ``place``
  collectives  ``all_gather``, ``or_fold``, ``all_reduce_or``, ``psum``,
               ``pmin``, ``pmax`` over a list of per-shard tensors

The LM half (parameter, batch and cache specs, activation hooks,
``psum_hierarchical``) waits for the LM stack (ROADMAP.md queue A12).
"""
from repro_torch.parallel import collectives, sharding  # noqa: F401
