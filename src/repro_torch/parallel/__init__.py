"""Placement and collectives of the port's meshes: ``repro.parallel``.

  sharding     the graph half (DESIGN.md §8): ``GRAPH_ROW_AXIS``,
               ``Placement``, ``graph_state_specs``,
               ``graph_state_shardings``, ``place`` on the
               single-controller ``GraphMesh``; and the LM half: the spec
               rules ``param_spec(s)``, ``batch_spec(s)``,
               ``cache_entry_spec`` / ``cache_specs`` (JAX's, as ``P``
               tuples on any mesh with named axes), ``to_named`` (specs
               as DTensor placements on a ``DeviceMesh``), ``distribute``,
               and the activation hooks ``set_activation_mesh`` /
               ``shard_activation`` the model code calls
  collectives  ``all_gather``, ``or_fold``, ``all_reduce_or``, ``psum``,
               ``pmin``, ``pmax`` over a list of per-shard tensors, and
               ``psum_hierarchical`` over the ranks of a ``DeviceMesh``
"""
from repro_torch.parallel import collectives, sharding  # noqa: F401
