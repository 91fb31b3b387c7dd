"""Where the graph state's fields live on a mesh (DESIGN.md §8): the port
of the graph half of ``repro.parallel.sharding``.

The port's mesh is single-controller: one Python thread holds a
``core.distributed.GraphMesh``, a tuple of S ``torch.device``s (a device
may repeat, so S row blocks can share one card). A ``Placement`` says how
one field is laid out over it:

  * replicated (``axis`` None): one copy of the whole tensor per distinct
    device of the mesh;
  * row-sharded (``axis`` = ``GRAPH_ROW_AXIS``): S contiguous row blocks of
    equal size, block s on ``mesh.devices[s]``.

The word-packed adjacencies, the only O(V^2/32) arrays, are row-sharded:
shard s owns the out-edge rows of its slot block in ``adj_packed`` and the
in-edge rows of the same block in ``adj_in_packed`` (the column-sharded
in-row layout the hybrid pull runs shard-local over). The O(V) version
metadata (vkey/valive/vver/ecnt) is replicated, so lookups, the
double-collect validation vector and the lane-order mutation schedule need
no communication.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

GRAPH_ROW_AXIS = "rows"


class Placement(NamedTuple):
    """How one field is laid out: ``axis`` None is replicated, otherwise
    rows are split over that mesh axis; ``mesh`` is None in a spec and set
    in a sharding bound to a concrete mesh."""

    axis: str | None = None
    mesh: object = None

    @property
    def replicated(self) -> bool:
        return self.axis is None


def graph_state_specs(axis: str = GRAPH_ROW_AXIS) -> dict:
    """Placements of the six graph-state fields, without a mesh."""
    rep = Placement(None)
    rows = Placement(axis)
    return {"vkey": rep, "valive": rep, "vver": rep, "ecnt": rep,
            "adj_packed": rows, "adj_in_packed": rows}


def graph_state_shardings(mesh, axis: str = GRAPH_ROW_AXIS) -> dict:
    """``graph_state_specs`` bound to a concrete mesh."""
    return {k: p._replace(mesh=mesh)
            for k, p in graph_state_specs(axis).items()}


def place(x: torch.Tensor, placement: Placement):
    """Copy ``x`` onto its placement's mesh: a replicated field gives a
    dict {device: copy} over the mesh's distinct devices, a row-sharded
    one a tuple of S contiguous row blocks, block s on device s. Raises
    ``ValueError`` when S does not divide the rows."""
    mesh = placement.mesh
    if placement.replicated:
        return {d: x.to(d, copy=True) for d in mesh.distinct_devices}
    size = mesh.shape[placement.axis]
    rows = x.shape[0]
    if rows % size:
        raise ValueError(
            f"capacity {rows} not divisible by mesh axis {size}")
    per = rows // size
    return tuple(x[s * per:(s + 1) * per].to(d, copy=True).contiguous()
                 for s, d in enumerate(mesh.devices))
