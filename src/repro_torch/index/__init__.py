"""The versioned reachability index (DESIGN.md §9), in PyTorch: the port
of ``repro.index``.

Public surface:
  ReachIndex, build_index, pick_landmarks, rebuild_rows      (labels.py)
  query_reach, reach_sets, reach_counts                      (query.py)
  index_fresh, index_fresh_at, refresh, affected_landmarks,
  reach_session, reach_counts_session, ReachSessionResult    (freshness.py)
"""
from repro_torch.index.labels import (  # noqa: F401
    ReachIndex,
    build_index,
    pick_landmarks,
    rebuild_rows,
)
from repro_torch.index.query import (  # noqa: F401
    query_reach,
    reach_counts,
    reach_sets,
)
from repro_torch.index.freshness import (  # noqa: F401
    ReachSessionResult,
    affected_landmarks,
    index_fresh,
    index_fresh_at,
    reach_counts_session,
    reach_session,
    refresh,
)
