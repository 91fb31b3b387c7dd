"""The paper's concurrent non-blocking graph ADT in PyTorch (the port of
``repro.core``'s main path).

  GraphState, OpBatch, make_graph, grow, make_op_batch   (graph.py)
  apply_ops, apply_ops_fast, compact, add_vertex, ...     (ops.py)
  bfs, multi_bfs, extract_path, default_backend           (bfs.py)
  collect, compare_collects, get_path, get_path_session,
  collect_batch, get_paths_session, interleaved_getpath   (snapshot.py)
  EpochRing, EpochRecord, EpochDiff, EpochEvictedError    (epochs.py)
  GraphOracle                                             (oracle.py)
  ShardedGraphState, shard_state, unshard                 (partition.py)
"""
from repro_torch.core.graph import (  # noqa: F401
    EMPTY_KEY,
    OP_ADD_E,
    OP_ADD_V,
    OP_CON_E,
    OP_CON_V,
    OP_NOP,
    OP_REM_E,
    OP_REM_V,
    R_CAS_FAIL,
    R_EDGE_ADDED,
    R_EDGE_NOT_PRESENT,
    R_EDGE_PRESENT,
    R_EDGE_REMOVED,
    R_FALSE,
    R_PENDING,
    R_RECOVERING,
    R_TABLE_FULL,
    R_TRUE,
    R_VERTEX_NOT_PRESENT,
    RESULT_NAMES,
    GraphState,
    OpBatch,
    contains_edge,
    contains_vertex,
    find_slot,
    find_slots,
    grow,
    make_graph,
    make_op_batch,
    num_edges,
    num_vertices,
    pack_bits,
    pack_transpose,
    packed_width,
    transpose_invariant,
    traversable,
    traversable_packed,
    unpack_bits,
    version_vector,
)
from repro_torch.core.ops import (  # noqa: F401
    add_edge,
    add_edge_undirected,
    add_vertex,
    apply_ops,
    apply_ops_fast,
    compact,
    degree,
    neighbors,
    remove_edge,
    remove_edge_undirected,
    remove_vertex,
)
from repro_torch.core.bfs import (  # noqa: F401
    BFSResult,
    HYBRID_BACKENDS,
    MultiBFSResult,
    PACKED_BACKENDS,
    bfs,
    default_backend,
    extract_path,
    multi_bfs,
    reachable_count,
)
from repro_torch.core.snapshot import (  # noqa: F401
    Collect,
    PathResult,
    collect,
    collect_batch,
    compare_collect_batches,
    compare_collects,
    get_path,
    get_path_session,
    get_paths_session,
    interleaved_getpath,
)
from repro_torch.core.epochs import (  # noqa: F401
    EpochDiff,
    EpochEvictedError,
    EpochRecord,
    EpochRing,
)
from repro_torch.core.oracle import GraphOracle  # noqa: F401
from repro_torch.core.partition import (  # noqa: F401
    ShardedGraphState,
    shard_state,
    unshard,
)
