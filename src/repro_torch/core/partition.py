"""Mesh-partitioned graph state, the scale-out form of both engines, in
PyTorch: the port of ``repro.core.partition`` (DESIGN.md §8).

``ShardedGraphState`` holds the same logical state as ``GraphState``,
placed over a ``core.distributed.GraphMesh`` (axis ``"rows"``, S row
blocks, a device may repeat):

  * ``adj_packed`` and ``adj_in_packed``, the only O(V^2/32) arrays, are
    ROW-SHARDED: tuples of S int32[V/S, W] blocks, block s on
    ``mesh.devices[s]``. Shard s owns the out-edge rows of its slot block
    AND the in-edge rows of the same block (the out-adjacency's columns:
    the column-sharded in-row layout the hybrid pull runs shard-local
    over);
  * ``vkey``/``valive``/``vver``/``ecnt`` are REPLICATED: one copy on each
    distinct device of the mesh (``meta_on``); the attributes are the copy
    on the controller's device, ``mesh.device``. Lookups, the
    double-collect validation vector and the lane-order mutation schedule
    run on it with no communication, and the dense helpers of
    ``core.graph``/``core.ops`` take the sharded state as they take a
    ``GraphState``.

The placement rules are ``parallel.sharding.graph_state_specs``; the
collectives (``all_gather`` with OR-fold, ``psum``, ``pmin``, ``pmax``)
are ``parallel.collectives``, explicit functions over the per-shard
tensors.

Engines, each bit-identical to its dense counterpart:

``apply_ops_fast``  the conflict mask, the AddVertex allocation schedule
                    and the overflow fallback are the dense engine's,
                    computed on the replicated metadata. The clean lanes
                    apply in one shard-local vectorized pass (each word
                    RMW on the shard that owns its row, the edge presence
                    read from the owner and combined by ``pmax``). The
                    serial correction pass keeps the metadata on the host
                    for the batch, as the dense port's does; its adjacency
                    exchanges are JAX's: the edge-presence read from the
                    owning shard, and for a RemoveVertex the in-edge bumps
                    ``all_gather``ed from every shard's out-rows.

``multi_bfs``       each superstep every shard expands the slice of the Q
                    frontiers it owns over its own rows: B1 on its packed
                    row block (``packed_cuda``/``hybrid_cuda``), B6 on its
                    unpacked uint8 rows (``dense_cuda``, unpacked in row
                    chunks once a call) or the plain forms. B1's and B6's
                    parents are relative to the slice, so the shard adds
                    its first row under the ``>= 0`` guard; B2 (the
                    ``hybrid_cuda`` pull over the shard's in-rows) returns
                    global ids as they are. The partial next frontiers
                    cross as packed words (an ``all_gather`` and an OR
                    fold; the dense backends ``psum`` int32 as JAX does),
                    and the parents combine by ``pmin`` with INT32_MAX as
                    the neutral value. The push/pull switch is made from
                    the replicated popcounts in float32
                    (``pick_direction``). The loop runs on the host with
                    one sync a superstep, as the dense engine's does.

``grow``/``compact`` keep the sharding (``grow`` rounds the capacity up to
a multiple of S so that the row blocks stay equal).

Without a card nothing falls back: on CUDA blocks the ``_cuda`` backends
launch their kernels, on CPU blocks the kernels' wrappers run their plain
versions.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import graph as ggraph
from repro_torch.core import ops as gops
from repro_torch.core.bfs import (
    DEFAULT_ALPHA,
    DEFAULT_BETA,
    HYBRID_BACKENDS,
    PACKED_BACKENDS,
    MultiBFSResult,
    _as_slots,
    _resolve_backend,
    ctz32,
    pick_direction,
)
from repro_torch.core.distributed import (
    AXIS,
    GraphMesh,
    _on,
    _row_block_info,
    make_graph_mesh,
)
from repro_torch.core.graph import (
    EMPTY_KEY,
    INT32_MAX,
    OP_ADD_E,
    OP_ADD_V,
    OP_CON_E,
    OP_CON_V,
    OP_NOP,
    OP_REM_E,
    R_CAS_FAIL,
    R_EDGE_ADDED,
    R_EDGE_NOT_PRESENT,
    R_EDGE_PRESENT,
    R_EDGE_REMOVED,
    R_FALSE,
    R_TRUE,
    R_VERTEX_NOT_PRESENT,
    WORD_BITS,
    GraphState,
    OpBatch,
    bit_mask,
    or_reduce,
    pack_bits,
    traversable,
    traversable_packed,
    unpack_bits,
    unpack_dense,
)
from repro_torch.kernels.serial_pass.ref import _SerialPass, _serial_masked
from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import global_registry as _obs_registry
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import graph_state_shardings, place

_META = ("vkey", "valive", "vver", "ecnt")


class ShardedGraphState:
    """Row-partitioned graph state (DESIGN.md §8): the six fields of
    ``GraphState`` plus the owning ``mesh``. The metadata attributes are
    the controller's copy; ``adj_packed``/``adj_in_packed`` are tuples of
    S row blocks. Engines never write a state they return to a caller, so
    a state's tensors stay as they were published."""

    _fields = GraphState._fields

    def __init__(self, mesh: GraphMesh, vkey, valive, vver, ecnt,
                 adj_packed, adj_in_packed, *, replicas: dict | None = None):
        self.mesh = mesh
        self.vkey = vkey
        self.valive = valive
        self.vver = vver
        self.ecnt = ecnt
        self.adj_packed = tuple(adj_packed)
        self.adj_in_packed = tuple(adj_in_packed)
        self._replicas = replicas
        if replicas is None:
            self._replicate()

    def _replicate(self) -> None:
        """One copy of the metadata on each other distinct device (built
        once, when the state is final)."""
        self._replicas = {d: tuple(getattr(self, n).to(d) for n in _META)
                          for d in self.mesh.distinct_devices
                          if d != self.device}

    @property
    def capacity(self) -> int:
        return self.vkey.shape[0]

    @property
    def words(self) -> int:
        return self.adj_packed[0].shape[1]

    @property
    def num_shards(self) -> int:
        return self.mesh.shape[AXIS]

    @property
    def rows_per_shard(self) -> int:
        return self.capacity // self.num_shards

    @property
    def device(self) -> torch.device:
        """The controller's device (the metadata attributes live there)."""
        return self.mesh.device

    def meta_on(self, dev) -> tuple:
        """(vkey, valive, vver, ecnt) on ``dev``, a device of the mesh."""
        if dev == self.device:
            return tuple(getattr(self, n) for n in _META)
        return self._replicas[dev]

    def tensors(self) -> tuple:
        """Every tensor the state holds: metadata, replicas, blocks."""
        reps = tuple(t for r in self._replicas.values() for t in r)
        return (tuple(getattr(self, n) for n in _META) + reps
                + self.adj_packed + self.adj_in_packed)

    def as_dense(self) -> GraphState:
        """The gathered ``GraphState`` on the controller's device (the
        metadata tensors shared, the row blocks concatenated)."""
        dev = self.device
        return GraphState(
            *(getattr(self, n) for n in _META),
            collectives.all_gather(list(self.adj_packed), dev, tiled=True),
            collectives.all_gather(list(self.adj_in_packed), dev,
                                   tiled=True))

    @property
    def adj(self) -> torch.Tensor:
        """Dense uint8[V, V] adjacency view (unpacked on demand)."""
        return self.as_dense().adj

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"ShardedGraphState(capacity={self.capacity}, "
                f"shards={self.num_shards})")


def _require_sharded(state) -> None:
    if not isinstance(state, ShardedGraphState):
        raise TypeError(f"the sharded engines take a ShardedGraphState, got "
                        f"{type(state).__name__}")


# ----------------------------------------------------------------------------
# Placement / conversion
# ----------------------------------------------------------------------------
def shard_state(mesh: GraphMesh, dense: GraphState) -> ShardedGraphState:
    """Place a dense GraphState onto the mesh (DESIGN.md §8 layout); every
    field is copied. Raises ``ValueError`` when S does not divide the
    capacity."""
    if not isinstance(mesh, GraphMesh):
        raise TypeError(f"shard_state takes a GraphMesh, got "
                        f"{type(mesh).__name__}")
    if not isinstance(dense, GraphState):
        raise TypeError(f"shard_state takes a GraphState, got "
                        f"{type(dense).__name__}")
    size = mesh.shape[AXIS]
    if dense.capacity % size != 0:
        raise ValueError(
            f"capacity {dense.capacity} not divisible by mesh axis {size}")
    sh = graph_state_shardings(mesh, AXIS)
    meta = [place(getattr(dense, n), sh[n]) for n in _META]  # {device: copy}
    return ShardedGraphState(
        mesh, *(m[mesh.device] for m in meta),
        place(dense.adj_packed, sh["adj_packed"]),
        place(dense.adj_in_packed, sh["adj_in_packed"]),
        replicas={d: tuple(m[d] for m in meta)
                  for d in mesh.distinct_devices if d != mesh.device})


def unshard(state: ShardedGraphState) -> GraphState:
    """Gather back to a dense GraphState on the controller's device, with
    tensors of its own."""
    _require_sharded(state)
    d = state.as_dense()
    return GraphState(*(t.clone() for t in d[:4]), *d[4:])


def grow(state: ShardedGraphState, new_capacity: int) -> ShardedGraphState:
    """Functionally grow capacity, keeping the sharding: the capacity is
    rounded up to a multiple of S so the row blocks stay equal; the row
    blocks are redistributed (a gather and a re-place, as in JAX)."""
    _require_sharded(state)
    size = state.num_shards
    new_capacity = -(-int(new_capacity) // size) * size
    if new_capacity <= state.capacity:
        return state
    return shard_state(state.mesh, ggraph.grow(unshard(state), new_capacity))


def compact(state: ShardedGraphState) -> ShardedGraphState:
    """Physical removal of logically deleted vertices, a shard-local
    scrub: each shard zeroes its dead rows and masks the dead columns in
    its own blocks; the keep mask is replicated metadata. The scrub is
    transpose-symmetric, so the same pass compacts the in-rows."""
    _require_sharded(state)
    dead = ~state.valive & (state.vkey != EMPTY_KEY)
    keep = ~dead
    vkey = torch.where(dead, EMPTY_KEY, state.vkey)

    def scrub(blocks):
        out = []
        for s, (blk, d) in enumerate(zip(blocks, state.mesh.devices)):
            _, _, per, row0 = _row_block_info(state.capacity,
                                              state.num_shards, s)
            keep_d = _on(keep, d)
            zero = torch.zeros((), dtype=blk.dtype, device=d)
            out.append(torch.where(keep_d[row0:row0 + per, None],
                                   blk & pack_bits(keep_d)[None, :], zero))
        return out

    return ShardedGraphState(state.mesh, vkey, state.valive, state.vver,
                             state.ecnt, scrub(state.adj_packed),
                             scrub(state.adj_in_packed))


# ----------------------------------------------------------------------------
# Distributed mutation engine
# ----------------------------------------------------------------------------
def _work_copy(state: ShardedGraphState) -> ShardedGraphState:
    """The one copy a batch makes before mutating in place (no metadata
    replicas until the batch is done)."""
    return ShardedGraphState(
        state.mesh, *(getattr(state, n).clone() for n in _META),
        [b.clone() for b in state.adj_packed],
        [b.clone() for b in state.adj_in_packed], replicas={})


def _owner_bits(blocks, rows, cols, per, dev) -> torch.Tensor:
    """Edge presence bit (rows[i], cols[i]) per lane: each shard reads the
    lanes whose row it owns, the others contribute 0, and a ``pmax``
    combines them."""
    parts = []
    for s, blk in enumerate(blocks):
        d = blk.device
        loc = _on(rows, d) - s * per
        mine = (loc >= 0) & (loc < per)
        c = _on(cols, d)
        bit = (blk[loc.clamp(0, per - 1), c // WORD_BITS] & bit_mask(c)) != 0
        parts.append((bit & mine).to(torch.int32))
    return collectives.pmax(parts, dev) > 0


def _each_owner(blocks, rows, per):
    """(shard block, local rows, lane selection) for each shard owning
    some of ``rows``."""
    owner = rows // per
    for s, blk in enumerate(blocks):
        sel = owner == s
        # repro-torch-lint: allow(trace-purity) — a shard owning none of the rows is skipped: one scalar a shard
        if bool(sel.any()):
            yield blk, _on(rows[sel] - s * per, blk.device), sel


def _apply_clean(st: ShardedGraphState, ops: OpBatch, active, wants, slot):
    """The clean vectorized pass on the shards (mirror of
    ``ops._apply_clean_vectorized``): every read from the input state
    before any write; each word RMW on the shard owning its row."""
    b = ops.lanes
    dev = st.device
    per = st.rows_per_shard
    s1 = gops._find_slots_masked(st, ops.key1)
    s2 = gops._find_slots_masked(st, ops.key2)
    opc = ops.opcode
    is_addv = active & (opc == OP_ADD_V)
    is_conv = active & (opc == OP_CON_V)
    is_adde = active & (opc == OP_ADD_E)
    is_reme = active & (opc == OP_REM_E)
    is_cone = active & (opc == OP_CON_E)

    both = (s1 >= 0) & (s2 >= 0)
    r1, r2 = s1.clamp(min=0), s2.clamp(min=0)
    cur = _owner_bits(st.adj_packed, r1, r2, per, dev)
    cas_ok = (ops.expect < 0) | (st.ecnt[r1] == ops.expect)

    def code(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    res = torch.full((b,), R_FALSE, dtype=torch.int32, device=dev)

    # AddVertex: the scheduled slots, then the scrub on every shard
    take = is_addv & wants
    alloc = slot[take]
    if alloc.numel():
        st.vkey[alloc] = ops.key1[take]
        st.valive[alloc] = True
        st.vver[alloc] += 1
        st.ecnt[alloc] = 0
        words, bits = gops._words_mask(alloc)
        for blocks in (st.adj_packed, st.adj_in_packed):
            for blk, loc, _ in _each_owner(blocks, alloc, per):
                blk[loc] = 0
            for blk in blocks:
                blk[:, _on(words, blk.device)] &= ~_on(bits, blk.device)
    res = torch.where(is_addv, torch.where(wants, code(R_TRUE),
                                           code(R_FALSE)), res)
    res = torch.where(is_conv, torch.where(s1 >= 0, code(R_TRUE),
                                           code(R_FALSE)), res)

    # edge ops: the out-row word on the source's shard, the in-row word on
    # the destination's (clean lanes name disjoint keys, so both scatters
    # hit distinct rows)
    do_add = is_adde & both & cas_ok & ~cur
    do_rem = is_reme & both & cas_ok & cur
    fire = do_add | do_rem
    if fire.any():
        add, rows, cols = do_add[fire], r1[fire], r2[fire]
        for blocks, r, c in ((st.adj_packed, rows, cols),
                             (st.adj_in_packed, cols, rows)):
            for blk, loc, sel in _each_owner(blocks, r, per):
                d = blk.device
                cc, aa = _on(c[sel], d), _on(add[sel], d)
                w, m = cc // WORD_BITS, bit_mask(cc)
                curw = blk[loc, w]
                blk[loc, w] = torch.where(aa, curw | m, curw & ~m)
        st.ecnt[rows] += 1

    vnp = code(R_VERTEX_NOT_PRESENT)
    cas = code(R_CAS_FAIL)
    res = torch.where(is_adde, torch.where(both, torch.where(
        cas_ok, torch.where(cur, code(R_EDGE_PRESENT), code(R_EDGE_ADDED)),
        cas), vnp), res)
    res = torch.where(is_reme, torch.where(both, torch.where(
        cas_ok, torch.where(cur, code(R_EDGE_REMOVED),
                            code(R_EDGE_NOT_PRESENT)), cas), vnp), res)
    res = torch.where(is_cone, torch.where(
        both, torch.where(cur, code(R_EDGE_PRESENT),
                          code(R_EDGE_NOT_PRESENT)), vnp), res)
    return res


class _ShardedSerialPass(_SerialPass):
    """The serial correction pass on a sharded work copy: the slot table
    on the host as in the dense pass; each adjacency read or write goes to
    the shard that owns the row."""

    def __init__(self, st: ShardedGraphState):
        super().__init__(st)
        self.per = st.rows_per_shard

    def _word(self, blocks, row: int, col: int) -> torch.Tensor:
        s = row // self.per
        return blocks[s][row - s * self.per, col // WORD_BITS]  # a view

    def bit(self, row: int, col: int) -> bool:
        # the edge-presence pmax: only the row's owner holds the bit, every
        # other shard contributes 0. A mutation reads the physical bit, as
        # the dense pass does, never the traversable edge:
        # repro-lint: allow(traversable-predicate) — a physical-bit read
        return (int(self._word(self.st.adj_packed, row, col))  # repro-torch-lint: allow(traversable-predicate) — a physical-bit read
                & bit_mask(col)) != 0

    def in_sources(self, slot: int) -> np.ndarray:
        # every shard's out-rows with the slot's column bit, all_gathered
        w, m = slot // WORD_BITS, bit_mask(slot)
        col = collectives.all_gather(
            [(blk[:, w] & m) != 0 for blk in self.st.adj_packed],
            self.st.device, tiled=True)
        return col.cpu().numpy()

    def set_edge(self, row: int, col: int, present: bool) -> None:
        for blocks, r, c in ((self.st.adj_packed, row, col),
                             (self.st.adj_in_packed, col, row)):
            m = bit_mask(c)
            cell = self._word(blocks, r, c)
            if present:
                cell.bitwise_or_(m)
            else:
                cell.bitwise_and_(~m)

    def scrub(self, slot: int) -> None:
        m = ~bit_mask(slot)
        s = slot // self.per
        for blocks in (self.st.adj_packed, self.st.adj_in_packed):
            blocks[s][slot - s * self.per].zero_()
            for blk in blocks:
                blk[:, slot // WORD_BITS].bitwise_and_(m)


def apply_ops_fast(state: ShardedGraphState, ops: OpBatch):
    """Distributed disjoint-access-parallel batch application,
    bit-identical to the dense ``ops.apply_ops_fast`` (hence to
    ``ops.apply_ops``): result codes, slot placement, ``ecnt``, ``vver``
    and both mirrors' row blocks. Returns (new state, codes int32[B] on
    the controller's device)."""
    _require_sharded(state)
    st = _work_copy(state)
    b = ops.lanes
    if b == 0:
        st._replicate()
        return st, ops.opcode.clone()
    conflict = gops._lane_conflicts(ops)
    clean = ~conflict & (ops.opcode != OP_NOP)
    wants, slot, overflow = gops._alloc_schedule(state, ops)
    # repro-torch-lint: allow(trace-purity) — capacity overflow picks the engine: one scalar a batch
    if bool(overflow):
        # capacity exhaustion couples lanes across keys: every lane serial
        lanes = list(range(b))
        res = torch.full((b,), R_FALSE, dtype=torch.int32,
                         device=state.device)
    else:
        res = _apply_clean(st, ops, clean, wants, slot)
        # repro-torch-lint: allow(trace-purity) — the conflicting lanes and their results go to the serial pass
        lanes = torch.nonzero(conflict).flatten().tolist()
    if lanes:
        res_np = _serial_masked(st, ops, lanes, res.cpu().numpy(),  # repro-torch-lint: allow(trace-purity) — the serial pass reads the results on the host
                                pass_cls=_ShardedSerialPass)
        res = torch.from_numpy(res_np).to(state.device)
    st._replicate()
    return st, res


# ----------------------------------------------------------------------------
# Distributed fused multi-source BFS
# ----------------------------------------------------------------------------
class _Shard:
    """One shard's loop-invariant operands for a traversal."""

    def __init__(self, state: ShardedGraphState, s: int, backend: str):
        v = state.capacity
        self.dev = d = state.mesh.devices[s]
        _, _, self.per, self.row0 = _row_block_info(v, state.num_shards, s)
        self.alive = state.meta_on(d)[1]
        self.alive_l = self.alive[self.row0:self.row0 + self.per]
        self.words = state.adj_packed[s]
        self.words_in = state.adj_in_packed[s]
        # the plain edge views derive from the ONE traversable predicate
        # (row-slice form); the kernels stream raw rows and mask in their
        # epilogue. Loop-invariant, so built once a call.
        self.t = self.tw = self.adj = None
        if backend in ("packed", "hybrid"):
            self.tw = traversable_packed(self.words, self.alive_l,
                                         pack_bits(self.alive))
            self.t = unpack_bits(self.tw, v)
        elif backend == "dense":
            self.t = traversable(unpack_bits(self.words, v), self.alive_l,
                                 self.alive)
        elif backend == "dense_cuda":
            self.adj = unpack_dense(self.words, v)     # row chunks


def _step_kernels(backend: str):
    """(push kernel wrapper or None, pull kernel wrapper or None)."""
    if backend == "dense_cuda":
        from repro_torch.kernels.bfs_multi_step.ops import multi_bfs_step
        return multi_bfs_step, None
    if backend in ("packed_cuda", "hybrid_cuda"):
        from repro_torch.kernels.bfs_multi_step.ops import \
            multi_bfs_step_packed
        from repro_torch.kernels.bfs_pull_step.ops import bfs_pull_step_rows
        return multi_bfs_step_packed, (bfs_pull_step_rows
                                       if backend == "hybrid_cuda" else None)
    return None, None


def _push_local(sh: _Shard, f, visited, v: int, backend: str, push_k):
    """A shard's top-down partial over its rows: (reach_part bool[Q, V],
    parent candidates int32[Q, V], INT32_MAX where none)."""
    f_l = _on(f[:, sh.row0:sh.row0 + sh.per], sh.dev).contiguous()
    if push_k is not None:
        operand = sh.adj if backend == "dense_cuda" else sh.words
        new_p, par_p = push_k(f_l, operand, sh.alive, _on(visited, sh.dev))
        # B1/B6 parents are relative to the slice
        return new_p, torch.where(par_p >= 0, par_p + sh.row0, INT32_MAX)
    if backend in ("packed", "hybrid"):
        sel = torch.where(f_l[:, :, None], sh.tw[None, :, :], 0)
        reach_part = unpack_bits(or_reduce(sel, 1), v)
    else:
        reach_part = (f_l.to(torch.float32) @ sh.t.to(torch.float32)) > 0
    idx = torch.arange(sh.row0, sh.row0 + sh.per, dtype=torch.int32,
                       device=sh.dev)[:, None, None]
    cand3 = torch.where(f_l.T[:, :, None] & sh.t[:, None, :], idx, INT32_MAX)
    return reach_part, cand3.amin(0)


def _pull_local(sh: _Shard, fw, visited, v: int, pull_k):
    """A shard's bottom-up partial over its in-rows: disjoint [Q, V/S]
    destination slices embedded into [Q, V]."""
    q = visited.shape[0]
    lo, hi = sh.row0, sh.row0 + sh.per
    visited_l = _on(visited[:, lo:hi], sh.dev).contiguous()
    fw = _on(fw, sh.dev)
    if pull_k is not None:
        # B2's parents are global source ids: taken as they are
        new_l, par_l = pull_k(fw, sh.words_in, sh.alive_l.contiguous(),
                              visited_l)
        pmin_l = torch.where(new_l, par_l, INT32_MAX)
    else:
        cand_w = sh.words_in[None, :, :] & fw[:, None, :]      # [Q, per, W]
        nz = cand_w != 0
        new_l = nz.any(2) & sh.alive_l[None, :] & ~visited_l
        widx = (torch.arange(sh.words_in.shape[1], dtype=torch.int32,
                             device=sh.dev) * WORD_BITS)[None, None, :]
        pc = torch.where(nz, widx + ctz32(cand_w), INT32_MAX)
        pmin_l = torch.where(new_l, pc.amin(2), INT32_MAX)
    reach_part = torch.zeros((q, v), dtype=torch.bool, device=sh.dev)
    reach_part[:, lo:hi] = new_l
    cand = torch.full((q, v), INT32_MAX, dtype=torch.int32, device=sh.dev)
    cand[:, lo:hi] = pmin_l
    return reach_part, cand


def _run(state: ShardedGraphState, src, dst, backend: str, alpha: int,
         beta: int) -> MultiBFSResult:
    """The sharded superstep loop for Q (src, dst) pairs: one sync a
    superstep (the loop test and the switch's popcounts)."""
    dev = state.device
    q, v = src.shape[0], state.capacity
    alive = state.valive
    qi = torch.arange(q, device=dev)
    hybrid = backend in HYBRID_BACKENDS
    packed = backend in PACKED_BACKENDS or hybrid
    push_k, pull_k = _step_kernels(backend)
    shards = [_Shard(state, s, backend) for s in range(state.num_shards)]

    src_ok = (src >= 0) & alive[src.clamp(min=0)]
    frontiers = torch.zeros((q, v), dtype=torch.bool, device=dev)
    frontiers[qi, src.clamp(min=0)] = src_ok
    visited = frontiers.clone()
    parent = torch.full((q, v), -1, dtype=torch.int32, device=dev)
    dist = torch.where(frontiers, 0, -1).to(torch.int32)
    expanded = torch.zeros((q, v), dtype=torch.bool, device=dev)
    steps = torch.zeros((q,), dtype=torch.int32, device=dev)
    dst_c = dst.clamp(min=0)
    has_dst = dst >= 0
    pulling = False
    step = 0
    while step < v:
        act = frontiers.any(1) & ~(has_dst & visited[qi, dst_c])
        f = frontiers & act[:, None]
        # replicated popcounts: the same decision on every shard
        nu_t = ((alive[None, :] & ~visited) & act[:, None]).sum()
        # repro-torch-lint: allow(trace-purity) — the superstep's one sync, replicated on every shard
        any_act, nf, nu = torch.stack(
            [act.any().to(nu_t.dtype), f.sum(), nu_t]).tolist()
        if not any_act:
            break
        if hybrid:
            pulling = pick_direction(pulling, nf, nu, q * v, alpha, beta)
        expanded |= f
        if pulling:
            fw = pack_bits(f & alive[None, :])
            parts = [_pull_local(sh, fw, visited, v, pull_k) for sh in shards]
        else:
            parts = [_push_local(sh, f, visited, v, backend, push_k)
                     for sh in shards]
        reach_parts, cands = zip(*parts)
        if packed:
            # the frontier exchange as packed words: one all_gather of
            # [Q, W] per shard and an OR fold
            reach = unpack_bits(collectives.or_fold(
                [pack_bits(r) for r in reach_parts], dev), v)
        else:
            reach = collectives.psum(
                [r.to(torch.int32) for r in reach_parts], dev) > 0
        par_min = collectives.pmin(list(cands), dev)
        new = reach & alive[None, :] & ~visited
        parent = torch.where(new, par_min, parent)
        dist = torch.where(new, step + 1, dist)
        visited |= new
        steps += act.to(torch.int32)
        frontiers = new
        step += 1
    found = has_dst & visited[qi, dst_c] & src_ok
    return MultiBFSResult(found, parent, dist, expanded, steps,
                          torch.tensor(step, dtype=torch.int32, device=dev))


def traverse(state: ShardedGraphState, src_slots, dst_slots,
             backend: str | None = None, alpha: int = DEFAULT_ALPHA,
             beta: int = DEFAULT_BETA) -> MultiBFSResult:
    """``multi_bfs`` without its trace record: the traversal of a single
    collect, which JAX runs through its untraced single-source ``bfs``."""
    _require_sharded(state)
    backend = _resolve_backend(backend, state.device)
    return _run(state, _as_slots(src_slots, state.device),
                _as_slots(dst_slots, state.device), backend, alpha, beta)


def multi_bfs(state: ShardedGraphState, src_slots, dst_slots,
              backend: str | None = None, alpha: int = DEFAULT_ALPHA,
              beta: int = DEFAULT_BETA) -> MultiBFSResult:
    """Fused BFS from Q sources over the row-sharded adjacency (module
    docstring); every field bit-identical to ``core.bfs.multi_bfs`` on the
    gathered state.

    Under tracing the call is one ``bfs.session.sharded`` span recording
    the supersteps and the packed frontier-exchange volume JAX estimates
    (supersteps x Q x ceil(V/32) words x 4 bytes x S), with no
    per-superstep child span, as in JAX; ``bfs.supersteps`` and
    ``bfs.exchange_bytes`` move by the same amounts."""
    _require_sharded(state)
    backend = _resolve_backend(backend, state.device)
    src = _as_slots(src_slots, state.device)
    dst = _as_slots(dst_slots, state.device)
    if not _trace.enabled():
        return _run(state, src, dst, backend, alpha, beta)
    q, v, size = int(src.shape[0]), state.capacity, state.num_shards
    with _trace.span("bfs.session.sharded", queries=q, capacity=v,
                     shards=size, backend=backend) as sp:
        res = _trace.fence(_run(state, src, dst, backend, alpha, beta))
        steps = int(res.supersteps)
        xbytes = steps * q * ggraph.packed_width(v) * 4 * size
        sp.set(supersteps=steps, exchange_bytes=xbytes)
        reg = _obs_registry()
        reg.inc("bfs.supersteps", steps)
        reg.inc("bfs.exchange_bytes", xbytes)
    return res


__all__ = [
    "ShardedGraphState",
    "apply_ops_fast",
    "compact",
    "grow",
    "make_graph_mesh",
    "multi_bfs",
    "shard_state",
    "traverse",
    "unshard",
]
