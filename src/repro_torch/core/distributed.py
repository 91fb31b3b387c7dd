"""The single-controller graph mesh and the fully row-sharded legacy
engines: the port of ``repro.core.distributed`` (DESIGN.md §8).

JAX's ``shard_map`` is single-controller: one Python thread holds the
sharded state and calls each engine once. The port keeps that shape. A
``GraphMesh`` is a tuple of S ``torch.device``s along one axis
(``AXIS = "rows"``), and a device may repeat, so S row blocks can share
one card. Each shard's blocks live on its device; a collective is an
explicit function over the list of per-shard tensors
(``repro_torch.parallel.collectives``) that copies with ``.to`` where the
devices differ. A mesh of distinct GPUs runs the same code.

``make_graph_mesh`` with no argument takes every visible CUDA device once;
``shards=S`` places S row blocks round-robin over the devices, so on one
card all S go on ``cuda:0``. The mesh is on the CPU only when ``devices``
names it: without a card and without ``devices`` it raises.

This file keeps the fully row-sharded engines of the JAX module, where the
metadata is partitioned too and mutations are owner-routed:

  * ``shard_graph``        every field in S row blocks (``RowShardedState``)
  * ``dbfs``               single-source BFS: each shard expands the frontier
                           rows it owns over its dense local block; the
                           partial next frontiers OR-combine (``psum`` > 0)
                           and the parents min-combine (``pmin``)
  * ``dapply_ops``         the lane loop, owner-routed: an AddVertex
                           allocates in the slot range of shard
                           ``abs(key) % S``; lookups are a ``pmax`` over the
                           shards' local matches; the in-adjacency is
                           rebuilt by one packed transpose at the end
  * ``dcollect`` / ``dcompare`` / ``dget_path_session``
                           the double collect; the version snapshot stays
                           sharded and the comparison is one ``psum`` of
                           per-shard mismatch counts

The production scale-out path is ``core.partition``: adjacency rows
sharded, metadata replicated, engines bit-identical to the dense ones. It
shares this module's ``AXIS``, ``GraphMesh`` and ``_row_block_info``. JAX's
``shard_map`` import, ``_SM_NOCHECK`` and ``_pvary`` are jax-version shims
with no counterpart here.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.graph import (
    EMPTY_KEY,
    INT32_MAX,
    WORD_BITS,
    GraphState,
    OpBatch,
    bit_mask,
    pack_transpose_blocks,
    traversable,
    unpack_dense,
)
from repro_torch.parallel import collectives

AXIS = "rows"
INT32_MIN = -(2**31)


def _normalize(dev) -> torch.device:
    """A device with an explicit index on CUDA, so that it compares equal
    to the device of the tensors placed on it."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the mesh names a CUDA device and none is "
                               "available; pass devices=['cpu'] to run on "
                               "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class GraphMesh:
    """A 1-D mesh of S row blocks over torch devices (axis ``"rows"``);
    ``devices[s]`` holds block s, and a device may repeat."""

    def __init__(self, devices):
        devs = tuple(_normalize(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = devs

    @property
    def shape(self) -> dict:
        return {AXIS: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The controller's device: the first shard's, where replicated
        values and collective results are formed."""
        return self.devices[0]

    @property
    def distinct_devices(self) -> tuple:
        return tuple(dict.fromkeys(self.devices))

    def __eq__(self, other):
        return isinstance(other, GraphMesh) and self.devices == other.devices

    def __hash__(self):
        return hash(self.devices)

    def __repr__(self):
        return f"GraphMesh({[str(d) for d in self.devices]})"


def make_graph_mesh(devices=None, shards: int | None = None) -> GraphMesh:
    """A mesh over ``devices`` (default: every visible CUDA device once;
    raises without a card). ``shards=S`` places S row blocks round-robin
    over those devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_graph_mesh places row blocks on the GPU by default and "
                "no CUDA device is available; pass devices=['cpu'] to run on "
                "the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if shards is not None:
        if shards < 1 or not devices:
            raise ValueError(f"cannot place {shards} shards on {devices}")
        devices = [devices[s % len(devices)] for s in range(int(shards))]
    return GraphMesh(devices)


def _row_block_info(nrows_total: int, size: int, shard: int):
    """(shard id, axis size, rows per shard, first owned row)."""
    per = nrows_total // size
    return shard, size, per, shard * per


def _on(t: torch.Tensor, dev) -> torch.Tensor:
    return t if t.device == dev else t.to(dev)


# ----------------------------------------------------------------------------
# The fully row-sharded state
# ----------------------------------------------------------------------------
class RowShardedState(NamedTuple):
    """A graph state with EVERY field in S row blocks (block s on
    ``mesh.devices[s]``): the legacy engines' layout. Each field is a
    tuple of S tensors."""

    mesh: GraphMesh
    vkey: tuple
    valive: tuple
    vver: tuple
    ecnt: tuple
    adj_packed: tuple
    adj_in_packed: tuple

    @property
    def capacity(self) -> int:
        return sum(b.shape[0] for b in self.vkey)

    def gather(self) -> GraphState:
        """The dense state on the mesh's first device."""
        dev = self.mesh.device
        return GraphState(*(collectives.all_gather(list(f), dev, tiled=True)
                            for f in self[1:]))


def shard_graph(mesh: GraphMesh, state: GraphState) -> RowShardedState:
    """Place a GraphState with every field's rows sharded over the mesh."""
    size = mesh.size
    if state.capacity % size:
        raise ValueError(f"capacity {state.capacity} not divisible by mesh "
                         f"axis {size}")
    per = state.capacity // size
    return RowShardedState(mesh, *(
        tuple(t[s * per:(s + 1) * per].to(d, copy=True).contiguous()
              for s, d in enumerate(mesh.devices)) for t in state))


def _as_rows(mesh: GraphMesh, state) -> RowShardedState:
    if isinstance(state, RowShardedState):
        if state.mesh != mesh:
            raise ValueError(f"state placed on {state.mesh}, not {mesh}")
        return state
    if isinstance(state, GraphState):
        return shard_graph(mesh, state)
    raise TypeError(f"the legacy engines take a GraphState or a "
                    f"RowShardedState, got {type(state).__name__}")


# ----------------------------------------------------------------------------
# Distributed BFS
# ----------------------------------------------------------------------------
def dbfs(mesh: GraphMesh, state, src_slot, dst_slot):
    """Distributed BFS; returns (found, parent[V], dist[V], expanded[V],
    steps) on the mesh's first device.

    Each superstep every shard expands the frontier rows it owns over its
    dense local block (the ONE ``traversable`` predicate on the row slice),
    and the partial next frontiers OR-combine through a ``psum`` while the
    parents min-combine through a ``pmin``."""
    rs = _as_rows(mesh, state)
    v = rs.capacity
    dev = mesh.device
    src, dst = int(src_slot), int(dst_slot)
    alive_g = collectives.all_gather(list(rs.valive), dev, tiled=True)
    per = v // mesh.size
    blocks = [traversable(unpack_dense(w, v), va, _on(alive_g, d))
              for w, va, d in zip(rs.adj_packed, rs.valive, mesh.devices)]
    src_ok = src >= 0 and bool(alive_g[max(src, 0)])
    frontier = torch.zeros((v,), dtype=torch.bool, device=dev)
    frontier[max(src, 0)] = src_ok
    visited = frontier.clone()
    parent = torch.full((v,), -1, dtype=torch.int32, device=dev)
    dist = torch.where(frontier, 0, -1).to(torch.int32)
    expanded = torch.zeros((v,), dtype=torch.bool, device=dev)
    step = 0
    while step < v:
        hit = dst >= 0 and bool(visited[max(dst, 0)])
        if hit or not bool(frontier.any()):
            break
        expanded |= frontier
        reach_parts, par_parts = [], []
        for s, (adj_l, d) in enumerate(zip(blocks, mesh.devices)):
            _, _, _, row0 = _row_block_info(v, mesh.size, s)
            rows = torch.nonzero(_on(frontier[row0:row0 + per], d)).flatten()
            sub = adj_l[rows]                            # [k, V]
            reach = sub.any(0)
            first = rows[sub.to(torch.int8).argmax(0)] if rows.numel() else \
                torch.zeros((v,), dtype=torch.int64, device=d)
            reach_parts.append(reach)
            par_parts.append(torch.where(reach, (first + row0).to(torch.int32),
                                         INT32_MAX))
        reach = collectives.all_reduce_or(reach_parts, dev)
        parent_new = collectives.pmin(par_parts, dev)
        new = reach & alive_g & ~visited
        parent = torch.where(new, parent_new, parent)
        dist = torch.where(new, step + 1, dist)
        visited |= new
        frontier = new
        step += 1
    found = dst >= 0 and bool(visited[max(dst, 0)]) and src_ok
    return (torch.tensor(found, device=dev), parent, dist, expanded,
            torch.tensor(step, dtype=torch.int32, device=dev))


# ----------------------------------------------------------------------------
# Distributed mutation batches (owner-routed)
# ----------------------------------------------------------------------------
def _global_find(vkey, valive, key: int, per: int, size: int) -> int:
    """Global slot of ``key`` (-1 if absent): each shard's first local
    match, combined by ``pmax`` (host arrays, one slice a shard)."""
    best = -1
    for s in range(size):
        lo = s * per
        hit = (vkey[lo:lo + per] == key) & valive[lo:lo + per] & (key >= 0)
        if hit.any():
            best = max(best, lo + int(hit.argmax()))
    return best


def _owner_of(key: int, size: int) -> int:
    """``jnp.abs(key) % size`` in int32: abs(INT32_MIN) wraps."""
    a = key if key == INT32_MIN else abs(key)
    return a % size


def dapply_ops(mesh: GraphMesh, state, ops: OpBatch):
    """Apply an op batch to the fully row-sharded graph, lane order =
    linearization. Returns (RowShardedState, result codes int32[B]).

    A mutation's home is the owner of its source row (edge ops: key1's
    slot; AddVertex: shard ``abs(key) % S``, which allocates from its own
    slot range). The slot table is read on the host for the batch, as the
    port's serial engine does; each adjacency read is one word of the
    owning shard's block, and the in-adjacency is rebuilt by one packed
    transpose of the out-adjacency at the end, as in JAX."""
    rs = _as_rows(mesh, state)
    v, size = rs.capacity, mesh.size
    per = v // size
    dev = mesh.device
    vkey = np.concatenate([t.cpu().numpy() for t in rs.vkey])
    valive = np.concatenate([t.cpu().numpy() for t in rs.valive])
    vver = np.concatenate([t.cpu().numpy() for t in rs.vver])
    ecnt = np.concatenate([t.cpu().numpy() for t in rs.ecnt])
    adj = [b.clone() for b in rs.adj_packed]
    host = np.stack([t.cpu().numpy() for t in ops]).astype(np.int64)
    res = np.zeros((ops.lanes,), np.int32)

    def word(r: int, c: int) -> torch.Tensor:
        return adj[r // per][r % per, c // WORD_BITS]

    for i in range(ops.lanes):
        op, a, bk, exp = (int(x) for x in host[:, i])
        s1 = _global_find(vkey, valive, a, per, size)
        s2 = _global_find(vkey, valive, bk, per, size)

        # AddVertex: the owner shard allocates its first free slot
        r_addv = 0
        if s1 < 0:
            owner = _owner_of(a, size)
            free = vkey[owner * per:(owner + 1) * per] == EMPTY_KEY
            if free.any():
                r_addv = 1
                if op == 1:
                    tgt = owner * per + int(free.argmax())
                    vkey[tgt], valive[tgt] = a, True
                    vver[tgt] += 1
                    ecnt[tgt] = 0
                    adj[owner][tgt - owner * per].zero_()
                    m = ~bit_mask(tgt)
                    for b in adj:                  # the column, everywhere
                        b[:, tgt // WORD_BITS].bitwise_and_(m)
            else:
                r_addv = 7

        # RemoveVertex: the slot's owner marks it; every shard bumps the
        # live in-edge sources it owns (liveness read AFTER the mark)
        if op == 2 and s1 >= 0:
            valive[s1] = False
            vver[s1] += 1
            ecnt[s1] += 1
            col = collectives.all_gather(
                [(b[:, s1 // WORD_BITS] & bit_mask(s1)) != 0 for b in adj],
                dev, tiled=True)
            ecnt += (col.cpu().numpy() & valive).astype(np.int32)

        # edge ops on the source row's owner
        both = s1 >= 0 and s2 >= 0
        cur = both and bool((word(s1, s2) & bit_mask(s2)) != 0)
        src_ecnt = int(ecnt[s1]) if s1 >= 0 else INT32_MIN
        cas_ok = exp < 0 or src_ecnt == exp
        do_add = op == 4 and both and cas_ok and not cur
        do_rem = op == 5 and both and cas_ok and cur
        if do_add or do_rem:
            w = word(s1, s2)                             # a view
            if do_add:
                w.bitwise_or_(bit_mask(s2))
            else:
                w.bitwise_and_(~bit_mask(s2))
            ecnt[s1] += 1
        if not both:
            r_edge = (2, 2, 2)
        elif not cas_ok:
            r_edge = (8, 8, 4 if cur else 3)
        else:
            r_edge = (4 if cur else 5, 6 if cur else 3, 4 if cur else 3)
        codes = (0, r_addv, 1 if s1 >= 0 else 0, 1 if s1 >= 0 else 0) \
            + r_edge
        res[i] = codes[min(max(op, 0), 6)]

    adj_in = pack_transpose_blocks(
        collectives.all_gather(adj, dev, tiled=True), v)

    def split(x):
        t = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
        return tuple(t[s * per:(s + 1) * per].to(d, copy=True).contiguous()
                     for s, d in enumerate(mesh.devices))

    out = RowShardedState(mesh, split(vkey), split(valive), split(vver),
                          split(ecnt), tuple(adj), split(adj_in))
    return out, torch.from_numpy(res).to(dev)


# ----------------------------------------------------------------------------
# Distributed double collect (GetPath)
# ----------------------------------------------------------------------------
class DCollect(NamedTuple):
    found: torch.Tensor      # bool
    parent: torch.Tensor     # int32[V]
    touched: torch.Tensor    # bool[V]
    ver_ecnt: tuple          # S row blocks of ecnt (the snapshot stays sharded)
    ver_vver: tuple          # S row blocks of vver
    src_slot: torch.Tensor   # int32
    dst_slot: torch.Tensor   # int32


def dcollect(mesh: GraphMesh, state, k, l) -> DCollect:
    """One distributed TreeCollect: global lookups, ``dbfs``, and the
    version snapshot left in its row blocks."""
    rs = _as_rows(mesh, state)
    v = rs.capacity
    per = v // mesh.size
    dev = mesh.device
    vkey = np.concatenate([t.cpu().numpy() for t in rs.vkey])
    valive = np.concatenate([t.cpu().numpy() for t in rs.valive])
    sk = _global_find(vkey, valive, int(k), per, mesh.size)
    sl = _global_find(vkey, valive, int(l), per, mesh.size)
    found, parent, _, expanded, _ = dbfs(mesh, rs, sk, sl)
    touched = expanded.clone()
    for s in (sk, sl):
        if s >= 0:
            touched[s] = True
    i32 = dict(dtype=torch.int32, device=dev)
    return DCollect(found, parent, touched, rs.ecnt, rs.vver,
                    torch.tensor(sk, **i32), torch.tensor(sl, **i32))


def dcompare(mesh: GraphMesh, a: DCollect, b: DCollect) -> torch.Tensor:
    """Validation: ONE ``psum`` of the shards' local mismatch counts."""
    v = a.parent.shape[0]
    parts = []
    for s, d in enumerate(mesh.devices):
        _, _, per, row0 = _row_block_info(v, mesh.size, s)
        t_a = _on(a.touched[row0:row0 + per], d)
        t_b = _on(b.touched[row0:row0 + per], d)
        bad = (t_a != t_b) | (t_a & ((a.ver_ecnt[s] != b.ver_ecnt[s])
                                     | (a.ver_vver[s] != b.ver_vver[s])))
        parts.append(bad.sum().to(torch.int32))
    mism = collectives.psum(parts, mesh.device)
    same_tree = torch.equal(torch.where(a.touched, a.parent, -1),
                            torch.where(b.touched, b.parent, -1))
    return ((a.found == b.found) & (a.src_slot == b.src_slot)
            & (a.dst_slot == b.dst_slot) & (mism == 0) & same_tree)


def dget_path_session(mesh: GraphMesh, fetch_state, k, l,
                      max_rounds: int = 64):
    """Distributed GetPath: the double-collect loop on the host. Returns
    (found, length, keys, rounds)."""
    from repro_torch.core.bfs import extract_path

    prev = dcollect(mesh, fetch_state(), k, l)
    rounds = 1
    while rounds < max_rounds:
        st = _as_rows(mesh, fetch_state())
        cur = dcollect(mesh, st, k, l)
        rounds += 1
        if bool(dcompare(mesh, prev, cur)):
            ok = bool(cur.found)
            if not ok:
                return False, 0, [], rounds
            n, slots = extract_path(cur.parent, int(cur.src_slot),
                                    int(cur.dst_slot))
            vkey = np.concatenate([t.cpu().numpy() for t in st.vkey])
            keys = np.where(slots >= 0,
                            vkey[np.clip(slots, 0, st.capacity - 1)], -1)
            return True, int(n), [int(x) for x in keys[:n]], rounds
        prev = cur
    return False, 0, [], rounds
