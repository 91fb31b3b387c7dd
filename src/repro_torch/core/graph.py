"""Device-resident dynamic directed graph state, in PyTorch.

The port of ``repro.core.graph``: the same logical state as the JAX package
(a slot table plus word-packed out- and in-adjacency) held in torch tensors.

  vkey[V]   int32  key occupying each slot (EMPTY_KEY if the slot is free)
  valive[V] bool   logical presence (False = the paper's "marked" VNode)
  vver[V]   int32  slot epoch, bumped by every vertex add and logical remove
  ecnt[V]   int32  the paper's ``ecnt``: bumped by every edge add/remove on
                   the row, and by logical vertex removal
  adj_packed[V, W]    bit ``c % 32`` of word ``[r, c // 32]`` is edge r -> c
  adj_in_packed[V, W] bit ``w % 32`` of word ``[v, w // 32]`` is edge w -> v,
                      maintained by every mutation (the transpose invariant)

W = ceil(V / 32). Bits at columns >= V are always zero (the padding
invariant). Packed words are stored as ``torch.int32`` bit patterns: torch
does not implement shifts, ``~``, ordering or ``where`` for ``uint32``.
Because the top bit of a word is its sign, every word test here is
``!= 0``, never ``> 0``, and shifts are masked after the fact (int32 ``>>``
sign-extends). Convert to uint32 at the numpy boundary
(``repro_torch.convert``).

Entry points that create state (``make_graph``, ``make_op_batch``) place it
on the card unless the caller names another device; every other function
follows the device of its inputs.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

EMPTY_KEY = -1
WORD_BITS = 32
INT32_MAX = 2**31 - 1

_U32 = 1 << 32


def resolve_device(device=None) -> torch.device:
    """The device an entry point creates state on: the card unless the
    caller names another device. Raises when CUDA is asked for and absent,
    rather than quietly using the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch places state on the GPU by default and no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    return dev


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 tensor with the same bits."""
    return torch.where(x >= 2**31, x - _U32, x).to(torch.int32)


def wrap_int32_scalar(x: int) -> int:
    """A Python int in [0, 2**32) -> the int32 value with the same bits."""
    return x - _U32 if x >= 2**31 else x


def packed_width(v: int) -> int:
    """Words per packed row/bitset: ceil(v / 32)."""
    return -(-int(v) // WORD_BITS)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a boolean bitset along the last axis: bool[..., V] -> int32[..., W].

    Bit ``c % 32`` of word ``c // 32`` holds ``bits[..., c]``; pad bits
    past V are zero (the padding invariant)."""
    v = bits.shape[-1]
    w = packed_width(v)
    b = bits.to(torch.int64)
    pad = w * WORD_BITS - v
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    b = b.reshape(bits.shape[:-1] + (w, WORD_BITS))
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=bits.device)
    # bits within a word are disjoint, so the sum is the bitwise OR
    return wrap_int32((b << shifts).sum(-1))


def unpack_bits(words: torch.Tensor, v: int) -> torch.Tensor:
    """Inverse of ``pack_bits``: int32[..., W] -> bool[..., v]."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words[..., :, None] >> shifts) & 1
    flat = bits.reshape(words.shape[:-1] + (words.shape[-1] * WORD_BITS,))
    return flat[..., :v].to(torch.bool)


_UNPACK_BUDGET = 256 * 1024 * 1024   # bytes of one chunk's int32 transient


def unpack_dense(words: torch.Tensor, v: int) -> torch.Tensor:
    """``unpack_bits(words, v)`` as uint8[R, v], unpacked in row chunks
    into one preallocated result, so the transient stays near
    ``_UNPACK_BUDGET`` bytes instead of an int32 [R, W, 32] volume (19.4 GB
    at V = 69,632, for a 4.85 GB result)."""
    rows = words.shape[0]
    out = torch.empty((rows, v), dtype=torch.uint8, device=words.device)
    chunk = max(1, _UNPACK_BUDGET // (4 * WORD_BITS * max(1, words.shape[1])))
    for r0 in range(0, rows, chunk):
        out[r0:r0 + chunk] = unpack_bits(words[r0:r0 + chunk], v)
    return out


def pack_transpose(words: torch.Tensor, v: int) -> torch.Tensor:
    """Packed transpose int32[V, W] -> int32[V, W], bit (r, c) -> (c, r).
    A [V, V] transient: for oracles and checks, never on the hot path."""
    return pack_bits(unpack_bits(words, v).T.contiguous())


def pack_transpose_blocks(words: torch.Tensor, v: int,
                          chunk_words: int = 16) -> torch.Tensor:
    """``pack_transpose(words, v)`` built in column blocks of
    ``chunk_words`` words, so the transient stays near V * chunk_words *
    256 bytes instead of the [V, V] unpack."""
    out = torch.empty_like(words)
    for w0 in range(0, words.shape[1], chunk_words):
        w1 = min(words.shape[1], w0 + chunk_words)
        block = words[w0 * WORD_BITS:min(v, w1 * WORD_BITS)]
        out[:, w0:w1] = pack_bits(unpack_bits(block, v).T.contiguous())
    return out


def bit_word(col):
    """Word index of column ``col``."""
    return col // WORD_BITS


def bit_mask(col):
    """Single-bit int32 mask for column ``col`` (bit 31 is the sign bit)."""
    if isinstance(col, torch.Tensor):
        one = torch.ones_like(col, dtype=torch.int64)
        return wrap_int32(one << (col.to(torch.int64) % WORD_BITS))
    return wrap_int32_scalar(1 << (int(col) % WORD_BITS))


def get_bit(words: torch.Tensor, row, col) -> torch.Tensor:
    """Bool: is bit (row, col) set in a packed matrix int32[R, W]."""
    return (words[row, bit_word(col)] & bit_mask(col)) != 0


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit count of the low 32 bits, int32 (SWAR in int64:
    torch has no popcount, and int32 ``>>`` would sign-extend)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def or_reduce(words: torch.Tensor, axis: int) -> torch.Tensor:
    """Bitwise-OR reduction of int32 words along ``axis`` (a halving fold:
    torch has no OR reduction)."""
    x = torch.movedim(words, axis, 0)
    n = x.shape[0]
    if n == 0:
        return torch.zeros(x.shape[1:], dtype=words.dtype, device=words.device)
    p = 1
    while p < n:
        p *= 2
    if p != n:
        x = torch.cat([x, x.new_zeros((p - n,) + tuple(x.shape[1:]))])
    while p > 1:
        p //= 2
        x = x[:p] | x[p:2 * p]
    return x[0]


# ----------------------------------------------------------------------------
# THE traversable-edge predicate
# ----------------------------------------------------------------------------
def traversable(adj, alive_src, alive_dst=None):
    """The one traversable-edge predicate: edge u -> w is logically present
    iff ``adj[u, w] & alive[u] & alive[w]`` (a dead endpoint makes the
    ENode absent, the paper's marked-ptv rule).

    adj: dense 0/1 [R, V]; alive_src: bool[R]; alive_dst: bool[V] (defaults
    to ``alive_src``, valid only when R == V). Returns bool[R, V]."""
    if alive_dst is None:
        alive_dst = alive_src
    return (adj != 0) & alive_src[:, None] & alive_dst[None, :]


def traversable_packed(adj_packed, alive_src, alive_dst_words):
    """``traversable`` on packed words: int32[R, W] of live edge bits.
    ``alive_dst_words`` is ``pack_bits(alive)``; dead rows give zero words."""
    return torch.where(alive_src[:, None],
                       adj_packed & alive_dst_words[None, :],
                       torch.zeros((), dtype=adj_packed.dtype,
                                   device=adj_packed.device))


# Op codes for batched operations (unchanged from the JAX package: WAL
# records and clients see them).
OP_NOP = 0
OP_ADD_V = 1
OP_REM_V = 2
OP_CON_V = 3
OP_ADD_E = 4
OP_REM_E = 5
OP_CON_E = 6

OPCODE_NAMES = {
    OP_NOP: "NOP",
    OP_ADD_V: "AddV",
    OP_REM_V: "RemV",
    OP_CON_V: "HasV",
    OP_ADD_E: "AddE",
    OP_REM_E: "RemE",
    OP_CON_E: "HasE",
}

# Result codes: the paper's indicative strings, as integers.
R_PENDING = -1
R_FALSE = 0
R_TRUE = 1
R_VERTEX_NOT_PRESENT = 2
R_EDGE_NOT_PRESENT = 3
R_EDGE_PRESENT = 4
R_EDGE_ADDED = 5
R_EDGE_REMOVED = 6
R_TABLE_FULL = 7
R_CAS_FAIL = 8
R_RECOVERING = 9

RESULT_NAMES = {
    R_PENDING: "PENDING",
    R_FALSE: "false",
    R_TRUE: "true",
    R_VERTEX_NOT_PRESENT: "VERTEX NOT PRESENT",
    R_EDGE_NOT_PRESENT: "EDGE NOT PRESENT",
    R_EDGE_PRESENT: "EDGE PRESENT",
    R_EDGE_ADDED: "EDGE ADDED",
    R_EDGE_REMOVED: "EDGE REMOVED",
    R_TABLE_FULL: "TABLE FULL",
    R_CAS_FAIL: "CAS FAIL",
    R_RECOVERING: "RECOVERING",
}


class GraphState(NamedTuple):
    """Dense dynamic graph state; every field is a tensor on one device."""

    vkey: torch.Tensor           # int32[V]
    valive: torch.Tensor         # bool[V]
    vver: torch.Tensor           # int32[V]
    ecnt: torch.Tensor           # int32[V]
    adj_packed: torch.Tensor     # int32[V, W]  out-edges
    adj_in_packed: torch.Tensor  # int32[V, W]  in-edges

    @property
    def capacity(self) -> int:
        return self.vkey.shape[0]

    @property
    def words(self) -> int:
        return self.adj_packed.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vkey.device

    @property
    def adj(self) -> torch.Tensor:
        """Dense uint8[V, V] adjacency view, unpacked on demand in row
        chunks (``unpack_dense``); not cached."""
        return unpack_dense(self.adj_packed, self.capacity)

    @property
    def adj_in(self) -> torch.Tensor:
        """Dense uint8[V, V] in-adjacency view: adj_in[v, w] = adj[w, v]."""
        return unpack_dense(self.adj_in_packed, self.capacity)

    @property
    def alive_words(self) -> torch.Tensor:
        """Packed liveness bitset int32[W] (for ``traversable_packed``)."""
        return pack_bits(self.valive)


class OpBatch(NamedTuple):
    """A batch of B operations from B logical actors. Lane order is the
    linearization order; ``expect`` >= 0 makes an edge op a compare-and-set
    on the source vertex's ``ecnt``."""

    opcode: torch.Tensor  # int32[B]
    key1: torch.Tensor    # int32[B]
    key2: torch.Tensor    # int32[B]
    expect: torch.Tensor  # int32[B]

    @property
    def lanes(self) -> int:
        return self.opcode.shape[0]


# ----------------------------------------------------------------------------
# Construction / growth
# ----------------------------------------------------------------------------
def make_graph(capacity: int = 256, device=None) -> GraphState:
    """Fresh empty graph with the given slot capacity, on the card unless
    ``device`` names another."""
    dev = resolve_device(device)
    v = int(capacity)
    w = packed_width(v)
    i32 = dict(dtype=torch.int32, device=dev)
    return GraphState(
        vkey=torch.full((v,), EMPTY_KEY, **i32),
        valive=torch.zeros((v,), dtype=torch.bool, device=dev),
        vver=torch.zeros((v,), **i32),
        ecnt=torch.zeros((v,), **i32),
        adj_packed=torch.zeros((v, w), **i32),
        adj_in_packed=torch.zeros((v, w), **i32),
    )


def grow(state: GraphState, new_capacity: int) -> GraphState:
    """Functionally grow capacity. Existing slots, versions and edges are
    kept; new slots are free. A column's (word, bit) address depends only
    on its index, so packed rows grow by zero padding."""
    old = state.capacity
    if new_capacity <= old:
        return state
    pad = new_capacity - old
    wpad = packed_width(new_capacity) - state.words
    f = torch.nn.functional.pad
    return GraphState(
        vkey=f(state.vkey, (0, pad), value=EMPTY_KEY),
        valive=f(state.valive, (0, pad)),
        vver=f(state.vver, (0, pad)),
        ecnt=f(state.ecnt, (0, pad)),
        adj_packed=f(state.adj_packed, (0, wpad, 0, pad)),
        adj_in_packed=f(state.adj_in_packed, (0, wpad, 0, pad)),
    )


def make_op_batch(ops, lanes: int | None = None, device=None) -> OpBatch:
    """Build an OpBatch from a list of (opcode, k1[, k2[, expect]])."""
    dev = resolve_device(device)
    b = lanes if lanes is not None else len(ops)
    cols = np.zeros((4, b), np.int32)
    cols[1:] = -1
    for i, op in enumerate(ops):
        cols[:len(op), i] = op
    return OpBatch(*(torch.from_numpy(c.copy()).to(dev) for c in cols))


# ----------------------------------------------------------------------------
# Lookups (the LocV / LocC analogues)
# ----------------------------------------------------------------------------
def _first_hit(hit: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis as int32, -1 if none
    (``jnp.argmax`` semantics: the first maximum)."""
    idx = hit.to(torch.int8).argmax(-1).to(torch.int32)
    return torch.where(hit.any(-1), idx, torch.full_like(idx, -1))


def find_slot(state: GraphState, key) -> torch.Tensor:
    """Slot index of the alive vertex with ``key``; -1 if absent (0-d int32)."""
    return _first_hit((state.vkey == key) & state.valive)


def find_slots(state: GraphState, keys: torch.Tensor) -> torch.Tensor:
    """Vectorized find_slot: keys int32[B] -> slot ids int32[B] (-1 absent)."""
    return _first_hit((state.vkey[None, :] == keys[:, None])
                      & state.valive[None, :])


def contains_vertex(state: GraphState, key) -> torch.Tensor:
    """ContainsVertex(k): a wait-free lookup."""
    return find_slot(state, int(key)) >= 0


def contains_edge(state: GraphState, k, l) -> torch.Tensor:
    """ContainsEdge(k, l): a result code (R_EDGE_PRESENT etc.)."""
    sk = int(find_slot(state, int(k)))
    sl = int(find_slot(state, int(l)))
    if sk < 0 or sl < 0:
        code = R_VERTEX_NOT_PRESENT
    else:
        code = (R_EDGE_PRESENT if bool(get_bit(state.adj_packed, sk, sl))
                else R_EDGE_NOT_PRESENT)
    return torch.tensor(code, dtype=torch.int32, device=state.device)


def num_vertices(state: GraphState) -> torch.Tensor:
    return state.valive.sum().to(torch.int32)


def num_edges(state: GraphState) -> torch.Tensor:
    """Edges between alive endpoints: one popcount over the
    ``traversable_packed`` words."""
    live = traversable_packed(state.adj_packed, state.valive,
                              state.alive_words)
    return popcount(live).sum().to(torch.int32)


def to_networkx_like(state: GraphState) -> tuple[list[int], list[tuple[int, int]]]:
    """Host-side export for tests: (vertex keys, edge key-pairs)."""
    vkey = state.vkey.cpu().numpy()
    valive = state.valive.cpu().numpy()
    live = traversable_packed(state.adj_packed, state.valive,
                              state.alive_words)
    rows, cols = np.nonzero(unpack_bits(live, state.capacity).cpu().numpy())
    verts = [int(vkey[i]) for i in np.nonzero(valive)[0]]
    return verts, [(int(vkey[r]), int(vkey[c])) for r, c in zip(rows, cols)]


def transpose_invariant(state, chunk_words: int = 16) -> torch.Tensor:
    """The in-adjacency maintenance invariant: ``adj_in_packed ==
    pack_transpose(adj_packed)`` and the converse, pad bits included.

    Checked in column blocks of ``chunk_words`` words (32 * chunk_words
    source rows at a time), so the transient stays near
    V * chunk_words * 256 bytes instead of the [V, V] unpack. Returns a
    0-d bool tensor."""
    v = state.capacity
    ok = True
    for a, b in ((state.adj_packed, state.adj_in_packed),
                 (state.adj_in_packed, state.adj_packed)):
        for w0 in range(0, state.words, chunk_words):
            w1 = min(state.words, w0 + chunk_words)
            rows = a[w0 * WORD_BITS:min(v, w1 * WORD_BITS)]
            want = pack_bits(unpack_bits(rows, v).T.contiguous())
            ok = ok and torch.equal(b[:, w0:w1], want)
    return torch.tensor(ok, device=state.device)


def version_vector(state: GraphState) -> torch.Tensor:
    """The collect-validation vector: (ecnt, vver) stacked as int32[V, 2]."""
    return torch.stack([state.ecnt, state.vver], dim=-1)
