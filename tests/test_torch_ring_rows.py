"""How the port's ``EpochRing.push`` finds the changed rows: from the
version counters and the in-mirror rows of the slots an AddVertex
allocated, never from a whole-mirror compare (DESIGN.md §13).

Seeded streams through the port's ``apply_ops_fast`` at capacity 72 (not
a multiple of 32): every op, CAS expects, negative keys -2 and -1, the
RemoveVertex of a hub with many in-arcs and the re-add of its key, and a
compaction between segments, each segment behind a fresh ring. Every
record equals a whole-mirror diff of the two states (written here) and
the JAX ring's record for the same states; a sharded stream's records
equal the dense ring's; an arc that AddVertex's scrub clears without a
counter moving is recorded; and no op inside ``push`` yields a tensor of
V x W elements."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import repro.core as J
import repro_torch.core as T
from repro_torch.convert import state_to_numpy
from repro_torch.core import partition as P
from repro_torch.core.distributed import make_graph_mesh
from repro_torch.core.graph import get_bit
from repro_torch.core.ops import compact

V = 72
W = T.packed_width(V)
HUB = 5
LOADED = 60                     # keys 0..59 fill slots 0..59; 12 stay free
SCALARS = ("vkey", "valive", "vver", "ecnt")
OPS = (T.OP_ADD_V, T.OP_REM_V, T.OP_CON_V, T.OP_ADD_E, T.OP_REM_E,
       T.OP_CON_E)
MIX = (0.14, 0.08, 0.08, 0.4, 0.18, 0.12)


def _filled():
    st = T.make_graph(V, device="cpu")
    st, _ = T.apply_ops_fast(st, T.make_op_batch(
        [(T.OP_ADD_V, k) for k in range(LOADED)], device="cpu"))
    return st


def _random_ops(rng, lanes):
    opc = rng.choice(OPS, size=lanes, p=MIX)
    k1 = rng.integers(-2, 90, lanes)
    k2 = rng.integers(-2, 90, lanes)
    cas = rng.random(lanes) < 0.2
    expect = np.where(cas, rng.integers(0, 4, lanes), -1)
    return [(int(o), int(a), int(b), int(e))
            for o, a, b, e in zip(opc, k1, k2, expect)]


def _segment_ops(rng, rounds):
    """The batches of one segment: random lanes, with arcs into the hub
    at round 2, its RemoveVertex at round 4 and its re-add at round 5,
    and AddVertex(-1) with arcs into key -1 before every random round."""
    out = []
    for r in range(rounds):
        ops = _random_ops(rng, 24)
        if r == 2:
            ops += [(T.OP_ADD_E, int(k), HUB)
                    for k in rng.integers(0, LOADED, 20)]
        elif r == 4:
            ops = [(T.OP_REM_V, HUB)] + ops[:8]
        elif r == 5:
            ops.append((T.OP_ADD_V, HUB))
        else:
            ops = [(T.OP_ADD_V, -1), (T.OP_ADD_E, int(rng.integers(0, 20)),
                                      -1)] + ops
        out.append(ops)
    return out


def _stream(seed, segments=3, rounds=12):
    """[[state, ...], ...]: each segment starts at a compacted state (the
    first at the filled one) and holds the states its batches publish."""
    rng = np.random.default_rng(seed)
    st = _filled()
    out = []
    for _ in range(segments):
        seg = [st]
        for ops in _segment_ops(rng, rounds):
            st, _ = T.apply_ops_fast(st, T.make_op_batch(ops, device="cpu"))
            seg.append(st)
        out.append(seg)
        st = compact(st)
    return out


def _whole_mirror_record(prev, state):
    """The record the ring must hold for prev -> state: every row where
    any of the five fields differs, found by comparing whole copies."""
    a, b = state_to_numpy(prev), state_to_numpy(state)
    changed = (a[4] != b[4]).any(1)
    for x, y in zip(a[:4], b[:4]):
        changed |= x != y
    rows = np.nonzero(changed)[0].astype(np.int32)
    return {"versions": np.stack([b[3], b[2]], -1), "rows": rows,
            "vkey_xor": a[0][rows] ^ b[0][rows],
            "valive_xor": a[1][rows] ^ b[1][rows],
            "vver_xor": a[2][rows] ^ b[2][rows],
            "ecnt_xor": a[3][rows] ^ b[3][rows],
            "adj_xor": a[4][rows] ^ b[4][rows]}


def _assert_record(rec, want, what):
    for f, y in want.items():
        x = getattr(rec, f)
        assert x.dtype == y.dtype and x.shape == y.shape, (what, f)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: {f}")


def _jax_state(st):
    return J.GraphState(*(jnp.asarray(x) for x in state_to_numpy(st)))


def _ring(states, retain=64):
    ring = T.EpochRing(retain)
    ring.reset(0, states[0])
    for e, st in enumerate(states[1:], 1):
        ring.push(e, st)
    return ring


@pytest.mark.parametrize("seed", range(6))
def test_records_equal_a_whole_mirror_diff_and_the_jax_ring(seed):
    rows = 0
    for i, seg in enumerate(_stream(seed)):
        ring = _ring(seg)
        jr = J.EpochRing(64)
        jr.reset(0, _jax_state(seg[0]))
        for e, st in enumerate(seg[1:], 1):
            jr.push(e, _jax_state(st))
        assert len(ring._records) == len(jr._records) == len(seg) - 1
        for rec, jrec, prev, st in zip(ring._records, jr._records, seg,
                                       seg[1:]):
            what = f"segment {i}, epoch {rec.epoch}"
            _assert_record(rec, _whole_mirror_record(prev, st), what)
            _assert_record(rec, {f: np.asarray(getattr(jrec, f))
                                 for f in _whole_mirror_record(prev, st)},
                           f"{what} (JAX)")
            rows += rec.rows.size
    assert rows > 0


def test_an_arc_the_scrub_clears_without_a_counter_is_recorded():
    st = _filled()
    # slot 60 takes key -1 (alive, still "free" to the allocator) and the
    # arc 3 -> slot 60; the next AddVertex reuses slot 60 and its scrub
    # clears that arc, moving no counter of row 3
    a, _ = T.apply_ops_fast(st, T.make_op_batch(
        [(T.OP_ADD_V, -1), (T.OP_ADD_E, 3, -1)], device="cpu"))
    assert int(a.vkey[60]) == -1 and bool(a.valive[60])
    assert get_bit(a.adj_packed, torch.tensor(3), torch.tensor(60))
    b, _ = T.apply_ops_fast(a, T.make_op_batch([(T.OP_ADD_V, 100)],
                                               device="cpu"))
    assert int(b.vkey[60]) == 100
    assert not get_bit(b.adj_packed, torch.tensor(3), torch.tensor(60))
    for f in SCALARS:
        assert getattr(a, f)[3] == getattr(b, f)[3], f
    ring = _ring([st, a, b])
    rec = ring._records[-1]
    assert 3 in rec.rows.tolist()
    _assert_record(rec, _whole_mirror_record(a, b), "scrub")
    for x, y in zip(state_to_numpy(ring.state_at(1)), state_to_numpy(a)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 1])
def test_sharded_records_equal_the_dense_ring(seed):
    mesh = make_graph_mesh(["cpu"], shards=4)
    rng = np.random.default_rng(seed)
    dense = _filled()
    sharded = P.shard_state(mesh, dense)
    for _ in range(2):
        ds, ss = [dense], [sharded]
        for ops in _segment_ops(rng, 10):
            batch = T.make_op_batch(ops, device="cpu")
            dense, _ = T.apply_ops_fast(dense, batch)
            sharded, _ = P.apply_ops_fast(sharded, batch)
            ds.append(dense)
            ss.append(sharded)
        dr, sr = _ring(ds), _ring(ss)
        assert len(dr._records) == len(sr._records) == len(ds) - 1
        for a, b in zip(sr._records, dr._records):
            _assert_record(a, {f: getattr(b, f) for f in (
                "versions", "rows", "vkey_xor", "valive_xor", "vver_xor",
                "ecnt_xor", "adj_xor")}, f"sharded epoch {a.epoch}")
        dense, sharded = compact(dense), P.compact(sharded)


class _Shapes(TorchFunctionMode):
    """Records the element count of every tensor an op yields."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        stack = [out]
        while stack:
            x = stack.pop()
            if isinstance(x, torch.Tensor):
                self.sizes.append((getattr(func, "__name__", str(func)),
                                   tuple(x.shape)))
            elif isinstance(x, (tuple, list)):
                stack.extend(x)
        return out


def test_push_forms_no_tensor_of_the_whole_mirror():
    (seg, *_) = _stream(3, segments=1)
    ring = T.EpochRing(64)
    ring.reset(0, seg[0])
    for e, st in enumerate(seg[1:], 1):
        with _Shapes() as mode:
            ring.push(e, st)
        k = ring._records[-1].rows.size
        assert 0 < k < V, e
        # the one host buffer: the version vector, the rows, five patches
        host = 2 * V + k * (5 + W)
        big = [(name, shape) for name, shape in mode.sizes
               if int(np.prod(shape)) >= V * W and shape != (host,)]
        assert not big, (e, big)
        assert any(shape == (host,) for _, shape in mode.sizes)
