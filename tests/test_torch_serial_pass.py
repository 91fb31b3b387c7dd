"""The serial correction pass of ``apply_ops_fast`` (kernels/serial_pass).

On the card (``cuda``-marked, skipped without one) the kernel is held
against the host pass (``kernels/serial_pass/ref.py``) on the same CUDA state,
bit for bit: result codes (lanes outside the mask keep theirs), vkey,
valive, vver, ecnt and both packed mirrors. The cases are lane sequences
whose answers depend on the lanes before them: a RemoveVertex then an
AddVertex of one key, two AddVertex lanes on one key, a RemoveVertex of a
vertex with a self-loop, RemoveVertex of both ends of an edge in both
orders, CAS edge lanes after a RemoveVertex, edge lanes on a key an earlier
lane added, out-of-range opcodes, negative keys (an AddVertex of -1 makes a
slot alive whose key is EMPTY_KEY, which the next AddVertex takes again),
a full table, a batch that overflows the free slots, V not a multiple of
32, random batches, and one state of 200,003 slots, where a thread of the
kernel owns more than one slot. ``apply_ops_fast`` on the card equals
``apply_ops_fast`` on the CPU and launches the kernel once a batch with
conflicting lanes; a batch that overflows the free slots is replayed in
that one launch, every lane selected.

On the CPU the wrapper runs the host pass in place, and ``apply_ops_fast``
equals ``apply_ops`` on every hand-made case whose opcodes are in range
(an out-of-range opcode is clean in the fast engine, which gives it
R_FALSE, and clipped to ContainsEdge by the serial one). This file does not import
jax, so it runs on the card's installation:

    python -m pytest -q tests/test_torch_serial_pass.py
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core.graph import GraphState, OpBatch, wrap_int32
from repro_torch.core.ops import _alloc_schedule, _lane_conflicts
from repro_torch.kernels.serial_pass import ops as sp_ops
from repro_torch.kernels.serial_pass.ops import serial_pass
from repro_torch.kernels.serial_pass.ref import _SerialPass, _serial_masked
from repro_torch.obs import trace

V = 45                 # not a multiple of 32: W = 2, 19 padding bits a row
UNSET = 77             # a code no lane returns: lanes outside the mask


def _setup(v, keys, edges, free=()):
    """A CPU state of capacity ``v`` with ``keys`` alive (in slot order) and
    the arcs ``edges``; the keys ``free`` are then removed and their slots
    compacted."""
    ops = [(T.OP_ADD_V, k) for k in keys]
    ops += [(T.OP_ADD_E, a, b) for a, b in edges]
    ops += [(T.OP_REM_V, k) for k in free]
    st, res = T.apply_ops(T.make_graph(v, device="cpu"),
                          T.make_op_batch(ops, device="cpu"))
    assert (res.numpy() > 0).all()
    return T.compact(st)


def _ecnt(st, key):
    return int(st.ecnt[int(T.find_slot(st, key))])


BASE_KEYS = list(range(1, 12))
BASE_EDGES = [(1, 2), (2, 1), (3, 1), (3, 2), (5, 1), (4, 4), (6, 4),
              (7, 8), (8, 7), (9, 10)]


def _case(name):
    """(state, batch ops, lanes the mask selects or None for the conflict
    mask) of case ``name``, on the CPU."""
    st = _setup(V, BASE_KEYS, BASE_EDGES)
    mask = None
    if name == "remv_then_addv":
        ops = [(T.OP_REM_V, 1), (T.OP_ADD_V, 1), (T.OP_CON_V, 1),
               (T.OP_ADD_E, 1, 2), (T.OP_CON_E, 2, 1), (T.OP_ADD_E, 2, 1)]
    elif name == "two_addv_one_key":
        ops = [(T.OP_ADD_V, 50), (T.OP_ADD_V, 50), (T.OP_CON_V, 50),
               (T.OP_ADD_V, 51), (T.OP_REM_V, 50), (T.OP_ADD_V, 50)]
    elif name == "remv_self_loop":
        ops = [(T.OP_REM_V, 4), (T.OP_CON_V, 4), (T.OP_CON_E, 4, 4),
               (T.OP_ADD_V, 4), (T.OP_CON_E, 4, 4)]
    elif name == "remv_both_ends":
        ops = [(T.OP_REM_V, 7), (T.OP_REM_V, 8), (T.OP_CON_E, 7, 8)]
    elif name == "remv_both_ends_reversed":
        ops = [(T.OP_REM_V, 8), (T.OP_REM_V, 7), (T.OP_CON_E, 8, 7)]
    elif name == "cas_after_remv":
        e3, e5 = _ecnt(st, 3), _ecnt(st, 5)
        ops = [(T.OP_ADD_E, 3, 9, e3), (T.OP_REM_V, 1),
               (T.OP_ADD_E, 3, 10, e3 + 1), (T.OP_ADD_E, 3, 11, e3 + 2),
               (T.OP_REM_E, 5, 1, e5 + 1), (T.OP_REM_E, 5, 2, e5 + 1),
               (T.OP_ADD_E, 6, 9, 0)]
    elif name == "edges_on_added_key":
        ops = [(T.OP_ADD_V, 60), (T.OP_ADD_E, 60, 1), (T.OP_ADD_E, 1, 60),
               (T.OP_CON_E, 60, 1), (T.OP_ADD_E, 60, 60),
               (T.OP_REM_E, 60, 1), (T.OP_REM_E, 60, 1),
               (T.OP_ADD_E, 60, 2, 2), (T.OP_ADD_E, 60, 3, 0)]
    elif name == "out_of_range_opcodes":
        ops = [(-3, 1), (7, 1, 2), (99, 2, 1), (T.OP_NOP, 1), (-1, 5),
               (1 << 30, 3, 2), (T.OP_REM_V, 2), (8, 1, 2)]
        mask = list(range(len(ops)))
    elif name == "negative_keys":
        ops = [(T.OP_ADD_V, -1), (T.OP_CON_V, -1), (T.OP_ADD_V, -1),
               (T.OP_ADD_E, -1, 3), (T.OP_ADD_V, 70), (T.OP_CON_V, -1),
               (T.OP_ADD_E, 70, -1), (T.OP_REM_V, -1), (T.OP_ADD_V, -5),
               (T.OP_ADD_E, -5, 1), (T.OP_CON_E, -5, 1), (T.OP_REM_V, -5),
               (T.OP_CON_E, 1, -2), (T.OP_REM_E, -2, -2)]
    elif name == "table_full":
        ops = [(T.OP_REM_V, 2)] + [(T.OP_ADD_V, 100 + k)
                                   for k in range(V - len(BASE_KEYS) + 2)]
        mask = list(range(len(ops)))
    elif name == "overflow_mixed":
        # 34 free slots, 36 new keys: the fast engine replays every lane
        ops = [(T.OP_REM_V, 3), (T.OP_ADD_V, 3), (T.OP_NOP, 1)]
        ops += [(T.OP_ADD_V, 200 + k) for k in range(20)]
        ops += [(T.OP_ADD_E, 200, 201), (T.OP_ADD_E, 3, 200, 0),
                (T.OP_ADD_E, 3, 201, 0), (T.OP_CON_V, 219),
                (T.OP_REM_V, 205), (T.OP_ADD_V, 205), (T.OP_CON_E, 200, 201)]
        ops += [(T.OP_ADD_V, 300 + k) for k in range(16)]
        ops += [(T.OP_ADD_E, 315, 1), (T.OP_CON_V, 315), (T.OP_ADD_V, 4)]
        mask = list(range(len(ops)))
    elif name == "column_31_and_last":
        st = _setup(V, list(range(100, 100 + V)),
                    [(131, 144), (144, 131), (100, 131), (144, 144),
                     (130, 131), (131, 131), (102, 131), (131, 103)],
                    free=(102, 103))
        ops = [(T.OP_REM_V, 131), (T.OP_ADD_V, 131), (T.OP_ADD_E, 144, 131),
               (T.OP_REM_V, 144), (T.OP_ADD_V, 7), (T.OP_CON_E, 100, 131),
               (T.OP_ADD_E, 7, 7)]
    elif name == "v_multiple_of_32":
        st = _setup(64, list(range(64)), [(31, 63), (63, 31), (0, 31),
                                          (32, 0), (5, 31), (31, 6)],
                    free=(5, 6))
        ops = [(T.OP_REM_V, 31), (T.OP_REM_V, 63), (T.OP_ADD_V, 200),
               (T.OP_ADD_E, 200, 0), (T.OP_ADD_E, 32, 200),
               (T.OP_REM_V, 0)]
    elif name.startswith("random"):
        seed = int(name[len("random"):])
        rng = np.random.default_rng(seed)
        v = 300 + 37 * seed
        keys = list(range(v - 40))
        st = _setup(v, keys, [tuple(e) for e in
                              rng.integers(0, v - 40, (4 * v, 2)).tolist()])
        b = 400
        opc = rng.choice([T.OP_ADD_V, T.OP_REM_V, T.OP_CON_V, T.OP_ADD_E,
                          T.OP_REM_E, T.OP_CON_E], b,
                         p=[0.2, 0.2, 0.1, 0.2, 0.2, 0.1])
        k1 = rng.integers(-2, v, b)
        k2 = rng.integers(-2, v, b)
        expect = np.where(rng.random(b) < 0.2, rng.integers(0, 6, b), -1)
        ops = [tuple(int(x) for x in row)
               for row in np.stack([opc, k1, k2, expect], 1)]
        if seed % 2:
            mask = list(range(b))
    else:
        raise KeyError(name)
    batch = T.make_op_batch(ops, device="cpu")
    if mask is None:
        m = _lane_conflicts(batch)
    else:
        m = torch.zeros(len(ops), dtype=torch.bool)
        m[mask] = True
    return st, batch, m


CASES = ["remv_then_addv", "two_addv_one_key", "remv_self_loop",
         "remv_both_ends", "remv_both_ends_reversed", "cas_after_remv",
         "edges_on_added_key", "out_of_range_opcodes", "negative_keys",
         "table_full", "overflow_mixed", "column_31_and_last", "v_multiple_of_32", "random0",
         "random1", "random2"]
# the fast engine's own cases: the mask is its conflict mask
FAST = [c for c in CASES if c != "out_of_range_opcodes"]
# and those on which it places slots as apply_ops does: in a random batch
# an AddVertex of -1 leaves a live slot whose key is EMPTY_KEY, which the
# next AddVertex takes again, while the allocation schedule counts it taken
SERIAL_PLACED = [c for c in FAST if not c.startswith("random")]


def _to(st, batch, mask, device):
    return (GraphState(*(t.to(device) for t in st)),
            OpBatch(*(t.to(device) for t in batch)), mask.to(device))


def _host_pass(st, batch, mask):
    """The host pass on a copy of ``st``: (state, codes)."""
    st = GraphState(*(t.clone() for t in st))
    lanes = torch.nonzero(mask).flatten().tolist()
    res = _serial_masked(st, batch, lanes,
                         np.full((batch.lanes,), UNSET, np.int32))
    return st, torch.from_numpy(res).to(st.device)


def _wrapper_pass(st, batch, mask):
    """The wrapper on a copy of ``st``: (state, codes)."""
    st = GraphState(*(t.clone() for t in st))
    res = torch.full((batch.lanes,), UNSET, dtype=torch.int32,
                     device=st.device)
    out = serial_pass(*st, *batch, mask, res)
    assert out is res
    return st, res


def _same(got, want, what):
    (gst, gres), (wst, wres) = got, want
    assert torch.equal(gres, wres), f"{what}: codes"
    for name, a, b in zip(GraphState._fields, gst, wst):
        assert torch.equal(a, b), f"{what}: {name}"


def _changes(st, batch, mask):
    """The case changes the state: a pass that did nothing fails."""
    after, _ = _host_pass(st, batch, mask)
    return any(not torch.equal(a, b) for a, b in zip(after, st))


# ---------------------------------------------------------------------------
# CPU: the wrapper's plain path, and the fast engine on the same cases
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", CASES)
def test_cpu_wrapper_is_the_host_pass_in_place(case):
    st, batch, mask = _case(case)
    assert mask.any() and _changes(st, batch, mask)
    _same(_wrapper_pass(st, batch, mask), _host_pass(st, batch, mask), case)


@pytest.mark.parametrize("case", SERIAL_PLACED)
def test_cpu_fast_engine_equals_apply_ops(case):
    st, batch, _ = _case(case)
    _same(T.apply_ops_fast(st, batch), T.apply_ops(st, batch), case)
    assert bool(T.transpose_invariant(T.apply_ops_fast(st, batch)[0]))


def test_wrapper_refuses_another_device():
    st, batch, mask = _case("remv_then_addv")
    meta = GraphState(*(torch.empty_like(t, device="meta") for t in st))
    with pytest.raises(ValueError, match="no serial pass kernel"):
        serial_pass(*meta, *batch, mask, torch.zeros(batch.lanes,
                                                     dtype=torch.int32))


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the serial pass kernel needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_device_pass_equals_host_pass(cuda_device, case):
    st, batch, mask = _to(*_case(case), cuda_device)
    before = sp_ops.launches
    got = _wrapper_pass(st, batch, mask)
    torch.cuda.synchronize()
    assert sp_ops.launches == before + 1
    _same(got, _host_pass(st, batch, mask), case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FAST)
def test_cuda_fast_engine_equals_the_cpu_one(cuda_device, case):
    """The whole engine on the card (the kernel for its conflicting lanes)
    against the engine on the CPU (the host pass for them)."""
    cpu = _case(case)
    st, batch, _ = _to(*cpu, cuda_device)
    before = sp_ops.launches
    fast = T.apply_ops_fast(st, batch)
    torch.cuda.synchronize()
    want = T.apply_ops_fast(*cpu[:2])
    _same((GraphState(*(t.cpu() for t in fast[0])), fast[1].cpu()), want,
          case)
    replay = bool(_alloc_schedule(st, batch)[2])
    assert replay == (case in ("table_full", "overflow_mixed"))
    assert sp_ops.launches == before + 1
    assert bool(T.transpose_invariant(fast[0]))


@pytest.mark.cuda
def test_cuda_no_conflicts_no_launch(cuda_device):
    st = _setup(V, BASE_KEYS, BASE_EDGES)
    batch = T.make_op_batch([(T.OP_ADD_E, 1, 3), (T.OP_CON_V, 5),
                             (T.OP_ADD_V, 40)], device="cpu")
    st, batch, _ = _to(st, batch, torch.zeros(3, dtype=torch.bool),
                       cuda_device)
    before = sp_ops.launches
    _same(T.apply_ops_fast(st, batch), T.apply_ops(st, batch), "clean")
    assert sp_ops.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["table_full", "overflow_mixed"])
def test_cuda_overflowing_batch_is_replayed_in_one_launch(cuda_device, case):
    """A batch whose AddVertex lanes overflow the free slots goes through
    the kernel with every lane selected, not through the host."""
    st, batch, _ = _to(*_case(case), cuda_device)
    before = sp_ops.launches
    with trace.capture() as rec:
        fast = T.apply_ops_fast(st, batch)
    torch.cuda.synchronize()
    assert sp_ops.launches == before + 1
    _same(fast, T.apply_ops(st, batch), case)
    ev = rec.events()
    (app,) = [e for e in ev if e["name"] == "ops.apply"]
    (ser,) = [e for e in ev if e["name"] == "ops.serial_pass"]
    assert app["args"] == {"lanes": batch.lanes, "serial_lanes": batch.lanes,
                           "replay": True, "in_place": False}
    assert ser["args"] == {"lanes": batch.lanes, "engine": "device"}
    assert T.R_TABLE_FULL in fast[1].tolist()


BIG_V = 200_003        # past 132 x 1,024: a block's slice outgrows its threads
KERNEL_THREADS = 1024  # kernel.cu's THREADS


def _big_state(device, rng):
    """(state, the slot of thread t's second slot in block b): V = BIG_V
    slots on ``device``, slot s alive with key s + 1,000 but for three
    free slots, each a thread's second slot; random arcs, self-loops and
    arcs to and from the free slots (stale bits the scrub must clear) in
    both mirrors."""
    v = BIG_V
    w = (v + 31) // 32
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per = -(-v // sms)
    spare = min(per, v - (sms - 1) * per) - KERNEL_THREADS
    assert spare > 8, "every block's slice holds more slots than threads"

    def second(b, t):
        return b * per + KERNEL_THREADS + t % spare

    free = [second(1, 5), second(sms // 3 + 1, 17), second(sms - 1, 2)]
    vkey = torch.arange(v, dtype=torch.int32, device=device) + 1000
    vkey[free] = T.EMPTY_KEY
    valive = vkey != T.EMPTY_KEY
    vver = valive.to(torch.int32)
    ecnt = torch.from_numpy(rng.integers(0, 5, v).astype(np.int32)).to(device)
    hot = [second(b, t) for b, t in ((2, 3), (sms // 4, 2), (sms // 4 + 1, 1),
                                     (sms // 2, 0), (2 * sms // 3, 7))]
    u = rng.integers(0, v, 6 * v)
    c = rng.integers(0, v, 6 * v)
    extra = [(s, hot[0]) for s in hot + free + [0, v - 1]]
    extra += [(hot[1], hot[2]), (hot[3], hot[4]), (free[0], hot[1]),
              (hot[2], free[1]), (v - 1, v - 1)]
    u = np.concatenate([u, [a for a, _ in extra]])
    c = np.concatenate([c, [b for _, b in extra]])
    arcs = np.unique(u.astype(np.int64) * v + c)

    def mirror(rows, cols):
        words = torch.from_numpy(rows * w + cols // 32).to(device)
        bits = torch.from_numpy(np.left_shift(1, cols % 32)).to(device)
        uw, inv = torch.unique(words, return_inverse=True)
        acc = torch.zeros(uw.shape, dtype=torch.int64, device=device)
        acc.index_add_(0, inv, bits)   # distinct arcs: a sum is an OR
        adj = torch.zeros((v, w), dtype=torch.int32, device=device)
        adj.view(-1)[uw] = wrap_int32(acc)
        return adj

    st = GraphState(vkey, valive, vver, ecnt, mirror(arcs // v, arcs % v),
                    mirror(arcs % v, arcs // v))
    return st, hot, free


@pytest.mark.cuda
def test_cuda_device_pass_at_full_size_past_the_first_stride(cuda_device):
    """At V = 200,003 a thread of the kernel owns two slots of its block's
    slice; the lanes find, free, remove and scrub such second slots (free
    slots, a vertex with a self-loop and many in-sources, edges between
    them, keys an earlier lane added), among 320 random lanes."""
    rng = np.random.default_rng(7)
    st, hot, free = _big_state(cuda_device, rng)
    key = [int(k) for k in st.vkey[hot].tolist()]
    ops = [(T.OP_ADD_V, 5), (T.OP_ADD_E, 5, key[1]), (T.OP_ADD_E, key[2], 5),
           (T.OP_CON_E, key[2], 5), (T.OP_REM_V, key[0]),
           (T.OP_CON_E, key[0], key[0]), (T.OP_ADD_V, key[0]),
           (T.OP_ADD_E, key[0], key[1], 0), (T.OP_ADD_E, key[0], key[2], 0),
           (T.OP_REM_E, key[1], key[2]), (T.OP_REM_E, key[3], key[4], 99),
           (T.OP_CON_V, BIG_V - 1 + 1000), (T.OP_ADD_V, 5), (T.OP_REM_V, 5),
           (T.OP_ADD_V, 6), (T.OP_ADD_V, 7), (T.OP_CON_V, 6),
           (T.OP_ADD_E, 6, 7), (T.OP_REM_V, key[4]), (T.OP_ADD_V, 8)]
    b = 320
    opc = rng.choice([T.OP_ADD_V, T.OP_REM_V, T.OP_CON_V, T.OP_ADD_E,
                      T.OP_REM_E, T.OP_CON_E], b)
    keys = np.concatenate([np.array(key), [5, 6, 7, 8],
                           rng.integers(1000, BIG_V + 1000, 40)])
    k1, k2 = rng.choice(keys, b), rng.choice(keys, b)
    expect = np.where(rng.random(b) < 0.2, rng.integers(0, 6, b), -1)
    ops += [tuple(int(x) for x in r)
            for r in np.stack([opc, k1, k2, expect], 1)]
    batch = OpBatch(*(t.to(cuda_device) for t in
                      T.make_op_batch(ops, device="cpu")))
    mask = torch.ones(batch.lanes, dtype=torch.bool, device=cuda_device)
    # the first lanes take the free slots, in order
    sp = _SerialPass(GraphState(*(t.clone() for t in st)))
    assert sp.free_slot() == free[0] and sp.add_vertex(5) == T.R_TRUE
    assert sp.free_slot() == free[1]
    del sp
    before = sp_ops.launches
    got = _wrapper_pass(st, batch, mask)
    torch.cuda.synchronize()
    assert sp_ops.launches == before + 1
    want = _host_pass(st, batch, mask)
    _same(got, want, "V = 200,003")
    codes = got[1].tolist()
    assert codes[:7] == [T.R_TRUE, T.R_EDGE_ADDED, T.R_EDGE_ADDED,
                         T.R_EDGE_PRESENT, T.R_TRUE,
                         T.R_VERTEX_NOT_PRESENT, T.R_TRUE]
    del got, want
    # and the whole engine, its conflict mask and clean pass included
    _same(T.apply_ops_fast(st, batch), T.apply_ops(st, batch),
          "apply_ops_fast at V = 200,003")
