"""The port's mesh-sharded graph (repro_torch.core.partition) against the JAX
package's (repro.core.partition on its ambient 1-device mesh) and against
JAX's dense engines, bit for bit (tolerance 0: every output is an integer
or a bool), on meshes of CPU row blocks:

  * placement: ``shard_state`` / ``unshard`` round trip, the placement
    specs, a capacity the mesh does not divide (``ValueError``), types;
  * ``apply_ops_fast``: result codes and the six arrays after every batch
    (RemoveVertex, CAS lanes, conflicting lanes, slot reuse, a batch that
    overflows the table), on 8 blocks of 12 rows and on 61 blocks of one
    row (V = 61, every row its own shard);
  * ``multi_bfs`` for the six backend pairs (the port's "dense",
    "dense_cuda", "packed", "packed_cuda", "hybrid", "hybrid_cuda" against
    JAX "jnp", "pallas", "packed", "packed_pallas", "hybrid",
    "hybrid_pallas"; the Pallas kernels in interpret mode, the port's
    kernel wrappers on their plain versions), alpha/beta low enough that
    both directions run, edges at columns 31 and 63 (the int32 sign bit);
  * a BFS tree whose every parent lies in another shard (the push kernels'
    slice-relative parents against the pull's global ids);
  * the ``bfs.session.sharded`` span and the ``bfs.supersteps`` /
    ``bfs.exchange_bytes`` metrics, by JAX's formula;
  * ``get_paths_session`` / ``get_path_session`` with retries forced by a
    mutating fetch, ``grow`` rounding, ``compact``;
  * the epoch ring over sharded publishes (records and ``state_at`` equal
    a dense ring's; a write into a published block raises);
  * ``run_schedule(mesh=)`` with ``recover(mesh=)`` at every crash stage
    against JAX's harness on its mesh.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.testing.schedules as jsched
import repro_torch.core as T
import repro_torch.testing.schedules as tsched
from repro.core import partition as jpart
from repro.core.distributed import make_graph_mesh as jax_mesh
from repro.runtime.fault import FaultInjector as JFault
from repro_torch.convert import sharded_state_from_numpy, state_from_numpy
from repro_torch.core import partition as P
from repro_torch.core.distributed import GraphMesh, make_graph_mesh
from repro_torch.core.epochs import EpochRing
from repro_torch.obs import trace
from repro_torch.obs.metrics import global_registry
from repro_torch.parallel.sharding import graph_state_specs
from repro_torch.runtime.fault import FaultInjector as TFault
from torch_jax_isolation import clear_traced_only_jits


def teardown_module():
    # JAX ran under trace.capture() here: leave its traced-only jit
    # caches as a fresh worker has them (tests/torch_jax_isolation.py)
    clear_traced_only_jits()


KNOBS = dict(alpha=4, beta=8)          # low enough that pull supersteps run
STAGES = ["wal-append", "wal-fsync", "ckpt-mid-write", "post-publish-pre-ack"]
DELAYS = {"wal-append": 5, "wal-fsync": 4, "ckpt-mid-write": 1,
          "post-publish-pre-ack": 6}


def _mesh(s=8):
    return make_graph_mesh(["cpu"], shards=s)


def _apply(g, ops, lanes=128):
    for i in range(0, len(ops), lanes):
        g, _ = J.apply_ops_fast(g, J.make_op_batch(ops[i:i + lanes], lanes))
    return g


def _graph(v, nv, ne, seed):
    """A JAX state and its port twin: random edges, edges at columns 31
    and 63 (where they exist), a few removed vertices."""
    rng = np.random.default_rng(seed)
    ops = [(J.OP_ADD_V, k) for k in range(nv)]
    ops += [(J.OP_ADD_E, int(a), int(b))
            for a, b in rng.integers(0, nv, (ne, 2))]
    ops += [(J.OP_ADD_E, k, c) for c in (31, 63) if c < nv
            for k in range(0, nv, 7)]
    ops += [(J.OP_REM_V, k) for k in range(3, nv, 17)]
    g = _apply(J.make_graph(v), ops)
    return g, [np.asarray(x) for x in g]


def _fields_equal(t_state, j_state, what):
    got = (P.unshard(t_state) if isinstance(t_state, P.ShardedGraphState)
           else t_state)
    want = jpart.unshard(j_state) if hasattr(j_state, "mesh") else j_state
    for f in T.GraphState._fields:
        a = getattr(got, f).numpy()
        b = np.asarray(getattr(want, f))
        np.testing.assert_array_equal(a.view(b.dtype), b,
                                      err_msg=f"{what}: {f}")


def _result_equal(jres, tres, what):
    for f, a, b in zip(jres._fields, jres, tres):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=f"{what}: {f}")


@pytest.fixture(scope="module")
def bfs_graph():
    """V = 64 (interpret-mode Pallas stays small), 8 blocks of 8 rows."""
    g, arrays = _graph(64, 60, 150, seed=1)
    return g, jpart.shard_state(jax_mesh(), g), \
        sharded_state_from_numpy(_mesh(), *arrays)


# -- placement -----------------------------------------------------------------
def test_shard_state_roundtrip_and_placements():
    g, arrays = _graph(96, 90, 200, seed=0)
    t = state_from_numpy(*arrays, device="cpu")
    s = P.shard_state(_mesh(), t)
    assert s.num_shards == 8 and s.rows_per_shard == 12
    assert [b.shape for b in s.adj_packed] == [(12, 3)] * 8
    assert all(b.is_contiguous() for b in s.adj_in_packed)
    _fields_equal(s, g, "roundtrip")
    back = P.unshard(s)
    assert back.vkey.data_ptr() != s.vkey.data_ptr()
    specs = graph_state_specs()
    assert specs["adj_packed"].axis == "rows" and specs["vkey"].replicated
    assert s.meta_on(torch.device("cpu"))[0] is s.vkey
    with pytest.raises(ValueError, match="not divisible by mesh axis 8"):
        P.shard_state(_mesh(), T.make_graph(8 * 8 + 1, device="cpu"))
    with pytest.raises(TypeError):
        P.shard_state(object(), t)
    with pytest.raises(TypeError):
        P.apply_ops_fast(t, T.make_op_batch([(T.OP_ADD_V, 1)], device="cpu"))


def test_default_mesh_is_the_card_and_shards_round_robin():
    mesh = make_graph_mesh(["cpu"], shards=3)
    assert isinstance(mesh, GraphMesh) and mesh.shape == {"rows": 3}
    assert mesh.distinct_devices == (torch.device("cpu"),)
    if torch.cuda.is_available():
        m = make_graph_mesh()
        assert m.size == torch.cuda.device_count()
        assert all(d.type == "cuda" for d in m.devices)
        return
    with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
        make_graph_mesh()
    with pytest.raises(RuntimeError):
        make_graph_mesh(shards=8)


# -- mutation ------------------------------------------------------------------
def _batches(rng, nv, n, lanes):
    out = []
    for _ in range(n):
        ops = []
        for _ in range(lanes):
            op = int(rng.choice([1, 2, 3, 4, 5, 6, 4, 5, 9]))
            a, b = (int(x) for x in rng.integers(-1, nv + 4, 2))
            exp = int(rng.integers(0, 3)) if rng.random() < 0.2 else -1
            ops.append((op, a, b, exp))
        out.append(ops)
    return out


@pytest.mark.parametrize("v,nv,shards", [(96, 90, 8), (61, 58, 61)],
                         ids=["8x12", "61x1"])
def test_apply_ops_fast_matches_jax(v, nv, shards):
    g, arrays = _graph(v, nv, 150, seed=2)
    s = sharded_state_from_numpy(_mesh(shards), *arrays)
    rng = np.random.default_rng(3)
    batches = _batches(rng, nv, 4, 64)
    # slot reuse after removals, then a batch that overflows the table
    batches.append([(J.OP_ADD_V, 1000 + k, -1, -1) for k in range(v)])
    for i, ops in enumerate(batches):
        jb = J.make_op_batch(ops, len(ops))
        g, jres = J.apply_ops_fast(g, jb)
        s, tres = P.apply_ops_fast(
            s, T.make_op_batch(ops, len(ops), device="cpu"))
        np.testing.assert_array_equal(tres.numpy(), np.asarray(jres),
                                      err_msg=f"batch {i} codes")
        _fields_equal(s, g, f"batch {i}")
    assert int((np.asarray(jres) == J.R_TABLE_FULL).sum()) > 0
    assert bool(T.transpose_invariant(P.unshard(s)))


def test_apply_ops_fast_matches_jax_partition(bfs_graph):
    g, js, s = bfs_graph
    for i, ops in enumerate(_batches(np.random.default_rng(4), 60, 3, 32)):
        js, jres = jpart.apply_ops_fast(js, J.make_op_batch(ops, 32))
        s, tres = P.apply_ops_fast(s, T.make_op_batch(ops, 32, device="cpu"))
        np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
        _fields_equal(s, js, f"batch {i}")


# -- traversal -----------------------------------------------------------------
PAIRS = [("dense", "jnp"), ("dense_cuda", "pallas"), ("packed", "packed"),
         ("packed_cuda", "packed_pallas"), ("hybrid", "hybrid"),
         ("hybrid_cuda", "hybrid_pallas")]


@pytest.mark.parametrize("tb,jb", PAIRS, ids=[p[0] for p in PAIRS])
def test_multi_bfs_backends_match_jax(bfs_graph, tb, jb):
    g, js, s = bfs_graph
    rng = np.random.default_rng(5)
    src = rng.integers(-1, 64, 8).astype(np.int32)
    dst = rng.integers(-1, 64, 8).astype(np.int32)
    src[:4] = [0, 31, 63, 3]
    want = jpart.multi_bfs(js, jnp.asarray(src), jnp.asarray(dst),
                           backend=jb, **KNOBS)
    got = P.multi_bfs(s, src, dst, backend=tb, **KNOBS)
    _result_equal(want, got, tb)
    dense = J.multi_bfs(g, jnp.asarray(src), jnp.asarray(dst),
                        backend="hybrid", **KNOBS)
    _result_equal(dense, got, f"{tb} vs dense")


@pytest.mark.parametrize("backend", ["hybrid_cuda", "packed_cuda",
                                     "dense_cuda", "hybrid"])
def test_parents_that_cross_shards_are_global(backend):
    """A chain 0 -> 9 -> 18 -> ... -> 63 over 8 blocks of 8 rows: every
    parent is in the previous block, so a slice-relative parent (B1/B6
    without the shard's first row) or a pull parent shifted by it gives a
    wrong tree. alpha = 1 pulls from the first superstep on, alpha = 64
    never does."""
    chain = list(range(0, 64, 9))
    ops = [(J.OP_ADD_V, k) for k in range(64)]
    ops += [(J.OP_ADD_E, a, b) for a, b in zip(chain, chain[1:])]
    g = _apply(J.make_graph(64), ops)
    s = sharded_state_from_numpy(_mesh(), *[np.asarray(x) for x in g])
    for alpha in (1, 64):
        want = J.multi_bfs(g, jnp.asarray([0]), jnp.asarray([-1]),
                           backend="hybrid", alpha=alpha, beta=2)
        got = P.multi_bfs(s, [0], [-1], backend=backend, alpha=alpha,
                          beta=2)
        _result_equal(want, got, f"{backend} alpha={alpha}")
        assert [int(got.parent[0, b]) for b in chain[1:]] == chain[:-1]


def test_sharded_session_span_and_metrics(bfs_graph):
    g, js, s = bfs_graph
    src, dst = [0, 31, 5], [63, -1, 9]
    reg = global_registry()
    before = reg.snapshot()
    with trace.capture() as rec:
        res = P.multi_bfs(s, src, dst, backend="hybrid_cuda", **KNOBS)
    after = reg.snapshot()
    events = [e for e in rec.events() if e["name"] not in trace.PORT_SPANS]
    names = [e["name"] for e in events]
    assert names == ["bfs.session.sharded"]          # no superstep spans
    args = events[0]["args"]
    steps = int(res.supersteps)
    assert args["supersteps"] == steps > 0
    assert args["exchange_bytes"] == steps * 3 * 2 * 4 * 8
    assert (args["queries"], args["capacity"], args["shards"],
            args["backend"]) == (3, 64, 8, "hybrid_cuda")
    assert after["bfs.supersteps"] - before["bfs.supersteps"] == steps
    assert (after["bfs.exchange_bytes"] - before["bfs.exchange_bytes"]
            == args["exchange_bytes"])
    assert after["bfs.pull_supersteps"] == before["bfs.pull_supersteps"]
    from repro.obs import trace as jtrace
    with jtrace.capture() as jrec:
        jres = jpart.multi_bfs(js, jnp.asarray(src), jnp.asarray(dst),
                               backend="hybrid_pallas", **KNOBS)
    jargs = [e for e in jrec.events()
             if e["name"] == "bfs.session.sharded"][0]["args"]
    assert jargs["supersteps"] == steps == int(jres.supersteps)
    assert args["exchange_bytes"] == 8 * jargs["exchange_bytes"]


# -- sessions, grow, compact ---------------------------------------------------
def _mutating_fetch(apply, make, state, batches):
    """fetch_state committing one batch on each of the first fetches."""
    box = {"s": state, "left": list(batches)}

    def fetch():
        if box["left"]:
            box["s"], _ = apply(box["s"], make(box["left"].pop(0)))
        return box["s"]
    return fetch


def test_sessions_with_retries_match_jax(bfs_graph):
    g, js, s = bfs_graph
    muts = [[(J.OP_ADD_E, 0, 40)], [(J.OP_REM_E, 0, 40)],
            [(J.OP_ADD_E, 5, 31)]]
    pairs = [(0, 40), (0, 63), (31, 2), (5, 31), (7, 7), (99, 1)]
    jf = _mutating_fetch(jpart.apply_ops_fast,
                         lambda o: J.make_op_batch(o), js, muts)
    tf = _mutating_fetch(P.apply_ops_fast,
                         lambda o: T.make_op_batch(o, device="cpu"), s, muts)
    want = J.get_paths_session(jf, pairs, backend="hybrid")
    got = T.get_paths_session(tf, pairs, backend="hybrid_cuda")
    assert got == want and got[1] > 2
    jf = _mutating_fetch(jpart.apply_ops_fast,
                         lambda o: J.make_op_batch(o), js, muts)
    tf = _mutating_fetch(P.apply_ops_fast,
                         lambda o: T.make_op_batch(o, device="cpu"), s, muts)
    jp = J.get_path_session(jf, 0, 63)
    tp = T.get_path_session(tf, 0, 63, backend="hybrid_cuda")
    _result_equal(jp, tp, "get_path_session")
    assert int(tp.rounds) > 2


def test_grow_rounds_to_the_mesh_and_compact_matches_jax(bfs_graph):
    g, js, s = bfs_graph
    gg = P.grow(s, 100)                    # rounds up to 104 = 8 x 13
    assert gg.capacity == 104 and gg.rows_per_shard == 13
    _fields_equal(gg, J.grow(g, 104), "grow")
    assert P.grow(s, 60) is s
    _fields_equal(P.compact(s), jpart.compact(js), "compact")
    _fields_equal(P.compact(s), J.compact(g), "compact vs dense")


# -- the epoch ring over sharded publishes -------------------------------------
def test_ring_over_sharded_publishes(bfs_graph):
    g, _, s = bfs_graph
    rs, rd = EpochRing(4), EpochRing(4)
    rs.reset(0, s)
    rd.reset(0, P.unshard(s))
    states = [s]
    for e, ops in enumerate(_batches(np.random.default_rng(6), 60, 5, 16)):
        s, _ = P.apply_ops_fast(s, T.make_op_batch(ops, 16, device="cpu"))
        states.append(s)
        rs.push(e + 1, s)
        rd.push(e + 1, P.unshard(s))
    for a, b in zip(rs.dump()[0], rd.dump()[0]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    lo, hi = rs.window()
    for e in range(lo, hi + 1):
        got = rs.state_at(e)
        assert isinstance(got, T.GraphState)
        for f, a, b in zip(got._fields, got, P.unshard(states[e])):
            assert torch.equal(a, b), (e, f)
    s.adj_packed[3][0, 0] ^= 1                  # a write into a block
    with pytest.raises(RuntimeError, match="written in place"):
        rs.state_at(hi)


# -- the schedule harness and recovery on a mesh -------------------------------
@pytest.mark.parametrize("stage", STAGES)
def test_recover_on_a_mesh_at_every_crash_stage(tmp_path, stage):
    def schedule(M):
        rng = random.Random(7)
        progs = M.gen_client_programs(rng, clients=3, batches_per_client=4,
                                      max_lanes=3, conflict_rate=0.5)
        return M.random_schedule(random.Random(8), progs)

    def plan():   # a fault injector consumes its plan
        return dict(plan=[("*", stage)],
                    delays={("*", stage): DELAYS[stage]})

    kw = dict(capacity=8, ckpt_every=2)
    jtr = jsched.run_schedule(schedule(jsched), mesh=jax_mesh(),
                              fault=JFault(**plan()),
                              durable_dir=str(tmp_path / "j"), **kw)
    ttr = tsched.run_schedule(schedule(tsched), mesh=_mesh(),
                              fault=TFault(**plan()),
                              durable_dir=str(tmp_path / "t"), **kw)
    assert ttr.crash is not None and ttr.crash.stage == stage
    assert ttr.pool.linearization == jtr.pool.linearization
    trec = tsched.check_recovery_equivalent(ttr)
    jrec = jsched.check_recovery_equivalent(jtr)
    assert isinstance(trec.state, P.ShardedGraphState)
    assert (trec.epoch, trec.linearization, trec.epoch_log) == \
        (jrec.epoch, jrec.linearization, jrec.epoch_log)
    _fields_equal(trec.state, jrec.state, f"recovered at {stage}")
