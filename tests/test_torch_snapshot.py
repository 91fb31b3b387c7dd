"""The port's double-collect GetPath (repro_torch.core.snapshot) against the
JAX package's: ``examples/quickstart.py`` replayed line for line on both
(the same printed values, the §3.5 adversary caught, the same session round
counts), Collects field by field, ``collect_batch`` (fused and vmap),
``get_paths_session`` / ``get_path_session`` in both ``on_conflict`` modes
(and on the port's "dense_cuda" against JAX "pallas"), and
``interleaved_getpath`` (tolerance 0 throughout)."""
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from repro_torch.convert import op_batch_from_numpy, state_from_numpy
from repro_torch.obs import trace


def _collects_equal(jc, tc, what):
    for f, a, b in zip(jc._fields, jc, tc):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=f"{what}: {f}")


def _path(pr):
    return [int(x) for x in np.asarray(pr.keys)[:int(pr.length)]]


def _replay(M, **dev):
    """examples/quickstart.py on module ``M`` (the JAX or the port core);
    returns every value the example prints, plus the collects."""
    out = {}
    g = M.make_graph(64, **dev)
    ops = [(M.OP_ADD_V, k) for k in range(8)]
    ops += [(M.OP_ADD_E, a, b) for a, b in
            [(0, 1), (1, 2), (2, 3), (3, 7), (0, 5), (5, 6), (6, 7)]]
    ops += [(M.OP_CON_E, 0, 1), (M.OP_ADD_E, 0, 1)]
    g, results = M.apply_ops_fast(g, M.make_op_batch(ops, **dev))
    out["batch"] = [M.RESULT_NAMES[int(r)] for r in results[-2:]]
    out["contains"] = bool(M.contains_vertex(g, 3))
    out["path"] = _path(M.get_path(g, 0, 7))
    g, _ = M.remove_edge(g, 3, 7)
    g, _ = M.remove_edge(g, 6, 7)
    c1 = M.collect(g, 0, 7)
    g2, _ = M.add_edge(g, 3, 7)
    g3, _ = M.remove_edge(g2, 3, 7)
    c2 = M.collect(g3, 0, 7)
    out["adversary"] = (bool((np.asarray(g.adj) == np.asarray(g3.adj)).all()),
                        bool(c1.found), bool(c2.found),
                        bool(M.compare_collects(c1, c2)))
    g3, _ = M.add_edge(g3, 6, 7)
    state = {"g": g3}
    calls = {"n": 0}

    def fetch():
        if 0 < calls["n"] <= 2:
            op = M.OP_REM_E if calls["n"] == 1 else M.OP_ADD_E
            state["g"], _ = M.apply_ops_fast(
                state["g"], M.make_op_batch([(op, 5, 6)], **dev))
        calls["n"] += 1
        return state["g"]

    pr = M.get_path_session(fetch, 0, 7)
    out["session"] = (int(pr.rounds), _path(pr))
    out["batched"] = M.get_paths_session(lambda: state["g"],
                                         [(0, 7), (1, 3), (6, 0)])
    return out, (c1, c2), state["g"]


def test_quickstart_replays_line_for_line():
    want, (jc1, jc2), _ = _replay(J)
    got, (tc1, tc2), _ = _replay(T, device="cpu")
    assert got == want
    assert want["adversary"] == (True, False, False, False)   # §3.5 caught
    assert want["session"][0] > 2                              # it retried
    _collects_equal(jc1, tc1, "c1")
    _collects_equal(jc2, tc2, "c2")


def _graph(seed=4, v=96, nv=90, ne=260):
    rng = np.random.default_rng(seed)
    ops = [(J.OP_ADD_V, k) for k in range(nv)]
    ops += [(J.OP_ADD_E, int(a), int(b))
            for a, b in rng.integers(0, nv, (ne, 2))]
    g = J.make_graph(v)
    for i in range(0, len(ops), 128):
        g, _ = J.apply_ops_fast(g, J.make_op_batch(ops[i:i + 128], 128))
    return g, state_from_numpy(*[np.asarray(x) for x in g], device="cpu")


PAIRS = [(0, 7), (3, 50), (89, 1), (5, 5), (12, 200), (40, 41)]


@pytest.mark.parametrize("engine", ["fused", "vmap"])
def test_collect_batch_matches_jax(engine):
    g, t = _graph()
    ks = [p[0] for p in PAIRS]
    ls = [p[1] for p in PAIRS]
    want = J.collect_batch(g, jnp.asarray(ks), jnp.asarray(ls),
                           engine=engine)
    got = T.collect_batch(t, ks, ls, engine=engine)
    _collects_equal(want, got, engine)
    assert bool(T.compare_collect_batches(got, T.collect_batch(t, ks, ls)))
    # on a mesh-sharded state (8 CPU row blocks of 12 rows) the Collect
    # equals JAX's on its sharded state; a bare tuple raises TypeError
    from repro.core import partition as jpart
    from repro.core.distributed import make_graph_mesh as jax_mesh
    from repro_torch.core.distributed import make_graph_mesh

    js = jpart.shard_state(jax_mesh(), g)
    ts = T.shard_state(make_graph_mesh(["cpu"], shards=8), t)
    want = J.collect_batch(js, jnp.asarray(ks), jnp.asarray(ls),
                           engine=engine)
    _collects_equal(want, T.collect_batch(ts, ks, ls, engine=engine),
                    f"sharded {engine}")
    with pytest.raises(TypeError) as err:
        T.collect_batch(tuple(t), ks, ls)
    assert "A10" not in str(err.value)


def _mutating_fetch(M, g, batches, **dev):
    """fetch_state that commits one batch on each of the first fetches."""
    state = {"g": g, "left": list(batches)}

    def fetch():
        if state["left"]:
            state["g"], _ = M.apply_ops_fast(
                state["g"], M.make_op_batch(state["left"].pop(0), **dev))
        return state["g"]
    return fetch


BATCHES = [[(J.OP_ADD_E, 0, 60)], [(J.OP_REM_E, 0, 60)], [(J.OP_ADD_E, 3, 9)],
           [(J.OP_REM_V, 9)]]


@pytest.mark.parametrize("max_rounds,on_conflict", [(16, "retry"),
                                                    (3, "retry"),
                                                    (3, "epoch")])
def test_sessions_match_jax(max_rounds, on_conflict):
    g, t = _graph()
    kw = dict(max_rounds=max_rounds, on_conflict=on_conflict)
    js, ts = {}, {}
    want = J.get_paths_session(_mutating_fetch(J, g, BATCHES), PAIRS,
                               stats=js, **kw)
    with trace.capture() as rec:
        got = T.get_paths_session(_mutating_fetch(T, t, BATCHES, device="cpu"),
                                  PAIRS, stats=ts, **kw)
    assert got == want
    assert ts == js
    names = {e["name"] for e in rec.events()}
    assert {"session.get_paths", "collect.round", "bfs.session",
            "bfs.superstep"} <= names
    for k, l in PAIRS[:3]:
        jp = J.get_path_session(_mutating_fetch(J, g, BATCHES), k, l, **kw)
        tp = T.get_path_session(_mutating_fetch(T, t, BATCHES, device="cpu"),
                                k, l, **kw)
        for f, a, b in zip(jp._fields, jp, tp):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f"{k}->{l}: {f}")


def test_sessions_on_dense_cuda_match_jax_pallas():
    """The dense engine under the double collect: the port's "dense_cuda"
    (B6/B7 plain versions on the CPU) against JAX "pallas" (interpret mode,
    so capacity 48), with mutations between the collects."""
    g, t = _graph(seed=5, v=48, nv=44, ne=110)
    pairs = [(0, 7), (3, 40), (43, 1), (5, 5), (12, 99), (31, 2)]
    batches = [[(J.OP_ADD_E, 0, 40)], [(J.OP_REM_E, 0, 40)],
               [(J.OP_REM_V, 9)]]
    js, ts = {}, {}
    want = J.get_paths_session(_mutating_fetch(J, g, batches), pairs,
                               backend="pallas", stats=js)
    got = T.get_paths_session(_mutating_fetch(T, t, batches, device="cpu"),
                              pairs, backend="dense_cuda", stats=ts)
    assert got == want and ts == js
    assert got == T.get_paths_session(
        _mutating_fetch(T, t, batches, device="cpu"), pairs)
    jp = J.get_path_session(_mutating_fetch(J, g, batches), 3, 40,
                            backend="pallas")
    tp = T.get_path_session(_mutating_fetch(T, t, batches, device="cpu"), 3,
                            40, backend="dense_cuda")
    for f, a, b in zip(jp._fields, jp, tp):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)


def test_epoch_resolution_uses_the_pinned_state():
    g, t = _graph()
    pinned_j = J.apply_ops_fast(g, J.make_op_batch([(J.OP_REM_V, 7)]))[0]
    pinned_t = T.apply_ops_fast(t, T.make_op_batch([(T.OP_REM_V, 7)],
                                                   device="cpu"))[0]
    many = BATCHES * 4
    want = J.get_paths_session(_mutating_fetch(J, g, many), PAIRS,
                               max_rounds=2, on_conflict="epoch",
                               fetch_epoch=lambda: (5, pinned_j))
    got = T.get_paths_session(_mutating_fetch(T, t, many, device="cpu"),
                              PAIRS, max_rounds=2, on_conflict="epoch",
                              fetch_epoch=lambda: (5, pinned_t))
    assert got == want
    jp = J.get_path_session(_mutating_fetch(J, g, many), 0, 7, max_rounds=2,
                            on_conflict="epoch",
                            fetch_epoch=lambda: (5, pinned_j))
    tp = T.get_path_session(_mutating_fetch(T, t, many, device="cpu"), 0, 7,
                            max_rounds=2, on_conflict="epoch",
                            fetch_epoch=lambda: (5, pinned_t))
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("pair,mutate", [((0, 7), True), ((0, 7), False),
                                         ((3, 50), True)])
def test_interleaved_getpath_matches_jax(pair, mutate):
    g, t = _graph()
    rng = np.random.default_rng(1)
    tt, b = 4, 16
    if mutate:
        cols = [rng.integers(3, 7, (tt, b)), rng.integers(0, 90, (tt, b)),
                rng.integers(0, 90, (tt, b)), np.full((tt, b), -1)]
    else:
        cols = [np.full((tt, b), J.OP_CON_V), rng.integers(0, 90, (tt, b)),
                np.full((tt, b), -1), np.full((tt, b), -1)]
    cols = [np.asarray(c, np.int32) for c in cols]
    jst, jpr, jres = J.interleaved_getpath(
        g, J.OpBatch(*(jnp.asarray(c) for c in cols)), *pair)
    tst, tpr, tres = T.interleaved_getpath(
        t, op_batch_from_numpy(*cols, device="cpu"), *pair)
    np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
    for f, a, b in zip(jpr._fields, jpr, tpr):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)
    for a, b in zip(jst, tst):
        np.testing.assert_array_equal(b.numpy().view(np.asarray(a).dtype),
                                      np.asarray(a))
