"""The port's reachability index (repro_torch.index) against the JAX
package's (repro.index), bit for bit (tolerance 0: every output is an
integer or a bool), on the CPU:

  * ``pick_landmarks`` order (isolated vertices first, as JAX's), and
    every ``ReachIndex`` array of ``build_index`` for complete, partial
    (0/1/3 landmarks) and pinned landmark lists, with and without isolated
    vertices, and on "dense_cuda" against JAX "pallas";
  * ``query_reach`` / ``reach_sets`` / ``reach_counts`` on one index fed to
    both packages through ``convert.index_from_numpy``, JAX on "jnp" and
    "pallas" (interpret mode), the port on every join backend (the
    "cuda" backends run their kernels' plain versions on a CPU index),
    and ``query_reach`` through B4 by slot on absent and dead endpoints,
    sign-bit hubs, Q = 0 and Q = 1;
  * ``affected_landmarks`` and ``refresh`` (mode, rebuilt, every array),
    and incremental refresh == full rebuild over the same landmarks;
  * ``reach_session`` and ``reach_counts_session`` across a mutation and a
    refresh;
  * closure-mode ``multi_bfs`` on "hybrid_cuda" (routed through the B1/B2
    wrappers, plain branches on the CPU), "hybrid", and "dense_cuda"
    (through the B6 wrapper, without parents) against JAX.

Capacity 70 (not a multiple of 32) with 66 keys, so a complete index has
landmark columns 31 and 63 (the int32 sign bit of a label word), and
edges touch slots 31 and 63.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as J
import repro.index as JI
from repro.index.labels import pick_landmarks as jax_pick_landmarks
import repro_torch.core as T
import repro_torch.index as TI
from repro_torch.convert import index_from_numpy, state_from_numpy
from repro_torch.index.labels import live_degrees
from repro_torch.index.query import JOIN_BACKENDS
from repro_torch.kernels.label_join.ops import label_join_slots
from repro_torch.kernels.label_join.ref import (endpoint_ok,
                                                label_join_packed_ref,
                                                label_join_slots_ref,
                                                slot_rows)
from repro_torch.obs import trace
from repro_torch.obs.metrics import global_registry

CAP, NV = 70, 66
ARRAYS = ("landmarks", "out_label", "in_label", "fwd", "bwd", "alive",
          "versions", "complete")


def _ops(rng, loops=True):
    ops = [(J.OP_ADD_V, k) for k in range(NV)]
    ops += [(J.OP_ADD_E, int(a), int(b))
            for a, b in rng.integers(0, NV, (80, 2))]
    ops += [(J.OP_ADD_E, 31, 63), (J.OP_ADD_E, 63, 5), (J.OP_ADD_E, 2, 31)]
    if loops:   # self-loops: every vertex has an edge
        ops += [(J.OP_ADD_E, k, k) for k in range(NV)]
    return ops


def _apply(g, ops):
    for i in range(0, len(ops), 256):
        g, _ = J.apply_ops_fast(g, J.make_op_batch(ops[i:i + 256], 256))
    return g


def _port(g):
    return state_from_numpy(*[np.asarray(x) for x in g], device="cpu")


def _graph(seed=0, loops=True):
    rng = np.random.default_rng(seed)
    g = _apply(J.make_graph(CAP), _ops(rng, loops))
    g = _apply(g, [(J.OP_REM_V, 40)])
    return g, _port(g)


@pytest.fixture(scope="module")
def graph():
    return _graph()


def _index_equal(ji, ti, what, fields=None):
    for f in fields or ji._fields:
        a, b = getattr(ji, f), getattr(ti, f)
        if isinstance(b, torch.Tensor):
            a = np.asarray(a)
            b = b.numpy()
            if a.dtype == np.uint32:
                b = b.view(np.uint32)
            assert a.shape == b.shape, f"{what}: {f} shape"
            np.testing.assert_array_equal(b, a, err_msg=f"{what}: {f}")
        else:
            assert a == b, f"{what}: {f} {a} != {b}"


def _to_port(ji):
    return index_from_numpy(*(np.asarray(getattr(ji, f)) for f in ARRAYS[:-1]),
                            ji.complete, ji.requested, device="cpu")


def _slot_pairs(v=CAP):
    """Every (src, dst) over a spread of slots, absent (-1) and dead (40)
    included."""
    s = np.array([-1, 0, 2, 5, 31, 40, 63, 65, 66, v - 1], np.int32)
    a, b = np.meshgrid(s, s, indexing="ij")
    return a.reshape(-1), b.reshape(-1)


@pytest.mark.parametrize("num", [None, 0, 1, 3, 50])
def test_pick_landmarks_matches_jax(graph, num):
    g, t = graph
    np.testing.assert_array_equal(TI.pick_landmarks(t, num),
                                  jax_pick_landmarks(g, num))


def test_pick_landmarks_puts_isolated_vertices_last_where_jax_puts_first():
    """On a graph with isolated alive vertices the port picks exactly JAX's
    order: JAX negates an unsigned degree, which wraps, so the isolated
    vertices come first (slot ascending), then degree descending, ties by
    slot (ROADMAP.md queue C: a fault of the reference, matched)."""
    g, t = _graph(seed=1, loops=False)
    alive = np.asarray(g.valive)
    adj = np.asarray(g.adj).astype(np.int64) * (alive[:, None]
                                                & alive[None, :])
    deg = adj.sum(0) + adj.sum(1)
    isolated = np.flatnonzero(alive & (deg == 0))
    assert isolated.size > 0
    np.testing.assert_array_equal(live_degrees(t).numpy(), deg)
    for num in (None, 1, isolated.size + 3):
        want = jax_pick_landmarks(g, num)
        np.testing.assert_array_equal(TI.pick_landmarks(t, num), want)
    order = TI.pick_landmarks(t, None)
    k = isolated.size
    np.testing.assert_array_equal(order[:k], isolated)
    assert np.all(np.diff(deg[order[k:]]) <= 0)


@pytest.mark.parametrize("loops", [True, False])
@pytest.mark.parametrize("num", [None, 0, 1, 3])
def test_build_index_matches_jax(graph, num, loops):
    g, t = graph if loops else _graph(seed=1, loops=False)
    _index_equal(JI.build_index(g, num), TI.build_index(t, num),
                 f"num_landmarks={num}")


@pytest.mark.parametrize("num", [None, 3])
def test_build_index_dense_cuda_matches_jax_pallas(num):
    """The dense engine's closures (B6 plain version on the CPU) against
    JAX "pallas", on a graph with isolated vertices."""
    g, t = _graph(seed=1, loops=False)
    _index_equal(JI.build_index(g, num, backend="pallas"),
                 TI.build_index(t, num, backend="dense_cuda"),
                 f"dense_cuda num_landmarks={num}")


def test_build_index_pinned_slots_matches_jax():
    g, t = _graph(seed=1, loops=False)
    slots = jax_pick_landmarks(g, None)       # JAX's order, isolated first
    _index_equal(JI.build_index(g, landmark_slots=slots),
                 TI.build_index(t, landmark_slots=slots), "pinned")
    _index_equal(JI.build_index(g, landmark_slots=slots[5:9]),
                 TI.build_index(t, landmark_slots=torch.from_numpy(
                     slots[5:9])), "pinned tensor")


@pytest.mark.parametrize("num", [None, 3])
def test_build_index_kernel_backend_matches_jax(graph, num):
    """The closures on "hybrid_cuda" (B1/B2 without parents, plain
    versions on the CPU) against JAX's build."""
    g, t = graph
    _index_equal(JI.build_index(g, num),
                 TI.build_index(t, num, backend="hybrid_cuda"),
                 f"hybrid_cuda num_landmarks={num}")


def test_build_index_on_kernel_backend_matches_plain(graph):
    _, t = graph
    a = TI.build_index(t, backend="hybrid_cuda")
    b = TI.build_index(t, backend="hybrid")
    for f, x, y in zip(a._fields, a, b):
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y), f


@pytest.mark.parametrize("jax_backend", ["jnp", "pallas"])
@pytest.mark.parametrize("num", [None, 3])
def test_query_reach_sets_counts_match_jax(graph, jax_backend, num):
    g, _ = graph
    ji = JI.build_index(g, num)
    ti = _to_port(ji)
    _index_equal(ji, ti, "index_from_numpy")
    src, dst = _slot_pairs()
    want = JI.query_reach(ji, jnp.asarray(src), jnp.asarray(dst),
                          backend=jax_backend)
    for be in JOIN_BACKENDS + (None,):
        got = TI.query_reach(ti, src, dst, backend=be)
        for name, a, b in zip(("reach", "decided", "hub"), want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f"{be} {name}")
    s = np.array([-1, 0, 5, 31, 40, 63, 65], np.int32)
    for a, b in zip(JI.reach_sets(ji, jnp.asarray(s)), TI.reach_sets(ti, s)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(JI.reach_counts(ji, jnp.asarray(s)),
                    TI.reach_counts(ti, s)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# (src, dst) slot pairs of the query cases that B4 by slot handles in the
# kernel: absent slots, dead endpoints (40 is removed), pairs whose hub is
# landmark column 31 or 63 of the complete index (the int32 sign bit of a
# label word), Q = 0 and Q = 1
SLOT_CASES = {
    "absent": ([-1, -1, 5, 0], [5, -1, -1, 2]),
    "dead src": ([40, 40, 40], [5, 40, 63]),
    "dead dst": ([5, 63, 2], [40, 40, 40]),
    "sign-bit hub": ([15, 46, 43, 15], [15, 15, 43, 43]),
    "Q=0": ([], []),
    "Q=1": ([2], [63]),
}


@pytest.mark.parametrize("case", list(SLOT_CASES))
@pytest.mark.parametrize("num", [None, 3])
def test_query_reach_by_slot_matches_jax(graph, case, num):
    """query_reach through B4 by slot (its plain version, what a CPU index
    runs for every backend) against the JAX package's gathered join; the
    slot entry's outputs against the gathered rows it stands for."""
    g, _ = graph
    ji = JI.build_index(g, num)
    ti = _to_port(ji)
    src, dst = (np.asarray(x, np.int32) for x in SLOT_CASES[case])
    want = JI.query_reach(ji, jnp.asarray(src), jnp.asarray(dst))
    if case == "sign-bit hub" and num is None:
        assert {31, 63} <= set(np.asarray(want[2]).tolist())
    for be in JOIN_BACKENDS:
        got = TI.query_reach(ti, src, dst, backend=be)
        for name, a, b in zip(("reach", "decided", "hub"), want, got):
            assert b.shape == (src.size,), f"{be} {name}"
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f"{be} {name}")
    ts, td = torch.from_numpy(src), torch.from_numpy(dst)
    args = (ti.out_label, ti.in_label, ti.alive, ts, td)
    hits, hub, sok, dok = label_join_slots_ref(*args)
    for x, y in zip(label_join_slots(*args), (hits, hub, sok, dok)):
        assert torch.equal(x, y)
    assert torch.equal(sok, torch.from_numpy(
        (src >= 0) & np.asarray(ji.alive)[np.clip(src, 0, CAP - 1)]))
    assert torch.equal(dok, endpoint_ok(ti.alive, td))
    for x, y in zip((hits, hub), label_join_packed_ref(
            slot_rows(ti.out_label, ts, sok),
            slot_rows(ti.in_label, td, dok))):
        assert torch.equal(x, y)


def test_query_reach_rejects_unknown_join_backend(graph):
    ti = TI.build_index(graph[1], 3)
    with pytest.raises(ValueError, match="label_join backend"):
        TI.query_reach(ti, [0], [1], backend="pallas")


# mutation batches: a small one (few affected rows), one that adds a key,
# and a mixed one; none leaves an alive vertex without an edge
SMALL = [(J.OP_ADD_E, 64, 65), (J.OP_REM_E, 31, 63)]
NEW_KEY = [(J.OP_ADD_V, 99), (J.OP_ADD_E, 3, 99)]
MIXED = [(J.OP_REM_V, 7), (J.OP_ADD_E, 10, 20), (J.OP_ADD_E, 20, 31),
         (J.OP_REM_E, 2, 31), (J.OP_ADD_V, 40), (J.OP_ADD_E, 40, 40)]


@pytest.mark.parametrize("num,batch,threshold", [
    (None, SMALL, 0.5), (None, NEW_KEY, 0.5), (3, SMALL, 0.5),
    (3, MIXED, 1.1), (3, MIXED, 0.05), (None, [], 0.5)])
def test_affected_and_refresh_match_jax(graph, num, batch, threshold):
    g, t = graph
    ji = JI.build_index(g, num)
    ti = TI.build_index(t, num)
    g2 = _apply(g, batch) if batch else g
    t2 = _port(g2)
    for a, b in zip(JI.affected_landmarks(ji, g2),
                    TI.affected_landmarks(ti, t2)):
        np.testing.assert_array_equal(b, np.asarray(a))
    jr, jinfo = JI.refresh(ji, g2, full_threshold=threshold)
    tr, tinfo = TI.refresh(ti, t2, full_threshold=threshold)
    assert tinfo == jinfo
    _index_equal(jr, tr, f"refresh {jinfo}")
    assert TI.index_fresh(tr, t2) and (not batch or not TI.index_fresh(ti,
                                                                       t2))
    if tinfo["mode"] == "incremental":
        _index_equal(jr, TI.build_index(t2, landmark_slots=tr.landmarks),
                     "incremental == full rebuild", fields=ARRAYS)


def test_refresh_after_grow_rebuilds_like_jax(graph):
    g, t = graph
    ji, ti = JI.build_index(g, 3), TI.build_index(t, 3)
    g2 = J.grow(g, CAP + 10)
    jr, jinfo = JI.refresh(ji, g2)
    tr, tinfo = TI.refresh(ti, T.grow(t, CAP + 10))
    assert tinfo == jinfo == {"mode": "full", "rebuilt": 3}
    _index_equal(jr, tr, "grow")


def _session_equal(jres, tres, what):
    for f in ("found", "from_index", "fellback", "stale", "rounds",
              "pinned_epoch", "starved"):
        assert getattr(tres, f) == getattr(jres, f), f"{what}: {f}"


@pytest.mark.parametrize("num", [None, 3])
def test_reach_session_across_mutation_and_refresh(graph, num):
    g, t = graph
    ji, ti = JI.build_index(g, num), TI.build_index(t, num)
    keys = [0, 2, 5, 31, 40, 63, 65, 99]
    pairs = [(a, b) for a in keys for b in keys]
    _session_equal(JI.reach_session(lambda: g, ji, pairs),
                   TI.reach_session(lambda: t, ti, pairs), "fresh")
    g2 = _apply(g, MIXED)
    t2 = _port(g2)
    jres = JI.reach_session(lambda: g2, ji, pairs)
    tres = TI.reach_session(lambda: t2, ti, pairs)
    _session_equal(jres, tres, "stale")
    assert tres.stale and tres.fellback == len(pairs)
    jr, _ = JI.refresh(ji, g2)
    tr, _ = TI.refresh(ti, t2)
    jres = JI.reach_session(lambda: g2, jr, pairs)
    tres = TI.reach_session(lambda: t2, tr, pairs)
    _session_equal(jres, tres, "refreshed")
    assert not tres.stale and tres.from_index > 0
    assert [f for f, _ in tres.paths()] == tres.found
    assert TI.reach_session(lambda: t2, tr, []).found == []


def test_reach_counts_session_matches_jax(graph):
    g, t = graph
    ji, ti = JI.build_index(g), TI.build_index(t)
    keys = [0, 5, 31, 40, 63, 99]
    for gg, tt in ((g, t), (_apply(g, SMALL), None)):
        tt = tt if tt is not None else _port(gg)
        jc, jserved = JI.reach_counts_session(lambda: gg, ji, keys)
        tc, tserved = TI.reach_counts_session(lambda: tt, ti, keys)
        assert tserved == jserved
        np.testing.assert_array_equal(tc, np.asarray(jc))
    assert TI.reach_counts_session(lambda: t, ti, keys)[1]


def test_closure_mode_routes_through_the_kernel_wrappers(graph, monkeypatch):
    """multi_bfs(parents=False) on "hybrid_cuda" calls the B1/B2 wrappers
    (plain branches on the CPU) with ``parents=False``, and equals JAX's
    closure mode and the plain "hybrid" closure on every field, forward and
    reversed."""
    from repro_torch.index.labels import _reversed
    from repro.index.labels import _reversed as jax_reversed
    import repro_torch.kernels.bfs_multi_step.ops as b1
    import repro_torch.kernels.bfs_pull_step.ops as b2

    calls = {"push": 0, "pull": 0}
    flags = set()

    def spy(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            flags.add(kw.get("parents", True))
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(b1, "multi_bfs_step_packed",
                        spy("push", b1.multi_bfs_step_packed))
    monkeypatch.setattr(b2, "multi_bfs_pull_step",
                        spy("pull", b2.multi_bfs_pull_step))
    g, t = graph
    src = np.array([0, 2, 31, 40, 63, -1, 65, 5], np.int32)
    dst = np.array([-1, -1, 5, -1, 0, 3, -1, 5], np.int32)
    for jg, tg in ((g, t), (jax_reversed(g), _reversed(t))):
        want = J.multi_bfs(jg, jnp.asarray(src), jnp.asarray(dst),
                           backend="hybrid", parents=False)
        for be in ("hybrid_cuda", "hybrid", "packed_cuda"):
            got = T.multi_bfs(tg, src, dst, backend=be, parents=False)
            for f, a, b in zip(want._fields, want, got):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                              err_msg=f"{be} {f}")
    assert calls["push"] > 0 and calls["pull"] > 0
    assert flags == {False}


def test_dense_closure_runs_b6_without_parents(graph, monkeypatch):
    """multi_bfs(parents=False) on "dense_cuda" calls the B6 wrapper (its
    plain branch on the CPU) with ``parents=False`` on every superstep,
    and equals JAX's closure mode on "pallas" on every field, forward and
    reversed."""
    from repro_torch.index.labels import _reversed
    from repro.index.labels import _reversed as jax_reversed
    import repro_torch.kernels.bfs_multi_step.ops as b6

    flags = []

    def spy(*a, **kw):
        flags.append(kw.get("parents", True))
        return dense(*a, **kw)

    dense = b6.multi_bfs_step
    monkeypatch.setattr(b6, "multi_bfs_step", spy)
    g, t = graph
    src = np.array([0, 2, 31, 40, 63, -1, 65, 5], np.int32)
    dst = np.array([-1, -1, 5, -1, 0, 3, -1, 5], np.int32)
    for jg, tg in ((g, t), (jax_reversed(g), _reversed(t))):
        want = J.multi_bfs(jg, jnp.asarray(src), jnp.asarray(dst),
                           backend="pallas", parents=False)
        got = T.multi_bfs(tg, src, dst, backend="dense_cuda", parents=False)
        for f, a, b in zip(want._fields, want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f"dense_cuda {f}")
    assert flags and set(flags) == {False}


def test_traced_session_observes_index_metrics(graph):
    g, t = graph
    ti = TI.build_index(t, 3)
    t2 = _port(_apply(g, SMALL))
    before = global_registry().snapshot()
    with trace.capture() as rec:
        TI.reach_session(lambda: t, ti, [(0, 5), (5, 0)])
        TI.reach_session(lambda: t2, ti, [(0, 5)], on_conflict="epoch",
                         fetch_epoch=lambda: (7, t2))
    after = global_registry().snapshot()
    names = [e["name"] for e in rec.events()]
    assert names.count("index.query") == 2
    assert "index.fallback" in names and "index.ring_validate" in names
    for m, n in (("index.query_s", 2), ("index.fallback_s", 1),
                 ("index.ring_validate_s", 1)):
        assert after[m]["count"] - before[m]["count"] == n, m
    assert after["index.query_s"]["max"] >= after["index.query_s"]["min"]


def test_unported_paths_raise(graph):
    _, t = graph
    ti = TI.build_index(t, 3)
    with pytest.raises(NotImplementedError, match="A7"):
        TI.reach_session(lambda: t, ti, [(0, 1)], ring=object())
    with pytest.raises(TypeError, match="A10"):
        TI.build_index(object())
