"""The port's BFS (repro_torch.core.bfs) against the JAX package's: every
result field (found, parent, dist, expanded, steps, supersteps), bit for
bit, on the port's "hybrid", "packed", "dense" and "hybrid_cuda" (plain
versions on the CPU) against JAX "hybrid" and "hybrid_pallas" (alpha/beta
set so that both directions run), and on "dense_cuda" against JAX
"pallas" (interpret mode, so on a graph of capacity 48)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core.bfs import pick_direction as jax_pick
import repro_torch.core as T
from repro_torch.convert import state_from_numpy
from repro_torch.core.bfs import BACKEND_ENV, pick_direction
from repro_torch.obs import trace
from repro_torch.obs.metrics import global_registry


def _graph(v=200, nv=190, ne=500, seed=0):
    rng = np.random.default_rng(seed)
    ops = [(J.OP_ADD_V, k) for k in range(nv)]
    ops += [(J.OP_ADD_E, int(a), int(b))
            for a, b in rng.integers(0, nv, (ne, 2))]
    ops += [(J.OP_ADD_E, k, k + 31) for k in range(0, nv - 31, 9)]
    ops += [(J.OP_REM_V, k) for k in range(0, nv, 29)]
    g = J.make_graph(v)
    for i in range(0, len(ops), 256):
        g, _ = J.apply_ops_fast(g, J.make_op_batch(ops[i:i + 256], 256))
    t = state_from_numpy(*[np.asarray(x) for x in g], device="cpu")
    src = rng.integers(-1, v, 8).astype(np.int32)
    src[:3] = [1, 2, 3]
    dst = rng.integers(-1, v, 8).astype(np.int32)
    return g, t, src, dst


def _equal(jres, tres, what):
    for f, a, b in zip(jres._fields, jres, tres):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=f"{what}: {f}")


@pytest.fixture(scope="module")
def graph():
    return _graph()


KNOBS = dict(alpha=4, beta=8)         # low enough that pull supersteps run


@pytest.mark.parametrize("parents", [True, False])
def test_multi_bfs_backends_match_jax(graph, parents):
    G, TS, SRC, DST = graph
    want = J.multi_bfs(G, jnp.asarray(SRC), jnp.asarray(DST),
                       backend="hybrid", parents=parents, **KNOBS)
    for be in ("hybrid", "packed", "dense", "hybrid_cuda"):
        got = T.multi_bfs(TS, SRC, DST, backend=be, parents=parents, **KNOBS)
        _equal(want, got, f"{be} parents={parents}")


def test_multi_bfs_matches_jax_pallas_backend_and_both_directions_run(
        graph, tmp_path):
    G, TS, SRC, DST = graph
    want = J.multi_bfs(G, jnp.asarray(SRC), jnp.asarray(DST),
                       backend="hybrid_pallas", **KNOBS)
    before = global_registry().snapshot()
    with trace.capture() as rec:
        got = T.multi_bfs(TS, SRC, DST, backend="hybrid_cuda", **KNOBS)
        trace.counter("test.counter", 1)
        saved = trace.save(str(tmp_path / "t.json"))
    _equal(want, got, "hybrid_cuda vs hybrid_pallas")
    dirs = [e["args"]["direction"] for e in rec.events()
            if e["name"] == "bfs.superstep"]
    assert "push" in dirs and "pull" in dirs
    assert len(dirs) == int(got.supersteps)
    after = global_registry().snapshot()
    flips = sum(a != b for a, b in zip(dirs, dirs[1:]))
    assert after["bfs.supersteps"] - before["bfs.supersteps"] == len(dirs)
    assert (after["bfs.pull_supersteps"] - before["bfs.pull_supersteps"]
            == dirs.count("pull"))
    assert (after["bfs.direction_flips"] - before["bfs.direction_flips"]
            == flips)
    with open(saved) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"bfs.session", "bfs.superstep", "test.counter"} <= names


@pytest.mark.parametrize("be", ["hybrid", "hybrid_cuda", "packed", "dense"])
def test_single_bfs_matches_jax(graph, be):
    G, TS, SRC, DST = graph
    for s, d in ((1, int(DST[0])), (2, -1), (3, 3), (-1, 4)):
        want = J.bfs(G, s, d, backend="hybrid", **KNOBS)
        got = T.bfs(TS, s, d, backend=be, **KNOBS)
        _equal(want, got, f"{be} {s}->{d}")
    assert int(T.reachable_count(TS, 2, backend=be)) == int(
        J.reachable_count(G, 2))


def test_extract_path_matches_jax(graph):
    G = graph[0]
    r = J.bfs(G, 1, -1)
    for d in (0, 5, 77, 199):
        jn, jslots = J.extract_path(r.parent, 1, d)
        tn, tslots = T.extract_path(torch.from_numpy(np.array(r.parent)),
                                    1, d)
        assert tn == int(jn)
        np.testing.assert_array_equal(tslots, np.asarray(jslots))


def test_pick_direction_is_float32_as_in_jax():
    for pulling, nf, nu, v in ((False, 3, 100, 200), (False, 4, 128, 200),
                               (True, 3, 0, 200), (True, 2**26, 1, 2**31),
                               (False, 2**26 + 1, 2**31 - 1, 2**31)):
        want = bool(jax_pick(jnp.asarray(pulling), jnp.int32(nf),
                             jnp.int32(nu), v, 32, 64))
        assert pick_direction(pulling, nf, nu, v, 32, 64) == want


def test_default_backend_follows_device_and_own_env(graph, monkeypatch):
    G, TS, SRC, DST = graph
    monkeypatch.delenv(BACKEND_ENV, raising=False)
    monkeypatch.setenv("REPRO_BFS_BACKEND", "packed")    # JAX's: ignored
    assert T.default_backend("cpu") == "hybrid"
    assert T.default_backend("cuda") == "hybrid_cuda"
    monkeypatch.setenv(BACKEND_ENV, "dense")
    assert T.default_backend("cuda") == "dense"
    with pytest.raises(ValueError, match="pallas"):    # JAX's name only
        T.bfs(TS, 1, 2, backend="pallas")
    with pytest.raises(ValueError):
        T.multi_bfs(TS, SRC, DST, backend="nope")


@pytest.fixture(scope="module")
def small_graph():
    return _graph(v=48, nv=46, ne=120, seed=3)


@pytest.mark.parametrize("parents", [True, False])
def test_multi_bfs_dense_cuda_matches_jax_pallas(small_graph, parents):
    G, TS, SRC, DST = small_graph
    SRC, DST = SRC % 48, DST % 48
    SRC[3], DST[4] = -1, -1
    want = J.multi_bfs(G, jnp.asarray(SRC), jnp.asarray(DST),
                       backend="pallas", parents=parents)
    got = T.multi_bfs(TS, SRC, DST, backend="dense_cuda", parents=parents)
    _equal(want, got, f"dense_cuda parents={parents}")
    assert int(got.supersteps) > 2


def test_single_bfs_dense_cuda_matches_jax_pallas(small_graph):
    G, TS, _, _ = small_graph
    for s, d in ((1, 40), (2, -1), (3, 3), (-1, 4), (29, 5)):
        want = J.bfs(G, s, d, backend="pallas")
        got = T.bfs(TS, s, d, backend="dense_cuda")
        _equal(want, got, f"dense_cuda {s}->{d}")


@pytest.mark.parametrize("be", ["hybrid_cuda", "packed_cuda"])
def test_kernel_closure_route_hands_no_parents_to_the_wrappers(
        graph, monkeypatch, be):
    """multi_bfs(parents=False) on a kernel backend calls the B1/B2
    wrappers with ``parents=False`` (they then compute no parent), and
    with parents otherwise; both equal JAX."""
    import repro_torch.kernels.bfs_multi_step.ops as b1
    import repro_torch.kernels.bfs_pull_step.ops as b2

    seen = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            seen.append((name, kw.get("parents", True)))
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(b1, "multi_bfs_step_packed",
                        spy("B1", b1.multi_bfs_step_packed))
    monkeypatch.setattr(b2, "multi_bfs_pull_step",
                        spy("B2", b2.multi_bfs_pull_step))
    G, TS, SRC, DST = graph
    for parents in (False, True):
        seen.clear()
        want = J.multi_bfs(G, jnp.asarray(SRC), jnp.asarray(DST),
                           backend="hybrid", parents=parents, **KNOBS)
        got = T.multi_bfs(TS, SRC, DST, backend=be, parents=parents, **KNOBS)
        _equal(want, got, f"{be} parents={parents}")
        names = {n for n, _ in seen}
        assert names == ({"B1", "B2"} if be == "hybrid_cuda" else {"B1"})
        assert {p for _, p in seen} == {parents}
