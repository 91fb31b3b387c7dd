"""The port's single-controller mesh and fully row-sharded legacy engines
(repro_torch.core.distributed, repro_torch.parallel) against the JAX
package's (repro.core.distributed, repro.parallel), bit for bit
(tolerance 0):

  * the collectives over per-shard lists against numpy, and the graph
    placement specs against JAX's;
  * ``shard_graph`` round trip; ``dbfs`` on 8 CPU row blocks against JAX's
    on its ambient 1-device mesh (a BFS does not depend on S), parents
    across shards included; ``dcollect`` / ``dcompare`` (the paper's
    adversary caught) and ``dget_path_session`` with a mutating fetch;
  * ``dapply_ops`` on one block against JAX's on one device (every field;
    the engine's slot placement depends on S), and on 8 blocks against the
    sequential oracle's result codes and graph;
  * ``-m slow``: one subprocess with 8 XLA host devices runs JAX's
    ``partition`` and ``distributed`` engines on 8 shards and the port's
    on 8 CPU row blocks, V <= 64, and compares them there.
"""
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.distributed as JD
import repro_torch.core as T
import repro_torch.core.distributed as TD
from repro.parallel.sharding import graph_state_specs as jax_specs
from repro_torch.convert import state_from_numpy
from repro_torch.core.graph import to_networkx_like
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import (graph_state_shardings,
                                           graph_state_specs, place)


def _mesh(s=8):
    return TD.make_graph_mesh(["cpu"], shards=s)


def _chain_graph(v=64):
    """0 -> 9 -> 18 -> ... plus random edges: every tree edge crosses a
    block of 8 rows."""
    rng = np.random.default_rng(0)
    ops = [(J.OP_ADD_V, k) for k in range(v - 4)]
    ops += [(J.OP_ADD_E, a, a + 9) for a in range(0, v - 13, 9)]
    ops += [(J.OP_ADD_E, int(a), int(b))
            for a, b in rng.integers(0, v - 4, (40, 2))]
    ops += [(J.OP_ADD_E, 31, 59), (J.OP_REM_V, 12)]
    g = J.make_graph(v)
    g, _ = J.apply_ops_fast(g, J.make_op_batch(ops, 128))
    return g, state_from_numpy(*[np.asarray(x) for x in g], device="cpu")


def test_collectives_and_placement():
    rng = np.random.default_rng(1)
    parts = [rng.integers(-5, 5, (3, 4)).astype(np.int32) for _ in range(5)]
    tp = [torch.from_numpy(p) for p in parts]
    assert torch.equal(C.psum(tp), torch.from_numpy(sum(parts)))
    assert torch.equal(C.pmin(tp), torch.from_numpy(np.min(parts, 0)))
    assert torch.equal(C.pmax(tp + [None]),
                       torch.from_numpy(np.max(parts, 0)))
    assert torch.equal(C.all_gather(tp), torch.from_numpy(np.stack(parts)))
    assert torch.equal(C.all_gather(tp, tiled=True),
                       torch.from_numpy(np.concatenate(parts)))
    assert torch.equal(C.all_reduce_or([p > 3 for p in tp]),
                       torch.from_numpy(np.any([p > 3 for p in parts], 0)))
    words = [torch.tensor([1 << k, -(2**31)], dtype=torch.int32)
             for k in range(4)]
    assert C.or_fold(words).tolist() == [15, -(2**31)]   # bit 31 kept
    specs, jspecs = graph_state_specs(), jax_specs()
    assert sorted(specs) == sorted(jspecs)
    for k, p in specs.items():   # JAX: P() replicated, P("rows", None) rows
        assert p.axis == (jspecs[k][0] if len(jspecs[k]) else None), k
    sh = graph_state_shardings(_mesh(4))
    blocks = place(torch.arange(8), sh["adj_packed"])
    assert [b.tolist() for b in blocks] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert list(place(torch.arange(8), sh["vkey"])) == [torch.device("cpu")]
    with pytest.raises(ValueError, match="not divisible"):
        place(torch.arange(9), sh["adj_packed"])


def test_dbfs_and_double_collect_match_jax():
    g, t = _chain_graph()
    jm = JD.make_graph_mesh()
    js = JD.shard_graph(jm, g)
    ts = TD.shard_graph(_mesh(), t)
    for f, a in zip(T.GraphState._fields, ts.gather()):
        np.testing.assert_array_equal(a.numpy().view(np.asarray(
            getattr(g, f)).dtype), np.asarray(getattr(g, f)), err_msg=f)
    # JAX's legacy engines are not jitted: every call compiles (~2-4 s),
    # so the JAX side runs one dbfs here; the 8-device subprocess
    # (-m slow) compares more pairs, the collects and the sessions
    want = JD.dbfs(jm, js, jnp.int32(0), jnp.int32(-1))
    got = TD.dbfs(_mesh(), ts, 0, -1)
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=f"dbfs(0, -1)[{i}]")
    assert got[1][54].item() == 45                    # across blocks
    assert not bool(TD.dbfs(_mesh(), ts, 12, 3)[0])   # a dead source
    tc = TD.dcollect(_mesh(), ts, 0, 54)
    early = TD.dbfs(_mesh(), ts, 0, 54)             # stops at 54
    want_touched = early[3].clone()
    want_touched[[0, 54]] = True
    assert bool(tc.found) and torch.equal(tc.touched, want_touched)
    assert torch.equal(tc.parent, early[1])
    assert torch.equal(torch.cat(tc.ver_ecnt), t.ecnt)
    assert bool(TD.dcompare(_mesh(), tc, TD.dcollect(_mesh(), ts, 0, 54)))
    # the paper's adversary: remove and re-add a tree edge between collects
    t2, _ = TD.dapply_ops(_mesh(), ts, T.make_op_batch(
        [(T.OP_REM_E, 9, 18), (T.OP_ADD_E, 9, 18)], device="cpu"))
    assert not bool(TD.dcompare(_mesh(), tc, TD.dcollect(_mesh(), t2, 0, 54)))
    states = iter([ts, t2, t2])

    def fetch():
        return next(states, t2)

    got = TD.dget_path_session(_mesh(), fetch, 0, 54)
    assert got == (True, 7, [0, 9, 18, 27, 36, 45, 54], 3)
    with pytest.raises(TypeError):
        TD.dbfs(_mesh(), object(), 0, 1)


def _batches(rng, nv, n, lanes, cas=True):
    """Random batches over keys 0 .. nv + 2 (a negative key would make
    the 8-block AddVertex pick owner block 1, where the spec says R_FALSE)."""
    out = []
    for _ in range(n):
        out.append([(int(rng.choice([1, 2, 3, 4, 5, 6, 4, 5])),
                     *(int(x) for x in rng.integers(0, nv + 3, 2)),
                     int(rng.integers(0, 3)) if cas and rng.random() < 0.2
                     else -1) for _ in range(lanes)])
    return out


def test_dapply_ops_matches_jax_on_one_block_and_the_oracle_on_eight():
    g, t = _chain_graph(32)
    jm = JD.make_graph_mesh()
    js = JD.shard_graph(jm, g)
    ts1 = TD.shard_graph(_mesh(1), t)
    # 8 blocks of 32 rows: 4 free slots in block 0, the others empty
    ts8 = TD.shard_graph(_mesh(8), T.grow(t, 256))
    oracle = J.GraphOracle()
    vk, va = np.asarray(g.vkey), np.asarray(g.valive)
    oracle.apply_batch([(J.OP_ADD_V, int(k), -1, -1) for k in vk[va]])
    _, edges = to_networkx_like(t)
    oracle.apply_batch([(J.OP_ADD_E, a, b, -1) for a, b in edges])
    rng = np.random.default_rng(2)
    for i, ops in enumerate(_batches(rng, 28, 1, 24)
                            + [[(J.OP_ADD_V, 100 + k, -1, -1)
                                for k in range(40)]]):
        js, jres = JD.dapply_ops(jm, js, J.make_op_batch(ops))
        ts1, tres1 = TD.dapply_ops(_mesh(1), ts1,
                                   T.make_op_batch(ops, device="cpu"))
        np.testing.assert_array_equal(tres1.numpy(), np.asarray(jres))
        for f, a in zip(T.GraphState._fields, ts1.gather()):
            b = np.asarray(getattr(js, f))
            np.testing.assert_array_equal(a.numpy().view(b.dtype), b,
                                          err_msg=f"batch {i}: {f}")
        # 8 blocks: AddVertex allocates in block abs(key) % 8, so slots
        # move; the codes and the graph are the sequential spec's up to the
        # first lane whose owner block is full (no CAS lanes: a CAS could
        # read the RemoveVertex self-loop bump the engine skips)
        no_cas = [op[:3] + (-1,) for op in ops]
        ts8, tres8 = TD.dapply_ops(_mesh(8), ts8,
                                   T.make_op_batch(no_cas, device="cpu"))
        want = oracle.apply_batch(no_cas)
        got = [int(x) for x in tres8.numpy()]
        n = got.index(T.R_TABLE_FULL) if T.R_TABLE_FULL in got else len(got)
        assert got[:n] == want[:n], f"batch {i}"
        if n < len(got):
            assert n > 0 and i == 1          # the 40 AddVertex lanes:
            break                            # block 0 fills at its 5th
        verts, got_edges = to_networkx_like(ts8.gather())
        assert set(verts) == set(oracle.ecnt)
        assert set(got_edges) == oracle.edges
    assert bool(T.transpose_invariant(ts8.gather()))


_SUBPROCESS_SCRIPT = textwrap.dedent("""
    import numpy as np, jax, jax.numpy as jnp
    import repro.core as J
    import repro_torch.core as T
    from repro.core import partition as jpart
    from repro.core import distributed as JD
    from repro_torch.core import partition as P
    from repro_torch.core import distributed as TD
    from repro_torch.convert import sharded_state_from_numpy
    assert len(jax.devices()) == 8, jax.devices()
    jm, tm = JD.make_graph_mesh(), TD.make_graph_mesh(["cpu"], shards=8)

    def same(t, j, what):
        t = P.unshard(t) if isinstance(t, P.ShardedGraphState) else t
        j = jpart.unshard(j) if hasattr(j, "mesh") else j
        for f in T.GraphState._fields:
            b = np.asarray(getattr(j, f))
            a = getattr(t, f).numpy().view(b.dtype)
            assert np.array_equal(a, b), (what, f)

    rng = np.random.default_rng(0)
    ops = [(1, k) for k in range(60)]
    ops += [(4, int(a), int(b)) for a, b in rng.integers(0, 60, (150, 2))]
    ops += [(4, k, 31) for k in range(0, 60, 7)] + [(2, 20)]
    g, _ = J.apply_ops_fast(J.make_graph(64), J.make_op_batch(ops, 256))
    js = jpart.shard_state(jm, g)
    ts = sharded_state_from_numpy(tm, *[np.asarray(x) for x in g])
    for i in range(3):
        b = [(int(rng.choice([1, 2, 3, 4, 5, 6])),
              *(int(x) for x in rng.integers(-1, 64, 2)),
              int(rng.integers(0, 3)) if rng.random() < 0.2 else -1)
             for _ in range(32)]
        js, jr = jpart.apply_ops_fast(js, J.make_op_batch(b, 32))
        ts, tr = P.apply_ops_fast(ts, T.make_op_batch(b, 32, device="cpu"))
        assert np.array_equal(tr.numpy(), np.asarray(jr)), i
        same(ts, js, f"apply {i}")
    src = np.array([0, 31, 5, 63, -1, 7], np.int32)
    dst = np.array([63, -1, 9, 0, 3, 7], np.int32)
    for tb, jb in (("dense", "jnp"), ("dense_cuda", "pallas"),
                   ("packed", "packed"), ("packed_cuda", "packed_pallas"),
                   ("hybrid", "hybrid"), ("hybrid_cuda", "hybrid_pallas")):
        w = jpart.multi_bfs(js, jnp.asarray(src), jnp.asarray(dst),
                            backend=jb, alpha=4, beta=8)
        r = P.multi_bfs(ts, src, dst, backend=tb, alpha=4, beta=8)
        for f, a, b in zip(w._fields, w, r):
            assert np.array_equal(b.numpy(), np.asarray(a)), (tb, f)
    pairs = [(0, 63), (31, 2), (5, 9), (7, 7)]
    assert J.get_paths_session(lambda: js, pairs) == \\
        T.get_paths_session(lambda: ts, pairs)
    same(P.grow(ts, 100), jpart.grow(js, 100), "grow")
    same(P.compact(ts), jpart.compact(js), "compact")
    # the legacy engines: owner-routed slot placement on 8 shards
    jl = JD.shard_graph(jm, J.make_graph(64))
    tl = TD.shard_graph(tm, T.make_graph(64, device="cpu"))
    lops = [(1, k, -1, -1) for k in range(40)]
    lops += [(4, int(a), int(b), -1) for a, b in rng.integers(0, 40, (60, 2))]
    lops += [(4, 3, 3, -1), (2, 3, -1, -1), (4, 5, 9, 0), (1, 3, -1, -1)]
    for i in range(0, len(lops), 13):
        chunk = lops[i:i + 13]
        jl, jr = JD.dapply_ops(jm, jl, J.make_op_batch(chunk))
        tl, tr = TD.dapply_ops(tm, tl, T.make_op_batch(chunk, device="cpu"))
        assert np.array_equal(tr.numpy(), np.asarray(jr)), i
        same(tl.gather(), J.GraphState(*(np.asarray(x) for x in jl)),
             f"dapply {i}")
    for s, d in ((0, 13), (1, 20), (5, 6), (9, 2)):
        w = JD.dbfs(jm, jl, jnp.int32(s), jnp.int32(d))
        r = TD.dbfs(tm, tl, s, d)
        for a, b in zip(w, r):
            assert np.array_equal(b.numpy(), np.asarray(a)), (s, d)
        assert JD.dget_path_session(jm, lambda: jl, s, d) == \\
            TD.dget_path_session(tm, lambda: tl, s, d)
    print("TORCH_SHARDED_SUBPROCESS_OK")
""")


@pytest.mark.slow
def test_eight_shards_match_jax_subprocess():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         env.get("PYTHONPATH", "")])
    r = subprocess.run([sys.executable, "-c", _SUBPROCESS_SCRIPT],
                       capture_output=True, text=True, env=env, timeout=560)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "TORCH_SHARDED_SUBPROCESS_OK" in r.stdout
