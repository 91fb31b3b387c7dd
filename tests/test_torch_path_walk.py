"""GetPath's path walk (kernels/path_walk).

On the CPU the plain version (``kernels/path_walk/ref.py``) is held, case
by case, to the JAX package's walk: ``repro.core.bfs.extract_path`` on
each query's row of the forest, then the key gather of its slots (the
session's materialization). The forests are the port's ``multi_bfs``
trees on small random graphs (pairs with a path, pairs without one, a
source equal to its destination, absent endpoints), and hand-made ones:
an absent endpoint whose pair is flagged found, a chain of V slots (past
the row's cap, up to the V-hop stop) and a cycle the source is not on
(the walk stops after V slots). A session whose path is longer than the
cap walks again at the longest length and answers as a session whose
paths fit. The wrapper walks on the host for a CPU forest and raises on
a device that is neither; a session on a sharded state answers as one on
the dense state.

On the card (``cuda``-marked, skipped without one) the kernel equals the
plain version bit for bit on the same inputs, at the session's cap, a
small cap and a cap of V; a CUDA forest with an operand off its device
raises rather than walk on the host; sessions and ``get_path`` on a CUDA
state, dense or sharded, equal those on the CPU, with one launch a
session (two where a path outgrows the cap). The JAX cases skip where jax
is not installed or a card is present, so on the card's machine:

    python -m pytest -q tests/test_torch_path_walk.py
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core.snapshot import get_path_session, get_paths_session
from repro_torch.kernels.path_walk import ops as pw_ops
from repro_torch.kernels.path_walk.ops import path_walk
from repro_torch.kernels.path_walk.ref import CAP, path_walk_ref
from repro_torch.obs import trace

GRAPHS = [(0, 40, 48, 70), (1, 60, 64, 50), (2, 30, 45, 120)]
LONG_V = 600          # past CAP: a chain's walk ends after V slots
CASES = ([f"random{i}" for i in range(len(GRAPHS))]
         + ["absent_found", "chain", "cycle"])


def _random_case(seed, n_keys, cap_v, n_edges):
    """(parent, found, src, dst, vkey) CPU tensors: the port's multi_bfs
    forest for pairs of keys on a random graph of ``n_keys`` keys (the
    last three removed again, so absent) in ``cap_v`` slots."""
    rng = np.random.default_rng(seed)
    ops = [(T.OP_ADD_V, k) for k in range(n_keys)]
    ops += [(T.OP_ADD_E, int(a), int(b))
            for a, b in rng.integers(0, n_keys, (n_edges, 2))]
    ops += [(T.OP_REM_V, k) for k in range(n_keys - 3, n_keys)]
    st, _ = T.apply_ops(T.make_graph(cap_v, device="cpu"),
                        T.make_op_batch(ops, device="cpu"))
    ks = rng.integers(0, n_keys + 2, 16).tolist() + [5, 7, n_keys - 1]
    ls = rng.integers(0, n_keys + 2, 16).tolist() + [5, n_keys - 1, 7]
    sk = T.find_slots(st, torch.tensor(ks, dtype=torch.int32))
    sl = T.find_slots(st, torch.tensor(ls, dtype=torch.int32))
    r = T.multi_bfs(st, sk, sl)
    found = r.found & (sk >= 0) & (sl >= 0)
    return r.parent.contiguous(), found, sk, sl, st.vkey


def _case(name):
    if name.startswith("random"):
        return _random_case(*GRAPHS[int(name[len("random"):])])
    if name == "absent_found":
        # flagged found with an absent destination or source: the walk
        # from a negative slot is empty; from dst it runs to the first
        # slot without a parent (one slot, then two)
        v = 16
        parent = torch.full((3, v), -1, dtype=torch.int32)
        parent[2, 5] = 4
        found = torch.tensor([True, True, True])
        src = torch.tensor([3, -1, -1], dtype=torch.int32)
        dst = torch.tensor([-1, 6, 5], dtype=torch.int32)
        vkey = torch.arange(100, 100 + v, dtype=torch.int32)
        return parent, found, src, dst, vkey
    v = LONG_V
    idx = torch.arange(v, dtype=torch.int32)
    vkey = torch.from_numpy(np.random.default_rng(9).permutation(
        3 * v)[:v].astype(np.int32))
    if name == "chain":
        # query 0: slot i's parent is i - 1, the whole chain (V slots);
        # query 1: the last 300 slots; query 2: not found
        parent = (idx - 1)[None].repeat(3, 1)
        found = torch.tensor([True, True, False])
        src = torch.tensor([0, v - 300, 0], dtype=torch.int32)
        dst = torch.full((3,), v - 1, dtype=torch.int32)
        return parent, found, src, dst, vkey
    # cycle: slots 1..V-1 in a ring that misses the source, slot 0
    parent = torch.where(idx <= 1, v - 1, idx - 1)[None].repeat(2, 1)
    found = torch.tensor([True, True])
    src = torch.tensor([0, 0], dtype=torch.int32)
    dst = torch.tensor([v - 1, 0], dtype=torch.int32)
    return parent, found, src, dst, vkey


def _jax_rows(parent, found, src, dst, vkey, cap):
    """The JAX package's walk and key gather, as ref.py's rows. The JAX
    package is the CPU reference: where a card is present it would claim
    the card's memory, so these cases skip there."""
    if torch.cuda.is_available():
        pytest.skip("the JAX reference runs only where there is no card")
    jbfs = pytest.importorskip("repro.core.bfs")
    jnp = pytest.importorskip("jax.numpy")
    par = parent.numpy()
    keys = vkey.numpy()
    v = par.shape[1]
    out = np.full((par.shape[0], 2 + cap), -1, np.int32)
    for q in range(par.shape[0]):
        out[q, 0] = int(bool(found[q]))
        if not bool(found[q]):
            out[q, 1] = 0
            continue
        n, slots = jbfs.extract_path(jnp.asarray(par[q]), int(src[q]),
                                     int(dst[q]))
        n, slots = int(n), np.asarray(slots)
        got = np.where(slots >= 0, keys[np.clip(slots, 0, v - 1)], -1)
        out[q, 1] = n
        out[q, 2:2 + min(n, cap)] = got[:min(n, cap)]
    return out


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("cap", [CAP, 3])
def test_ref_equals_jax_extract_path(case, cap):
    args = _case(case)
    got = path_walk_ref(*args, cap=cap)
    want = _jax_rows(*args, cap=cap)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and got.shape == (len(args[1]), 2 + cap)


def test_the_cases_cover_what_they_name():
    lens = {c: path_walk_ref(*_case(c), cap=4)[:, :2].tolist() for c in CASES}
    rnd = [row for c in CASES if c.startswith("random") for row in lens[c]]
    assert any(f and n > 2 for f, n in rnd)          # a path of 3 slots
    assert any(f and n == 1 for f, n in rnd)          # src == dst
    assert any(not f for f, _ in rnd)                 # not found
    for c in CASES[:len(GRAPHS)]:
        _, _, src, dst, _ = _case(c)
        assert (src < 0).any() and (dst < 0).any()    # absent endpoints
    assert lens["absent_found"] == [[1, 0], [1, 1], [1, 2]]
    assert lens["chain"] == [[1, LONG_V], [1, 300], [0, 0]]
    assert lens["cycle"] == [[1, LONG_V], [1, 1]]


def test_the_wrapper_refuses_a_device_that_is_neither():
    args = [t.to("meta") for t in _case("random0")]
    with pytest.raises(ValueError, match="no path walk kernel for device"):
        path_walk(*args)


def test_the_wrapper_takes_the_plain_walk_on_the_cpu():
    args = _case("chain")
    before = pw_ops.launches
    np.testing.assert_array_equal(path_walk(*args).numpy(),
                                  path_walk_ref(*args).numpy())
    assert pw_ops.launches == before


def _chain_state(n, capacity, device="cpu"):
    st, _ = T.apply_ops(T.make_graph(capacity, device=device), T.make_op_batch(
        [(T.OP_ADD_V, k) for k in range(n)]
        + [(T.OP_ADD_E, k, k + 1) for k in range(n - 1)], device=device))
    return st


LONG_PAIRS = [(0, CAP + 19), (3, 9), (CAP + 19, 0), (4, 4), (7, 1 << 20)]


def _long_answers():
    n = CAP + 20
    return [(True, list(range(n))), (True, list(range(3, 10))),
            (False, []), (True, [4]), (False, [])]


def test_session_walks_paths_past_the_cap_again():
    st = _chain_state(CAP + 20, CAP + 40)
    with trace.capture() as rec:
        got, rounds = get_paths_session(lambda: st, LONG_PAIRS)
    assert got == _long_answers() and rounds == 2
    ev = [e for e in rec.events() if e["ph"] == "X"]
    homes = [e["args"]["bytes"] for e in ev if e["name"] == "session.to_host"]
    # the first block, then every pair again at the longest length
    assert homes == [len(LONG_PAIRS) * (2 + CAP) * 4,
                     len(LONG_PAIRS) * (2 + CAP + 20) * 4]
    (walk,) = [e for e in ev if e["name"] == "session.path_walk"]
    assert walk["args"] == {"engine": "host", "hops": CAP + 20}
    pr = get_path_session(lambda: st, 0, CAP + 19)
    assert bool(pr.found) and int(pr.length) == CAP + 20
    assert pr.keys.tolist() == list(range(CAP + 20)) + [-1] * 20


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the path walk kernel needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("cap", [CAP, 3, None])
def test_cuda_kernel_equals_ref(cuda_device, case, cap):
    args = _case(case)
    cap = args[0].shape[1] if cap is None else cap
    dev_args = [t.to(cuda_device) for t in args]
    before = pw_ops.launches
    got = path_walk(*dev_args, cap=cap)
    torch.cuda.synchronize()
    assert pw_ops.launches == before + 1
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), path_walk_ref(*args, cap=cap))


@pytest.mark.cuda
@pytest.mark.parametrize("off", range(1, 5))
def test_cuda_forest_with_an_operand_off_its_device_raises(cuda_device, off):
    args = [t.to(cuda_device) for t in _case("random0")]
    args[off] = args[off].cpu()
    before = pw_ops.launches
    with pytest.raises(ValueError, match="must be contiguous on cuda"):
        path_walk(*args)
    assert pw_ops.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cuda_sessions_equal_the_cpu_ones(cuda_device, seed):
    _, n_keys, cap_v, n_edges = GRAPHS[seed]
    rng = np.random.default_rng(seed)
    ops = [(T.OP_ADD_V, k) for k in range(n_keys)]
    ops += [(T.OP_ADD_E, int(a), int(b))
            for a, b in rng.integers(0, n_keys, (n_edges, 2))]
    pairs = [tuple(p) for p in rng.integers(0, n_keys + 2, (24, 2)).tolist()]
    states = {}
    for d in ("cpu", cuda_device):
        states[d], _ = T.apply_ops(T.make_graph(cap_v, device=d),
                                   T.make_op_batch(ops, device=d))
    before = pw_ops.launches
    got = get_paths_session(lambda: states[cuda_device], pairs)
    assert pw_ops.launches == before + 1
    assert got == get_paths_session(lambda: states["cpu"], pairs)
    for k, l in pairs[:6]:
        a = get_path_session(lambda: states[cuda_device], k, l)
        b = get_path_session(lambda: states["cpu"], k, l)
        assert a.keys.device.type == "cuda"
        for f, x, y in zip(a._fields, a, b):
            assert torch.equal(x.cpu(), y), f


@pytest.mark.cuda
def test_cuda_session_past_the_cap(cuda_device):
    st = _chain_state(CAP + 20, CAP + 40, device=cuda_device)
    before = pw_ops.launches
    with trace.capture() as rec:
        got, _ = get_paths_session(lambda: st, LONG_PAIRS)
    assert got == _long_answers()
    assert pw_ops.launches == before + 2
    (walk,) = [e for e in rec.events() if e["ph"] == "X"
               and e["name"] == "session.path_walk"]
    assert walk["args"] == {"engine": "device", "hops": CAP + 20}


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_sharded_sessions_equal_the_dense_ones(device):
    """A session on a state cut into 4 row blocks on one device (the CPU,
    or the card: the forest and the keys sit on the controller's device,
    so the kernel walks there) answers as the dense CPU state's."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("the path walk kernel needs an NVIDIA GPU")
    from repro_torch.core.distributed import make_graph_mesh
    from repro_torch.core.partition import shard_state

    _, n_keys, cap_v, n_edges = GRAPHS[1]
    rng = np.random.default_rng(3)
    ops = [(T.OP_ADD_V, k) for k in range(n_keys)]
    ops += [(T.OP_ADD_E, int(a), int(b))
            for a, b in rng.integers(0, n_keys, (n_edges, 2))]
    states = {}
    for d in {"cpu", device}:
        states[d], _ = T.apply_ops(T.make_graph(cap_v, device=d),
                                   T.make_op_batch(ops, device=d))
    dense = states["cpu"]
    sharded = shard_state(make_graph_mesh([device], shards=4), states[device])
    pairs = [tuple(p) for p in rng.integers(0, n_keys + 2, (24, 2)).tolist()]
    before = pw_ops.launches
    with trace.capture() as rec:
        got = get_paths_session(lambda: sharded, pairs)
    assert got == get_paths_session(lambda: dense, pairs)
    assert any(f for f, _ in got[0]) and not all(f for f, _ in got[0])
    (walk,) = [e for e in rec.events() if e["ph"] == "X"
               and e["name"] == "session.path_walk"]
    engine = "device" if device == "cuda" else "host"
    assert walk["args"]["engine"] == engine
    assert pw_ops.launches == before + (device == "cuda")
    for k, l in pairs[:6]:
        a = get_path_session(lambda: sharded, k, l)
        b = get_path_session(lambda: dense, k, l)
        assert a.keys.device.type == device
        for f, x, y in zip(a._fields, a, b):
            assert torch.equal(x.cpu(), y), f
