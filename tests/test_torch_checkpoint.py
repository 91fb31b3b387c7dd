"""The port's checkpointer (repro_torch.checkpoint) against the JAX
package's (repro.checkpoint): the checkpointer tests of
``tests/test_checkpoint.py`` on torch trees (round trip, async save with
retention, atomic publish, a mid-write crash restores the previous step
and the stale tmp dir is swept, blocking publish, a background failure
surfacing on ``wait``, ``restore_raw`` with a varying leaf count,
``shardings=`` placing DTensors on a one-process mesh), the device -> host copy made before ``save``
returns, and one graph checkpoint written by each package's ingest pool
on the same schedule: identical ``.npy`` bytes, manifests equal apart
from ``time``, and each package restores the other's step."""
import json
import os
import random

import numpy as np
import pytest
import torch

from repro.runtime.recovery import GraphCheckpointer as JGraphCkpt
from repro.testing.schedules import gen_client_programs, random_schedule
from repro.testing.schedules import run_schedule as jrun
from repro_torch.checkpoint import Checkpointer
from repro_torch.convert import state_to_numpy
from repro_torch.runtime.recovery import GraphCheckpointer as TGraphCkpt
from repro_torch.testing.schedules import host_fields
from repro_torch.testing.schedules import run_schedule as trun

CPU = {"device": "cpu"}


def _tree_equal(a, b):
    import torch.utils._pytree as pytree

    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    return sa == sb and all(torch.equal(x, y) for x, y in zip(la, lb))


def test_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"a": torch.arange(10), "b": [torch.ones(3, 4),
                                        torch.zeros(2, dtype=torch.int32)]}
    ck.save(5, tree, blocking=True)
    out, manifest = ck.restore(tree, **CPU)
    assert manifest["step"] == 5
    assert manifest["dtypes"] == ["int64", "float32", "int32"]
    assert _tree_equal(tree, out)


def test_async_save_and_retention(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"w": torch.ones(8, 8)}
    for s in (1, 2, 3, 4):
        ck.save(s, {"w": tree["w"] * s})
    ck.wait()
    assert ck.all_steps() == [3, 4]
    out, m = ck.restore(tree, **CPU)
    assert m["step"] == 4
    assert float(out["w"][0, 0]) == 4.0


def test_atomic_publish_no_partial_checkpoints(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones(4)}, blocking=True)
    assert all(n.startswith("step_") for n in os.listdir(tmp_path))


def test_the_host_copy_is_taken_before_save_returns(tmp_path):
    """An in-place write after an async ``save`` returns must not reach
    the checkpoint: the leaves were copied on the caller's thread."""
    ck = Checkpointer(str(tmp_path))
    w = torch.arange(1 << 16, dtype=torch.int32)
    ck.save(1, [w])
    w.zero_()
    ck.wait()
    raw, _ = ck.restore_raw()
    np.testing.assert_array_equal(raw[0], np.arange(1 << 16, dtype=np.int32))


def test_crash_mid_write_restores_previous_step(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.arange(4)}, blocking=True)
    ck._write(2, [np.arange(4) * 9],
              {"step": 2, "n_leaves": 1, "extra": {}}, publish=False)
    assert any(n.startswith(".tmp_step_") for n in os.listdir(tmp_path))
    assert ck.latest_step() == 1
    out, m = ck.restore({"w": torch.zeros(4, dtype=torch.int32)}, **CPU)
    assert m["step"] == 1
    assert out["w"].dtype == torch.int32
    assert out["w"].tolist() == [0, 1, 2, 3]
    ck2 = Checkpointer(str(tmp_path))   # restart sweeps the torn tmp
    assert not any(n.startswith(".tmp_step_") for n in os.listdir(tmp_path))
    assert ck2.latest_step() == 1


def test_save_blocking_publishes_before_return(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(3, {"w": torch.ones(2)}, blocking=True)
    names = os.listdir(tmp_path)
    assert "step_000000003" in names
    assert not any(n.startswith(".tmp_step_") for n in names)


def test_background_write_failure_surfaces_on_wait(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))

    def boom(*a, **k):
        raise OSError("disk gone")

    monkeypatch.setattr(ck, "_write", boom)
    ck.save(1, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="background checkpoint write"):
        ck.wait()
    monkeypatch.undo()
    ck.save(2, {"w": torch.ones(2)}, blocking=True)
    assert ck.latest_step() == 2


def test_restore_raw_loads_variable_leaf_count(tmp_path):
    ck = Checkpointer(str(tmp_path))
    leaves = [np.arange(3), np.eye(2), torch.tensor([7])]
    ck.save(4, leaves, blocking=True)
    raw, manifest = ck.restore_raw()
    assert manifest["step"] == 4 and len(raw) == 3
    assert manifest["treedef"] == "PyTreeDef([*, *, *])"
    for a, b in zip(raw, leaves):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_sharded_restore_waits_for_a10(tmp_path):
    """``restore(shardings=)`` on the (1, 1) mesh of a one-process gloo
    group: a leaf with a ``NamedSharding`` comes back a DTensor on it whose
    local tensor is the file's bytes (bf16 through the int16 view), a None
    leaf a plain tensor; a shardings tree of another size, or a template
    of another structure, raises."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding as sh

    ck = Checkpointer(str(tmp_path))
    w = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    b = torch.linspace(-1, 1, 6).to(torch.bfloat16)
    ck.save(1, {"b": b, "w": w, "n": torch.tensor([7])}, blocking=True)
    mesh = make_host_mesh(device_type="cpu")
    try:
        named = sh.to_named({"b": sh.P("data"), "w": sh.P(None, "model")},
                            mesh)
        tree, manifest = ck.restore(
            {"b": b, "w": w, "n": torch.tensor([0])},
            shardings={"b": named["b"], "w": named["w"], "n": None}, **CPU)
        assert manifest["step"] == 1
        for k, want in (("b", b), ("w", w)):
            assert tree[k].device_mesh == mesh
            assert tree[k].placements == named[k].placements
            assert torch.equal(tree[k].to_local().view(torch.uint8),
                               want.view(torch.uint8))
        assert type(tree["n"]) is torch.Tensor and int(tree["n"][0]) == 7
        with pytest.raises(ValueError, match="shardings have"):
            ck.restore({"b": b, "w": w, "n": w}, shardings={"b": None},
                       **CPU)
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="tree structure"):
        ck.restore([torch.ones(2), torch.ones(2)], **CPU)


def _graph_dirs(tmp_path):
    """The same durable schedule through both packages' pools; returns
    (JAX trace, port trace), each with cadence checkpoints on disk."""
    rng = random.Random(21)
    progs = gen_client_programs(rng, clients=3, batches_per_client=4,
                                max_lanes=3, conflict_rate=0.4)
    sched = random_schedule(random.Random(22), progs)
    kw = dict(capacity=40, retain_epochs=5, ckpt_every=3)
    jt = jrun(sched, durable_dir=str(tmp_path / "jax"), **kw)
    tt = trun(sched, durable_dir=str(tmp_path / "port"), **CPU, **kw)
    return jt, tt


def test_graph_checkpoints_are_byte_identical_to_jax(tmp_path):
    jt, tt = _graph_dirs(tmp_path)
    jdir, tdir = tmp_path / "jax" / "ckpt", tmp_path / "port" / "ckpt"
    steps = sorted(os.listdir(jdir))
    assert steps and steps == sorted(os.listdir(tdir))
    assert tt.pool.stats.ckpt_saves == jt.pool.stats.ckpt_saves >= 2
    for step in steps:
        names = sorted(os.listdir(jdir / step))
        assert names == sorted(os.listdir(tdir / step))
        for name in names:
            jb = (jdir / step / name).read_bytes()
            tb = (tdir / step / name).read_bytes()
            if name == "manifest.json":
                jm, tm = json.loads(jb), json.loads(tb)
                jm.pop("time"), tm.pop("time")
                assert tm == jm
                assert tm["treedef"].startswith("PyTreeDef([*, *")
                assert tm["dtypes"][:6] == ["int32", "bool", "int32",
                                            "int32", "uint32", "uint32"]
            else:
                assert tb == jb, f"{step}/{name}"


def test_each_package_restores_the_others_graph_step(tmp_path):
    _graph_dirs(tmp_path)
    jdir, tdir = str(tmp_path / "jax" / "ckpt"), str(tmp_path / "port" / "ckpt")
    t_state, t_ring, t_extra = TGraphCkpt(jdir).restore_graph(**CPU)
    j_state, j_ring, j_extra = JGraphCkpt(tdir).restore_graph()
    assert t_extra == j_extra
    for f, a, b in zip(j_state._fields, state_to_numpy(t_state), j_state):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
    tl, tm = t_ring.dump()
    jl, jm = j_ring.dump()
    assert tm == jm and len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    lo, hi = t_ring.window()
    for e in range(lo, hi + 1):
        got = host_fields(t_ring.state_at(e))
        want = j_ring.state_at(e)
        for f in j_state._fields:
            np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                          err_msg=f"epoch {e}: {f}")
