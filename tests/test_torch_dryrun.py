"""The port's dry run (repro_torch.launch.dryrun) on fake ranks, on the CPU.

``run_cell`` builds its own "fake" process group and ``FakeTensorMode``, so
nothing is allocated; the tests swap in smoke configs (``get_config``) and
a (2, 2) (data, model) mesh (``make_production_mesh``) by monkeypatching
the module, and hold:

  * ``memory.argument_bytes`` against the local blocks worked out with
    numpy from the JAX package's specs (``repro.parallel.sharding``) of
    the same cell: params, both Adam moments, the step and the tokens;
  * collectives on a mesh whose "model" axis is 2;
  * per-device FLOPs of a one-layer prefill against a hand count of its
    products on the local blocks (heads, KV heads, ffn and vocab split
    over "model", batch over "data");
  * an MoE cell (the static dispatch) and a whole-size cell in a child
    process (``--subprocess``), as the CLI runs them;
  * that the process is left as found: no process group, no mesh set."""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

import repro.configs as JC
import repro_torch.configs as TC
from repro.models.model import build_model as jax_build
from repro.parallel import sharding as jsh
from repro_torch.launch import dryrun
from repro_torch.parallel import sharding as tsh

ROOT = Path(__file__).resolve().parents[1]


class FakeMesh:
    def __init__(self, shape_dict):
        self.shape = shape_dict
        self.axis_names = tuple(shape_dict)


@pytest.fixture
def small(monkeypatch):
    """Smoke configs (keyword overrides of their fields) on a (2, 2)
    mesh."""
    cfgs = {}

    def use(arch, **kw):
        cfgs[arch] = dataclasses.replace(TC.get_config(arch).smoke(), **kw)
        return cfgs[arch]

    def mesh(*, multi_pod=False):
        from torch.distributed.device_mesh import init_device_mesh

        return init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))

    monkeypatch.setattr(dryrun, "get_config", lambda a: cfgs[a])
    monkeypatch.setattr(dryrun, "make_production_mesh", mesh)
    return use


def _left_as_found():
    assert not dist.is_initialized()
    assert tsh.activation_mesh() is None


def _local_bytes(shape, spec, mesh, itemsize):
    n = 1
    for i, dim in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        n *= dim // jsh.axis_size(mesh, e)
    return n * itemsize


def test_argument_bytes_are_the_local_blocks_of_jax_s_specs(small):
    small("olmo-1b")
    rec = dryrun.run_cell("olmo-1b", "train_4k", "single")
    _left_as_found()
    assert rec["ok"], rec.get("trace")
    mesh = FakeMesh({"data": 2, "model": 2})
    jp = jax_build(JC.get_config("olmo-1b").smoke()).init_abstract()
    specs = jsh.param_specs(jp, mesh, "train")
    leaves = jax.tree.leaves(jp)
    sps = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JP))
    params = sum(_local_bytes(p.shape, s, mesh, p.dtype.itemsize)
                 for p, s in zip(leaves, sps))
    moments = 2 * sum(_local_bytes(p.shape, s, mesh, 4)
                      for p, s in zip(leaves, sps))
    sh = TC.SHAPES["train_4k"]
    tokens = _local_bytes((sh["global_batch"], sh["seq_len"]),
                          jsh.batch_spec(mesh, "tokens", (256, 4096)), mesh,
                          4)
    assert rec["memory"]["argument_bytes"] == params + moments + 4 + tokens
    # the step updates params and moments in place: the port's donation
    assert rec["memory"]["alias_bytes"] == params + moments
    assert rec["memory"]["temp_bytes"] > 0
    assert rec["collectives"]["count"] > 0
    assert rec["collectives"]["reduce-scatter"] > 0   # ZeRO gradients
    assert rec["devices"] == 4 and rec["microbatches"] == 1


def test_one_layer_prefill_flops_are_the_hand_count_per_device(small):
    cfg = small("olmo-1b", n_layers=1)
    rec = dryrun.run_cell("olmo-1b", "prefill_32k", "single")
    _left_as_found()
    assert rec["ok"], rec.get("trace")
    sh = TC.SHAPES["prefill_32k"]
    b, s = sh["global_batch"] // 2, sh["seq_len"]      # batch over data
    d, hd = cfg.d_model, cfg.hd
    q, kv = cfg.n_heads * hd // 2, cfg.n_kv * hd // 2  # heads over model
    ff, v = cfg.d_ff // 2, cfg.vocab // 2
    heads = cfg.n_heads // 2
    want = (2 * b * s * d * q + 2 * 2 * b * s * d * kv   # q, k, v
            + 2 * b * heads * s * s * hd * 2             # scores, P @ V
            + 2 * b * s * q * d                          # wo
            + 3 * 2 * b * s * d * ff                     # wg, wi, wo
            + 2 * b * 1 * d * v)                         # last-token logits
    assert rec["cost"]["flops"] == want
    assert rec["collectives"]["all-reduce"] > 0          # row-parallel sums


def test_an_moe_cell_runs_on_the_static_dispatch(small):
    small("olmoe-1b-7b")
    rec = dryrun.run_cell("olmoe-1b-7b", "train_4k", "single")
    _left_as_found()
    assert rec["ok"], rec.get("trace")
    assert rec["cost"]["flops"] > 0 and rec["collectives"]["count"] > 0


def test_a_cell_that_fails_records_its_error(small, monkeypatch):
    small("olmo-1b")

    def broken(*a, **k):
        raise RuntimeError("no such layout")

    monkeypatch.setattr(dryrun, "build_cell", broken)
    rec = dryrun.run_cell("olmo-1b", "decode_32k", "single")
    _left_as_found()
    assert not rec["ok"] and rec["error"] == "RuntimeError: no such layout"
    assert "no such layout" in rec["trace"]
    skipped = dryrun.run_cell("olmo-1b", "long_500k", "single")
    assert skipped["skipped"] and not skipped["ok"]


def test_collective_bytes_follow_jax_s_rule():
    out = dryrun.collective_bytes([("all-gather", 100, 1),
                                   ("reduce-scatter", 10, 16),
                                   ("all-reduce", 7, 1)])
    assert out == {"all-gather": 100, "all-reduce": 7, "reduce-scatter": 160,
                   "all-to-all": 0, "collective-permute": 0, "count": 3}


def test_the_cli_runs_a_whole_size_cell_in_a_child(tmp_path):
    out = tmp_path / "dry.jsonl"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--cells",
         "olmo-1b:decode_32k", "--subprocess", "--out", str(out)],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[olmo-1b x decode_32k x single] rc=0" in r.stdout
    rec = json.loads(out.read_text().splitlines()[-1])
    assert rec["ok"] and rec["devices"] == 256
    sh = TC.SHAPES["decode_32k"]
    cfg = TC.get_config("olmo-1b")
    # the caches: k and v of every layer, batch over data, KV heads over
    # model, bf16
    cache = (2 * cfg.n_layers * (sh["global_batch"] // 16) * sh["seq_len"]
             * (cfg.n_kv // 16) * cfg.hd * 2)
    assert rec["memory"]["argument_bytes"] > cache
