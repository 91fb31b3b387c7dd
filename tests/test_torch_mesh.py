"""The port's LM mesh (repro_torch.parallel.sharding's LM half,
launch.mesh, collectives.psum_hierarchical, the activation hooks, the
DTensor forms of attention, decode and the MoE dispatch, train(mesh=),
make_train_step(grad_specs=) and Checkpointer.restore(shardings=)) against
the JAX package's on the CPU.

  * Specs: for every arch, on the shape-only meshes tests/test_sharding.py
    uses (16 x 16 and 2 x 16 x 16), the port's ``param_specs`` equal JAX's
    leaf for leaf (a layer's spec is JAX's stacked leaf's without its
    lead) in all four modes, its ``cache_specs`` equal JAX's at
    decode_32k, and ``batch_spec`` equals JAX's; all on full-size
    abstract params (fake tensors against ``jax.eval_shape``).
  * Placements: ``to_named`` on a fake 2 x 16 x 16 group.
  * Real collectives: one world of 4 ``gloo`` processes on a FileStore as
    a (2, 2) (data, model) mesh, olmo-1b's smoke config in f32: two steps
    of ``train(mesh=)`` against the un-meshed run (loss rtol 1e-5; every
    parameter within 1e-5, as tests/test_torch_train.py holds a train
    step: at lr 1e-3 that is 1% of one Adam step, which normalizes the
    rounding of gradients summed in another order over the shards; every
    leaf's |p| is below 1 here), at least one leaf split, meshed decode
    steps against plain ones (1e-5 of the logits' max; caches within
    1e-5) with the KV heads split, with the length split (flash decoding)
    and for mamba2's SSD with its heads split, ``psum_hierarchical``
    against a plain sum, and ``restore(shardings=)`` of a JAX-written
    checkpoint giving JAX's bytes in every leaf's ``full_tensor()``.
  * The static MoE dispatch against JAX's ``apply_moe`` on the routing
    cases of tests/test_torch_lm_families.py (rtol = atol = 1e-4, f32).

Every process group a test starts is destroyed before it returns."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP

import repro.configs as JC
import repro_torch.configs as TC
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.models import moe as jmoe
from repro.models.model import build_model as jax_build
from repro.optim import adamw as jadamw
from repro.parallel import sharding as jsh
from repro_torch.convert import jax_layout
from repro_torch.models import moe as tmoe
from repro_torch.models.model import build_model
from repro_torch.parallel import sharding as tsh

ROOT = Path(__file__).resolve().parents[1]


class FakeMesh:
    """Shape-only stand-in so spec construction needs no 256 devices."""

    def __init__(self, shape_dict):
        self.shape = shape_dict
        self.axis_names = tuple(shape_dict)


MESHES = {
    "single": FakeMesh({"data": 16, "model": 16}),
    "multi": FakeMesh({"pod": 2, "data": 16, "model": 16}),
}
MODES = ("train", "serve", "fsdp", "replicated")


def _walk(layout, jtree, path=""):
    """(JAX path, port leaf of ``jax_layout``, JAX leaf) of every leaf."""
    if isinstance(layout, dict):
        for k in layout:
            yield from _walk(layout[k], jtree[k], f"{path}/{k}")
    elif isinstance(layout, list):
        for i, v in enumerate(layout):
            yield from _walk(v, jtree[i], f"{path}/{i}")
    else:
        yield path, layout, jtree


_ABSTRACT = {}


def _abstract(arch):
    """(port config, port fake params, JAX abstract params), cached."""
    if arch not in _ABSTRACT:
        tcfg = TC.get_config(arch)
        _ABSTRACT[arch] = (tcfg, build_model(tcfg).init_abstract(),
                           jax_build(JC.get_config(arch)).init_abstract())
    return _ABSTRACT[arch]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", sorted(TC.ARCHS))
def test_param_specs_equal_jax(arch, mesh_kind, mode):
    mesh = MESHES[mesh_kind]
    tcfg, tparams, jparams = _abstract(arch)
    got = tsh.param_specs(tparams, mesh, mode, tcfg)
    want = jsh.param_specs(jparams, mesh, mode)
    jspecs = jax.tree.map(lambda s: s, want, is_leaf=lambda x: isinstance(
        x, JP))
    seen = set()
    for path, leaf, spec in _walk(jax_layout(tcfg, tparams), jspecs):
        spec = tuple(spec)
        if isinstance(leaf, tuple):          # stacked in JAX: lead dropped
            assert spec[0] is None, path
            for name in leaf:
                assert tuple(got[name]) == spec[1:], (path, name)
                seen.add(name)
        else:
            assert tuple(got[leaf]) == spec, path
            seen.add(leaf)
    assert seen == set(got) == {n for n, _ in tparams.named_parameters()}


def _spec_leaves(tree):
    if isinstance(tree, (tsh.P, JP)):
        return [tuple(tree)]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    return [s for v in tree for s in _spec_leaves(v)]


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", sorted(TC.ARCHS))
def test_cache_specs_equal_jax_at_decode_32k(arch, mesh_kind):
    mesh = MESHES[mesh_kind]
    sh = TC.SHAPES["decode_32k"]
    b, length = sh["global_batch"], sh["seq_len"]
    tcache = build_model(TC.get_config(arch)).abstract_cache(b, length)
    jcache = jax_build(JC.get_config(arch)).abstract_cache(b, length)
    got = _spec_leaves(tsh.cache_specs(tcache, mesh))
    want = _spec_leaves(jsh.cache_specs(jcache, mesh))
    assert got == want and len(got) == len(jax.tree.leaves(jcache))


@pytest.mark.parametrize("scheme", ["tp", "fsdp", "tokpar"])
@pytest.mark.parametrize("shape", [(256, 4096), (1, 524288), (32, 32768),
                                   (128,), (8, 12), ()])
def test_batch_spec_equals_jax(shape, scheme):
    for mesh in MESHES.values():
        got = tsh.batch_spec(mesh, "tokens", shape, scheme)
        assert tuple(got) == tuple(jsh.batch_spec(mesh, "tokens", shape,
                                                  scheme))
    multi = MESHES["multi"]
    if shape == (256, 4096):
        assert tsh.batch_spec(multi, "tokens", shape)[0] == ("pod", "data")
    if shape == (1, 524288):
        assert tsh.batch_spec(multi, "tokens", shape)[0] is None


def test_to_named_gives_jax_s_placements_on_a_fake_pod_mesh():
    from torch.distributed.tensor import Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        mesh = make_production_mesh(multi_pod=True)
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        R, S = Replicate(), Shard
        named = tsh.to_named({"a": tsh.P(("pod", "data"), "model"),
                              "b": tsh.P(None, "model"),
                              "c": tsh.P(None, ("pod", "data", "model")),
                              "d": tsh.P()}, mesh)
        assert named["a"].placements == (S(0), S(0), S(1))
        assert named["b"].placements == (R, R, S(1))
        assert named["c"].placements == (S(1), S(1), S(1))
        assert named["d"].placements == (R, R, R)
        assert named["a"].spec == tsh.P(("pod", "data"), "model")
        with pytest.raises(ValueError, match="mesh order"):
            tsh.to_named(tsh.P(("data", "pod")), mesh)
        with pytest.raises(ValueError, match="twice"):
            tsh.to_named(tsh.P("model", "model"), mesh)
        # a stacked leaf: the layer's placements behind an unsplit lead
        st = tsh.stacked([named["a"]] * 3)
        assert st.spec == tsh.P(None, ("pod", "data"), "model")
        assert st.placements == (S(1), S(1), S(2))
    finally:
        dist.destroy_process_group()


def test_host_mesh_starts_a_world_of_one_and_checks_model_parallel():
    from repro_torch.launch.mesh import make_host_mesh

    assert not dist.is_initialized()
    try:
        mesh = make_host_mesh(device_type="cpu")
        assert dist.get_world_size() == 1
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match="does not divide"):
            make_host_mesh(model_parallel=2, device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_hooks_are_no_ops_without_a_mesh():
    x = torch.ones(2, 3, 4, 5)
    assert tsh.activation_mesh() is None
    for kind in ("attn_q", "attn_kv", "hidden", "logits", "moe_dispatch4"):
        assert tsh.shard_activation(x, kind) is x
    assert tsh.fsdp_gather({"w": x})["w"] is x
    assert tsh.replicate_like(x, x) is x


# ----------------------------------------------------------------------------
# the static MoE dispatch
# ----------------------------------------------------------------------------
def _routing_case(case):
    """(config, router, x) of one routing case at olmoe's smoke width, as
    tests/test_torch_lm_families.py draws them."""
    import dataclasses as dc

    cfg = JC.get_config("olmoe-1b-7b").smoke()
    rng = np.random.default_rng(5)
    b, s = 2, 24
    router = rng.standard_normal((cfg.d_model, cfg.n_experts)).astype(
        np.float32) * cfg.d_model ** -0.5
    if case == "zero_router":
        router[:] = 0
    elif case == "duplicate_columns":
        router[:, 4:] = router[:, :4]
    elif case == "drops":
        b, s = 1, 2056
        cfg = dc.replace(cfg, top_k=2)
        router[0, 0] = 4.0
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    if case == "drops":
        x[..., 0] = np.abs(x[..., 0])
    return cfg, router, x


@pytest.mark.parametrize("case", ["random", "zero_router",
                                  "duplicate_columns", "drops"])
def test_static_moe_dispatch_equals_jax(case):
    cfg, router, x = _routing_case(case)
    tcfg = dataclasses.replace(TC.get_config("olmoe-1b-7b").smoke(),
                               top_k=cfg.top_k)
    p = {"router": router}
    rng = np.random.default_rng(6)
    for name, shape in (("wi", (cfg.n_experts, cfg.d_model, cfg.expert_ff)),
                        ("wg", (cfg.n_experts, cfg.d_model, cfg.expert_ff)),
                        ("wo", (cfg.n_experts, cfg.expert_ff, cfg.d_model))):
        p[name] = (rng.standard_normal(shape) * shape[1] ** -0.5).astype(
            np.float32)
    jy, jaux = jmoe.apply_moe(cfg, {k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    ty, taux = tmoe.apply_moe_static(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-4)
    # the buffer is JAX's [B, E, cap, d], and the loop gives the same layer
    cap = tmoe.capacity(tcfg, x.shape[1])
    r = tmoe.route(tcfg, tp["router"], torch.from_numpy(x), cap)
    xin = tmoe.dispatch(tcfg, r, torch.from_numpy(x), cap)
    assert tuple(xin.shape) == (x.shape[0], cfg.n_experts, cap, cfg.d_model)
    ly, _ = tmoe.apply_moe(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), ly.numpy(), rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------------
# real collectives: four gloo processes on one FileStore
# ----------------------------------------------------------------------------
_WORKER = textwrap.dedent('''
    import dataclasses, json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.collectives import psum_hierarchical
    from repro_torch.runtime.train_loop import (
        TrainLoopConfig, distribute_params, meta_stack, train,
        train_shardings, train_tree, train_tree_shardings)

    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "store"), world), rank=rank, world_size=world)
    out = {}
    try:
        mesh = make_host_mesh(model_parallel=2, device_type="cpu")
        cfg = get_config("olmo-1b").smoke()
        model = build_model(cfg)

        def params():
            return model.init(torch.Generator("cpu").manual_seed(3))

        def loop(name):
            return TrainLoopConfig(total_steps=2, checkpoint_every=100,
                                   log_every=1, lr=1e-3,
                                   checkpoint_dir=os.path.join(tmp, name))

        data = SyntheticLMData(cfg.vocab)
        p0, o0, h0 = train(model, data, batch_size=4, seq_len=16,
                           cfg=loop(f"plain{rank}"), params=params(),
                           log=lambda *a: None)
        p1, o1, h1 = train(model, data, batch_size=4, seq_len=16,
                           cfg=loop("mesh"), params=params(), mesh=mesh,
                           log=lambda *a: None)
        out["loss"] = [[l for _, l, _ in h0], [l for _, l, _ in h1]]
        # every leaf of the params and of both moments, meshed against
        # plain: [name, max |difference|, max |plain|]. AdamW's update
        # does not see a gradient scaled by a constant, but the moments
        # do (nu = g * g)
        out["leaf_err"] = []
        out["n_params"] = len(list(p0.parameters()))
        for kind, plain, meshed in (
                ("param", dict(p0.named_parameters()),
                 dict(p1.named_parameters())),
                ("mu", o0.mu, o1.mu), ("nu", o0.nu, o1.nu)):
            for n, want in plain.items():
                want = want.detach()
                got = meshed[n].full_tensor().detach()
                out["leaf_err"].append([f"{kind} {n}",
                                        float((got - want).abs().max()),
                                        float(want.abs().max())])
        out["split"] = sum(p.to_local().shape != p.shape
                           for p in p1.parameters())
        out["moments_placed"] = all(
            tuple(o1.mu[n].placements) == tuple(p.placements)
            for n, p in p1.named_parameters())

        # meshed decode steps against plain ones: KV heads split over
        # "model" (4 heads), and the length split (one head: MQA)
        tok = torch.randint(0, cfg.vocab, (4, 8),
                            generator=torch.Generator().manual_seed(5))
        out["decode_err"], out["cache_err"] = [], []
        for kv in (4, 1, "ssm"):
            m = build_model(get_config("mamba2-780m").smoke() if kv == "ssm"
                            else dataclasses.replace(cfg, n_kv=kv))
            with torch.no_grad():
                plain = m.init(torch.Generator("cpu").manual_seed(3))
                _, c0 = m.prefill(plain, {"tokens": tok})
                # cache_from_prefill passes SSD states through, and decode
                # writes caches in place: each run gets its own copy
                def fresh():
                    return m.cache_from_prefill(
                        sh.tree_map(torch.clone, c0), 12)

                want, cw = m.decode_step(plain, fresh(), tok[:, -1], 8)
                meshed = m.init(torch.Generator("cpu").manual_seed(3))
                distribute_params(meshed, sh.to_named(
                    sh.param_specs(meshed, mesh, "serve", m.cfg), mesh))
                # JAX's cache_specs takes a 5-D f32 entry for an SSM state,
                # so the f32 smoke attention caches get the attention rule
                cg = fresh()
                specs = (sh.cache_specs(cg, mesh) if kv == "ssm" else
                         sh.tree_map(lambda t: sh.cache_entry_spec(
                             mesh, tuple(t.shape), "attn"), cg))
                cg = sh.distribute_tree(cg, sh.to_named(specs, mesh))
                tokd = sh.distribute(tok[:, -1], sh.to_named(
                    sh.batch_spec(mesh, "tokens", (4,)), mesh))
                sh.set_activation_mesh(mesh)
                try:
                    got, cg = m.decode_step(meshed, cg, tokd, 8)
                finally:
                    sh.set_activation_mesh(None)
            out["decode_err"].append(float(
                (got.full_tensor() - want).abs().max() / want.abs().max()))
            gl = torch.utils._pytree.tree_leaves(cg)
            out["cache_err"].append(max(
                float((a.full_tensor() - b).abs().max())
                for a, b in zip(gl, torch.utils._pytree.tree_leaves(cw))))
            out.setdefault("cache_layouts", []).append(
                [str(p) for p in gl[0].placements])

        x = torch.full((3,), float(rank + 1))
        out["psum"] = psum_hierarchical(x, mesh=mesh, fast_axes=("model",),
                                        slow_axes=("data",)).tolist()

        # JAX's checkpoint restored onto the mesh
        shard = train_shardings(cfg, p1, mesh)
        opt = AdamWState(step=torch.zeros((), dtype=torch.int32),
                         mu=dict(o1.mu), nu=dict(o1.nu))
        template = train_tree(cfg, p1, opt, stack=meta_stack)
        tree, manifest = Checkpointer(os.path.join(tmp, "jax")).restore(
            template, shardings=train_tree_shardings(cfg, p1, shard),
            device="cpu")
        leaves = torch.utils._pytree.tree_leaves(tree)
        step_dir = os.path.join(tmp, "jax", f"step_{manifest['step']:09d}")
        same = []
        for i, t in enumerate(leaves):
            arr = np.load(os.path.join(step_dir, f"leaf_{i:06d}.npy"))
            full = t.full_tensor() if hasattr(t, "full_tensor") else t
            same.append(full.numpy().tobytes() == arr.tobytes())
        out["restore_same"] = same
        out["restore_split"] = sum(
            1 for t in leaves if hasattr(t, "to_local")
            and t.to_local().shape != t.shape)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(tmp, "out.json"), "w") as f:
            json.dump(out, f)
''')


def test_two_by_two_gloo_mesh_trains_decodes_sums_and_restores(tmp_path):
    # JAX writes the f32 checkpoint the processes restore
    jcfg = JC.get_config("olmo-1b").smoke()
    jp = jax_build(jcfg).init(jax.random.PRNGKey(7))
    js = jadamw.init(jp)
    js = js._replace(mu=jax.tree.map(lambda a: a + 0.5, js.mu))
    ck = JCheckpointer(str(tmp_path / "jax"))
    ck.save(3, (jp, js), blocking=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), "4",
                               str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(4)]
    errs = [p.communicate(timeout=240)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(errs)[-4000:]
    out = json.loads((tmp_path / "out.json").read_text())
    np.testing.assert_allclose(out["loss"][1], out["loss"][0], rtol=1e-5)
    # each leaf of mu and nu within 1e-5 of its own max (a gradient that
    # comes back scaled shows here, not in the params); each param leaf
    # within 1e-5: where a first gradient is near AdamW's eps (1e-8) its
    # update is lr * g / eps, which turns f32 noise of 3e-11 in g into
    # 3e-6 in one element of the embedding
    bad = [e for e in out["leaf_err"] if e[1] > 1e-5 * (
        1.0 if e[0].startswith("param ") else e[2])]
    assert not bad, bad
    assert len(out["leaf_err"]) == 3 * out["n_params"] > 0
    assert out["split"] > 0 and out["moments_placed"]
    assert max(out["decode_err"]) <= 1e-5, out
    assert max(out["cache_err"]) <= 1e-5, out
    # four KV heads split over "model"; one head: the length split; the
    # SSD states by head
    assert out["cache_layouts"][0][1] == "S(3)"
    assert out["cache_layouts"][1][1] == "S(2)"
    assert out["cache_layouts"][2][1] == "S(2)"
    assert out["psum"] == [10.0, 10.0, 10.0]
    assert all(out["restore_same"]) and out["restore_split"] > 0
    assert len(out["restore_same"]) == len(jax.tree.leaves((jp, js)))
