"""Multi-pod dry run on fake ranks: trace one step of every (arch x shape x
mesh) cell; the port of ``repro.launch.dryrun``.

JAX lowers and compiles each cell against abstract inputs on 256 or 512
forced host devices and reads the executable's analyses. The port runs the
cell's step once, eagerly, on fake DTensors: a "fake" process group of
256 or 512 ranks (this process is rank 0, and a collective moves nothing),
a ``DeviceMesh`` from ``launch.mesh.make_production_mesh``, and every
tensor a ``FakeTensorMode`` tensor, so nothing is allocated on any device
and no card is needed. What rank 0 does is recorded, per device:

  * memory       ``argument_bytes`` (the local blocks of params, optimizer
                 state, caches and batch), ``output_bytes`` (those of the
                 step's outputs), ``alias_bytes`` (outputs written in place
                 over an argument, the port's donation) and ``temp_bytes``
                 (the peak of live fake storage the step allocates, less
                 the outputs it allocates);
  * cost         ``flops`` of the matmul-class ops (the ops
                 ``torch.utils.flop_counter`` counts; XLA also counts
                 elementwise ops) and ``bytes accessed`` (each op's inputs
                 and outputs, views excluded), both on the LOCAL blocks: a
                 ``TorchDispatchMode`` that lets DTensor desugar each op
                 first, so it sees the per-rank op and its collectives
                 (``FlopCounterMode`` around DTensor code counts the global
                 product);
  * collectives  bytes per kind from the ``_c10d_functional`` ops, by
                 JAX's rule (``collective_bytes``).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  python -m repro_torch.launch.dryrun --cells all --mesh both --out dry.jsonl
  python -m repro_torch.launch.dryrun --cells all --subprocess  # 1 proc/cell

Unlike JAX's module, this one sets no environment variable and starts no
process group at import: ``run_cell`` makes the fake group and destroys it
before it returns, leaving the process as it found it.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_for
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWState
from repro_torch.parallel import sharding

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _tensors(tree) -> list:
    """The tensors of a tree; a module counts its parameters."""
    leaves = pytree.tree_leaves(tree, is_leaf=lambda x: isinstance(
        x, torch.nn.Module))
    out = []
    for x in leaves:
        if isinstance(x, torch.nn.Module):
            out.extend(x.parameters())
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def collective_bytes(events) -> dict:
    """Per-kind per-device traffic of (kind, result bytes, group size)
    events, by JAX's rule: the result's size for all-gather / all-reduce /
    all-to-all / collective-permute (ring traffic is ~ (n-1)/n of it: this
    is the upper bound), result x group size for reduce-scatter (its
    operand is the large tensor)."""
    out = {k: 0 for k in KINDS}
    out["count"] = 0
    for kind, nbytes, group in events:
        out[kind] += nbytes * (group if kind == "reduce-scatter" else 1)
        out["count"] += 1
    return out


def _in_sharding_propagation() -> bool:
    """Whether the op runs inside DTensor's sharding propagation, which
    runs ops on whole-size fake tensors to learn an output's metadata:
    no rank runs them."""
    f = sys._getframe(2)
    for _ in range(12):
        if f is None:
            return False
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


class Accounting(TorchDispatchMode):
    """Counts what one rank runs under it: matmul FLOPs and bytes accessed
    of the local ops, collective events, and the live bytes of the
    storages the ops allocate (freed when the storage dies). An op with a
    DTensor operand is handed back (NotImplemented) so that DTensor turns
    it into local ops and collectives, which come through here."""

    def __init__(self, known=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flops = flop_registry
        self.known = set(known)       # storages that predate the step
        self.flops = 0
        self.bytes_accessed = 0
        self.events = []
        self.live = 0
        self.peak = 0
        self.new = {}                 # storage key -> bytes, while live

    def _free(self, key, nbytes):
        if self.new.pop(key, None) is not None:
            self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _in_sharding_propagation():
            return out          # DTensor inferring an output's global shape
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        packet = func._overloadpacket
        if func.namespace == "_c10d_functional":
            kind = _COLLECTIVES.get(packet.__name__)
            if kind is not None:
                group = args[2] if kind == "reduce-scatter" else 1
                self.events.append((kind, sum(map(_nbytes, outs)),
                                    int(group)))
        elif packet in self._flops:
            self.flops += int(self._flops[packet](*args, **kwargs,
                                                  out_val=out))
        if not func.is_view:
            self.bytes_accessed += sum(map(_nbytes, ins + outs))
        seen = {_storage_key(t) for t in ins} | self.known
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self.new:
                continue
            self.new[key] = st.nbytes()
            self.live += st.nbytes()
            weakref.finalize(st, self._free, key, st.nbytes())
        self.peak = max(self.peak, self.live)
        return out


def _place(tree, specs, mesh):
    """Every tensor of ``tree`` as a DTensor on its spec in ``specs``."""
    return sharding.distribute_tree(tree, sharding.to_named(specs, mesh))


def _inputs(specs: dict, mesh, scheme: str) -> dict:
    """Fake zero inputs of ``input_specs``, placed by ``batch_specs``."""
    batch = {k: torch.zeros(v.shape, dtype=v.dtype)
             for k, v in specs.items() if v.shape}
    return _place(batch, sharding.batch_specs(batch, mesh, scheme), mesh)


def _modes(layout: str) -> tuple:
    """(train param mode, serve param mode, activation scheme)."""
    return ({"auto": "train", "tp": "train", "fsdp": "fsdp",
             "tokpar": "replicated", "zero1": "replicated"}[layout],
            {"auto": "serve", "tp": "serve", "fsdp": "fsdp",
             "tokpar": "replicated", "zero1": "replicated"}[layout],
            {"auto": "tp", "tp": "tp", "fsdp": "fsdp", "tokpar": "tokpar",
             "zero1": "fsdp"}[layout])


def build_cell(arch: str, shape: str, mesh, *, microbatches: int = 1,
               layout: str = "auto", decode_unroll: bool = False,
               mode=None):
    """Returns (step_fn, in_shardings, args, donate_argnums,
    out_shardings), as JAX's does, with ``args`` the step's arguments as
    fake DTensors of ``mode`` (a ``FakeTensorMode``) placed on
    ``in_shardings``. Call it inside ``mode``.

    ``layout``: "auto" (train: fsdp x tp; serve: tp) | "tp" | "fsdp" (ZeRO
    over all axes, no TP) | "tokpar" (replicated weights, batch x sequence
    parallelism) | "zero1" (replicated params, sharded moments). The
    port's decode step is always a Python loop over the layers, so
    ``decode_unroll`` changes nothing and is recorded."""
    from repro_torch.runtime.train_loop import distribute_params

    cfg = get_config(arch)
    model = build_model(cfg)
    kind = shape_for(shape)["kind"]
    params = model.init_abstract(mode)
    train_mode, serve_mode, scheme = _modes(layout)

    if kind == "train":
        pspecs = sharding.param_specs(params, mesh, train_mode, cfg)
        named = sharding.to_named(pspecs, mesh)
        distribute_params(params, named)
        mspecs = (sharding.param_specs(params, mesh, "fsdp", cfg)
                  if layout == "zero1" else pspecs)
        mnamed = sharding.to_named(mspecs, mesh)

        def moments():
            return {n: sharding.distribute(
                torch.zeros(p.shape, dtype=torch.float32), mnamed[n])
                for n, p in params.named_parameters()}

        opt = AdamWState(step=torch.zeros((), dtype=torch.int32),
                         mu=moments(), nu=moments())
        ospecs = AdamWState(step=sharding.P(), mu=mspecs, nu=mspecs)
        batch = _inputs(model.input_specs(shape), mesh, scheme)
        bspecs = sharding.batch_specs(batch, mesh, scheme)
        step = steps_mod.make_train_step(model, microbatches=microbatches,
                                         grad_specs=named)
        out_shard = (pspecs, ospecs, {"loss": sharding.P(),
                                      "aux": sharding.P()})
        return (step, (pspecs, ospecs, bspecs), (params, opt, batch),
                (0, 1), out_shard)

    pspecs = sharding.param_specs(params, mesh, serve_mode, cfg)
    distribute_params(params, sharding.to_named(pspecs, mesh))
    if kind == "prefill":
        batch = _inputs(model.input_specs(shape), mesh, scheme)
        bspecs = sharding.batch_specs(batch, mesh, scheme)
        prefill = steps_mod.make_prefill_step(model)

        def step(params, batch):
            with torch.no_grad():
                return prefill(params, batch)

        return (step, (pspecs, bspecs), (params, batch), (), None)

    # decode: one new token against a cache of the shape's length
    sh = shape_for(shape)
    cache = model.abstract_cache(sh["global_batch"], sh["seq_len"], mode)
    cspecs = sharding.cache_specs(cache, mesh)
    cache = _place(cache, cspecs, mesh)
    specs = model.input_specs(shape)
    tokens = _inputs({"tokens": specs["tokens"]}, mesh, "tp")["tokens"]
    decode = steps_mod.make_decode_step(model)

    def step(params, caches, tokens, pos):
        with torch.no_grad():
            return decode(params, caches, tokens, pos)

    tspec = sharding.batch_spec(mesh, "tokens", tuple(tokens.shape))
    logits_spec = sharding.batch_spec(mesh, "logits",
                                      (tokens.shape[0], cfg.vocab))
    return (step, (pspecs, cspecs, tspec, sharding.P()),
            (params, cache, tokens, sh["seq_len"] - 1), (1,),
            (logits_spec, cspecs))


def auto_microbatches(arch: str, shape: str, mesh) -> int:
    """Grad-accumulation factor keeping per-device live activations
    bounded: split until tokens_local x d_model <= 48M elements (~0.2 GB
    bf16 residual per layer plus working set under full remat)."""
    cfg = get_config(arch)
    sh = shape_for(shape)
    if sh["kind"] != "train":
        return 1
    da = sharding.axis_size(mesh, sharding.data_axes(mesh))
    b_local = max(1, sh["global_batch"] // da)
    tokens_local = b_local * sh["seq_len"]
    # enc-dec archs also hold encoder activations whose attention cannot
    # shard on this mesh (frames=1500, heads=8 vs TP=16): weight them in
    if cfg.enc_layers:
        tokens_local += b_local * cfg.enc_frames * max(1, cfg.enc_frames
                                                       // 256)
    mb = 1
    while tokens_local // mb * cfg.d_model > 48_000_000 and mb < min(
            32, b_local):
        mb *= 2
    return mb


def _memory(args, outs) -> dict:
    arg_t = [_local(t) for t in _tensors(args)]
    out_t = [_local(t) for t in _tensors(outs)]
    arg_keys = {_storage_key(t) for t in arg_t}
    return {
        "argument_bytes": sum(map(_nbytes, arg_t)),
        "output_bytes": sum(map(_nbytes, out_t)),
        "alias_bytes": sum(_nbytes(t) for t in out_t
                           if _storage_key(t) in arg_keys),
    }


def run_cell(arch: str, shape: str, mesh_kind: str, *, microbatches=1,
             layout: str = "auto", decode_unroll: bool = False) -> dict:
    """One cell's record: JAX's keys, with ``trace_s`` (building the fake
    arguments and running the step on them) where JAX has ``lower_s`` and
    ``compile_s``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "ok": False,
           "layout": layout, "decode_unroll": decode_unroll}
    cfg = get_config(arch)
    if shape in cfg.skip_shapes:
        rec.update(skipped=True,
                   reason="full attention excludes long-context decode")
        return rec
    t0 = time.time()
    if dist.is_initialized():
        raise RuntimeError("run_cell makes its own fake process group; "
                           "one is already initialized")
    try:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=512 if mesh_kind == "multi"
                                else 256)
        try:
            mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
            sharding.set_activation_mesh(mesh, _modes(layout)[2])
            if microbatches == 0:  # auto
                microbatches = auto_microbatches(arch, shape, mesh)
            with FakeTensorMode() as fake:
                step, _, args, _, _ = build_cell(
                    arch, shape, mesh, microbatches=microbatches,
                    layout=layout, decode_unroll=decode_unroll, mode=fake)
                known = {_storage_key(_local(t)) for t in _tensors(args)}
                acct = Accounting(known)
                with acct:
                    outs = step(*args)
                mem = _memory(args, outs)
                mem["temp_bytes"] = max(0, acct.peak - sum(
                    n for k, n in acct.new.items()
                    if k in {_storage_key(_local(t))
                             for t in _tensors(outs)}))
            rec.update(
                ok=True,
                devices=int(math.prod(mesh.shape)),
                trace_s=round(time.time() - t0, 2),
                memory=mem,
                cost={"flops": float(acct.flops),
                      "bytes accessed": float(acct.bytes_accessed)},
                collectives=collective_bytes(acct.events),
                microbatches=microbatches,
            )
            del outs, args, step
        finally:
            sharding.set_activation_mesh(None)
            dist.destroy_process_group()
    except Exception as e:
        rec.update(error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--cells", default=None,
                    help="'all' or comma list arch:shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--layout", default="auto",
                    choices=["auto", "tp", "fsdp", "tokpar", "zero1"])
    ap.add_argument("--decode-unroll", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--subprocess", action="store_true",
                    help="run each cell in a fresh process (bounded memory)")
    args = ap.parse_args(argv)

    cells = []
    if args.cells == "all":
        cells = [(arch, shape) for arch in ARCHS for shape in SHAPES]
    elif args.cells:
        cells = [tuple(c.split(":")) for c in args.cells.split(",")]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --cells")
        cells.append((args.arch, args.shape))

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    outf = open(args.out, "a") if args.out else None
    for arch, shape in cells:
        for mk in meshes:
            if args.subprocess:
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--mesh", mk,
                       "--microbatches", str(args.microbatches),
                       "--layout", args.layout]
                if args.decode_unroll:
                    cmd += ["--decode-unroll"]
                if args.out:
                    cmd += ["--out", args.out]
                r = subprocess.run(cmd, capture_output=True, text=True)
                tail = (r.stdout.strip() or r.stderr.strip()).splitlines(
                )[-1:]
                print(f"[{arch} x {shape} x {mk}] rc={r.returncode} {tail}",
                      flush=True)
                continue
            rec = run_cell(arch, shape, mk, microbatches=args.microbatches,
                           layout=args.layout,
                           decode_unroll=args.decode_unroll)
            line = json.dumps(rec)
            print(line[:400], flush=True)
            if outf:
                outf.write(line + "\n")
                outf.flush()
    if outf:
        outf.close()


if __name__ == "__main__":
    main()
