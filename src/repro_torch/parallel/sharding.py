"""Sharding rules: the port of ``repro.parallel.sharding``, in two halves.

The LM half (below the graph half) is JAX's GSPMD rule set: FSDP x TP for
training, TP + batch-DP for serving, path + shape based with divisibility
fallbacks, so one rule set covers all ten architectures. The rules are
functions on shapes that return a ``P`` (JAX's ``PartitionSpec``);
``to_named`` turns them into ``torch.distributed.tensor`` placements on a
``DeviceMesh`` (each mesh axis an entry names gives ``Shard(d)``, every
other mesh dim ``Replicate()``), as JAX keeps ``param_spec`` apart from
``NamedSharding``. A layer's spec is that of JAX's leaf stacked over its
group without the lead, found through ``convert.jax_layout``. Multi-pod
meshes contribute their "pod" axis to the data axes, so FSDP and batch
sharding span pods while TP stays inside a pod.

The graph half (DESIGN.md §8) places the graph state on the port's
single-controller mesh: one Python thread holds a
``core.distributed.GraphMesh``, a tuple of S ``torch.device``s (a device
may repeat, so S row blocks can share one card). A ``Placement`` says how
one field is laid out over it:

  * replicated (``axis`` None): one copy of the whole tensor per distinct
    device of the mesh;
  * row-sharded (``axis`` = ``GRAPH_ROW_AXIS``): S contiguous row blocks of
    equal size, block s on ``mesh.devices[s]``.

The word-packed adjacencies, the only O(V^2/32) arrays, are row-sharded:
shard s owns the out-edge rows of its slot block in ``adj_packed`` and the
in-edge rows of the same block in ``adj_in_packed`` (the column-sharded
in-row layout the hybrid pull runs shard-local over). The O(V) version
metadata (vkey/valive/vver/ecnt) is replicated, so lookups, the
double-collect validation vector and the lane-order mutation schedule need
no communication.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

GRAPH_ROW_AXIS = "rows"


class Placement(NamedTuple):
    """How one field is laid out: ``axis`` None is replicated, otherwise
    rows are split over that mesh axis; ``mesh`` is None in a spec and set
    in a sharding bound to a concrete mesh."""

    axis: str | None = None
    mesh: object = None

    @property
    def replicated(self) -> bool:
        return self.axis is None


def graph_state_specs(axis: str = GRAPH_ROW_AXIS) -> dict:
    """Placements of the six graph-state fields, without a mesh."""
    rep = Placement(None)
    rows = Placement(axis)
    return {"vkey": rep, "valive": rep, "vver": rep, "ecnt": rep,
            "adj_packed": rows, "adj_in_packed": rows}


def graph_state_shardings(mesh, axis: str = GRAPH_ROW_AXIS) -> dict:
    """``graph_state_specs`` bound to a concrete mesh."""
    return {k: p._replace(mesh=mesh)
            for k, p in graph_state_specs(axis).items()}


def place(x: torch.Tensor, placement: Placement):
    """Copy ``x`` onto its placement's mesh: a replicated field gives a
    dict {device: copy} over the mesh's distinct devices, a row-sharded
    one a tuple of S contiguous row blocks, block s on device s. Raises
    ``ValueError`` when S does not divide the rows."""
    mesh = placement.mesh
    if placement.replicated:
        return {d: x.to(d, copy=True) for d in mesh.distinct_devices}
    size = mesh.shape[placement.axis]
    rows = x.shape[0]
    if rows % size:
        raise ValueError(
            f"capacity {rows} not divisible by mesh axis {size}")
    per = rows // size
    return tuple(x[s * per:(s + 1) * per].to(d, copy=True).contiguous()
                 for s, d in enumerate(mesh.devices))


# ----------------------------------------------------------------------------
# LM sharding rules: FSDP x TP for training, TP + batch-DP for serving
# ----------------------------------------------------------------------------
# JAX's, function for function; no rule makes an uneven shard. A spec has
# one entry per tensor dim: None (not split), a mesh axis name, or a tuple
# of axis names (split over their product, in mesh order). The spec
# functions take any mesh with named axes of known sizes (a ``DeviceMesh``,
# or a shape-only stand-in).


class P(tuple):
    """A partition spec: ``P("data", None)``, JAX's ``PartitionSpec``; as
    there, an entry of one axis is that axis (``("data",)`` is "data")."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"P{tuple(self)!r}"


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (``mesh_dim_names``) or of a
    stand-in with a ``shape`` dict and ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def data_axes(mesh) -> tuple:
    axes = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in axes)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_axes(mesh)
    return int(np.prod([sizes[a] for a in axes]))


def _fits(mesh, dim, axes) -> bool:
    return dim % axis_size(mesh, axes) == 0


def _pick(mesh, dim, *candidates):
    """First candidate axis (or axis tuple) that divides ``dim``; else None."""
    for c in candidates:
        if c is None:
            return None
        if _fits(mesh, dim, c):
            return c
    return None


def param_spec(mesh, mode: str, path: str, shape: tuple) -> P:
    """Spec of one parameter leaf of the JAX package's tree, at its JAX
    ``path`` ("trunk/stacks/0/0/attn/wq") and JAX ``shape`` (a stacked
    leaf with its leading group axis, which the spec leaves unsplit).

    Modes: "train" FSDP x TP | "serve" TP only | "fsdp" ZeRO over ALL
    axes, no TP | "replicated" no weight sharding."""
    if mode == "fsdp":
        da = data_axes(mesh) + ("model",)
        md = None
    elif mode == "replicated":
        da, md = None, None
    else:
        da = data_axes(mesh) if mode == "train" else None
        md = "model"
    name = path.split("/")[-1]
    stacked = ("stacks/" in path or path.startswith(("enc/", "dec/"))
               or "/enc/" in path or "/dec/" in path)
    lead = (None,) if stacked else ()
    dims = shape[len(lead):]

    def spec(*entries):
        return P(*(lead + tuple(entries)))

    if len(dims) <= 1:
        return spec(*([None] * len(dims)))  # norms/biases/scalars: replicate

    # --- embeddings ---------------------------------------------------------
    if name == "tok":                      # [V, d]
        return spec(_pick(mesh, dims[0], md), _pick(mesh, dims[1], da))
    if name == "unembed":                  # [d, V]
        return spec(_pick(mesh, dims[0], da), _pick(mesh, dims[1], md))

    # --- MoE ----------------------------------------------------------------
    if name == "router":                   # [d, E]
        return spec(_pick(mesh, dims[0], da), None)
    if name in ("wi", "wg", "wo") and len(dims) == 3:  # experts [E, a, b]
        if _fits(mesh, dims[0], md):       # expert parallelism
            if name == "wo":               # [E, f, d]
                return spec(md, None, _pick(mesh, dims[2], da))
            return spec(md, _pick(mesh, dims[1], da), None)
        # TP inside experts on the ffn dim
        if name == "wo":
            return spec(None, _pick(mesh, dims[1], md),
                        _pick(mesh, dims[2], da))
        return spec(None, _pick(mesh, dims[1], da), _pick(mesh, dims[2], md))

    # --- attention / mlp / ssm / lru projections (2-D) ----------------------
    if name in ("wq", "wk", "wv", "wi", "wg", "in_proj", "in_x", "in_g",
                "w_a", "w_i"):
        return spec(_pick(mesh, dims[0], da), _pick(mesh, dims[1], md))
    if name in ("wo", "out_proj", "out"):
        return spec(_pick(mesh, dims[0], md), _pick(mesh, dims[1], da))
    if name == "conv_w":                   # [K, din]
        return spec(_pick(mesh, dims[0], None),
                    _pick(mesh, dims[1], md or da))
    if len(dims) == 2:                     # default 2-D
        return spec(_pick(mesh, dims[0], da), _pick(mesh, dims[1], md))
    return spec(*([None] * len(dims)))


def _walk_layout(layout, path=()):
    """(JAX path, leaf) of every leaf of ``convert.jax_layout``'s tree."""
    if isinstance(layout, dict):
        for k, v in layout.items():
            yield from _walk_layout(v, path + (str(k),))
    elif isinstance(layout, list):
        for i, v in enumerate(layout):
            yield from _walk_layout(v, path + (str(i),))
    else:
        yield "/".join(path), layout


def param_specs(params, mesh, mode: str, cfg) -> dict:
    """{parameter name: P} of the port's params (an ``nn.Module`` of
    ``cfg``'s model, its tensors real or fake). A layer's tensor takes the
    spec of the JAX leaf stacked over its group, without the leading group
    entry, found under JAX's path through ``convert.jax_layout``."""
    from repro_torch.convert import jax_layout

    shapes = {n: tuple(p.shape) for n, p in params.named_parameters()}
    out = {}
    for path, leaf in _walk_layout(jax_layout(cfg, params)):
        names = leaf if isinstance(leaf, tuple) else (leaf,)
        shape = shapes[names[0]]
        if isinstance(leaf, tuple):
            s = param_spec(mesh, mode, path, (len(names),) + shape)[1:]
        else:
            s = param_spec(mesh, mode, path, shape)
        for n in names:
            out[n] = P(*s)
    return out


def batch_spec(mesh, name: str, shape: tuple, scheme: str = "tp") -> P:
    da = data_axes(mesh)
    if scheme == "fsdp":
        da = da + ("model",)
    if len(shape) == 0:
        return P()
    lead = _pick(mesh, shape[0], da)
    rest = [None] * (len(shape) - 1)
    if (scheme == "tokpar" and len(shape) >= 2
            and _fits(mesh, shape[1], "model")):
        rest[0] = "model"     # sequence dim carries the model axis
    return P(lead, *rest)


def batch_specs(specs: dict, mesh, scheme: str = "tp") -> dict:
    """{name: P} of a batch (tensors or ``input_specs`` stand-ins)."""
    return {k: batch_spec(mesh, k, tuple(v.shape), scheme)
            for k, v in specs.items()}


def cache_entry_spec(mesh, shape: tuple, kind: str) -> P:
    """Decode-cache sharding. Attention kv: [G, B, L, KV, hd]; ssm state:
    [G, B, H, N, hd]; conv: [G, B, K-1, D]; rec h: [G, B, D]."""
    da = data_axes(mesh)
    md = "model"
    dims = list(shape)
    n = len(dims)
    if n == 5 and kind == "attn":          # [G, B, L, KV, hd]
        bspec = _pick(mesh, dims[1], da)
        kvspec = _pick(mesh, dims[3], md)
        if kvspec is not None:
            return P(None, bspec, None, kvspec, None)
        # kv heads indivisible: shard the LENGTH axis (flash-decoding:
        # local partial softmax, then a small sum over "model")
        lspec = _pick(mesh, dims[2], md)
        if lspec is not None:
            return P(None, bspec, lspec, None, None)
        return P(None, bspec, None, None, _pick(mesh, dims[4], md))
    if n == 5:                              # ssm state [G, B, H, N, hd]
        return P(None, _pick(mesh, dims[1], da), _pick(mesh, dims[2], md),
                 None, None)
    if n == 4:                              # conv cache [G, B, K-1, D]
        return P(None, _pick(mesh, dims[1], da), None,
                 _pick(mesh, dims[3], md))
    if n == 3:                              # rec h [G, B, D]
        return P(None, _pick(mesh, dims[1], da), _pick(mesh, dims[2], md))
    return P(*([None] * n))


def cache_specs(caches, mesh):
    """Specs of the decode caches ``Model.init_cache`` (or
    ``abstract_cache``) builds, in their structure. The port's caches are
    JAX's: [G, ...] stacked over each stack's groups. A 5-D f32 entry is an
    ssm state, any other 5-D entry attention k/v."""
    def leaf_spec(t):
        if t.ndim == 5 and t.dtype == torch.float32:
            return cache_entry_spec(mesh, tuple(t.shape), "ssm")
        return cache_entry_spec(mesh, tuple(t.shape),
                                "attn" if t.ndim == 5 else "other")

    return tree_map(leaf_spec, caches)


def tree_map(fn, tree, is_leaf=lambda x: isinstance(x, torch.Tensor)):
    """``fn`` over the leaves of nested dicts, lists, tuples and
    NamedTuples; a ``P`` is always a leaf."""
    if isinstance(tree, P) or is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, is_leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


class NamedSharding(NamedTuple):
    """A spec bound to a ``DeviceMesh``: the DTensor ``placements`` (one
    per mesh dim) that lay a tensor out as ``spec`` says."""

    mesh: object
    spec: P
    placements: tuple


def stacked(shardings) -> NamedSharding:
    """The sharding of JAX's leaf stacked over layers whose shardings are
    ``shardings`` (all alike): the layer spec behind an unsplit lead."""
    s = shardings[0]
    return NamedSharding(s.mesh, P(None, *s.spec), tuple(
        Shard(p.dim + 1) if isinstance(p, Shard) else p
        for p in s.placements))


def placements(spec: P, mesh, ndim: int | None = None) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: each mesh axis an entry
    names gives ``Shard(d)`` on that mesh dim, every other mesh dim
    ``Replicate()``. A tuple entry splits its dim over several mesh dims;
    DTensor splits in mesh-dim order, so the entry must list its axes in
    that order (JAX's rules always do), else this raises."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    entries = tuple(spec) + (None,) * ((ndim or len(spec)) - len(spec))
    for d, e in enumerate(entries):
        if e is None:
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {e} is not in mesh order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]} used twice in {spec}")
            out[i] = Shard(d)
    return tuple(out)


def to_named(tree_specs, mesh):
    """Every ``P`` of a tree of specs as a ``NamedSharding`` on ``mesh``."""
    return tree_map(lambda s: NamedSharding(mesh, s, placements(s, mesh)),
                    tree_specs, is_leaf=lambda x: False)


def mesh_device(mesh) -> torch.device:
    """The device a mesh's local blocks live on in this process."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_block(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``sharding``:
    each ``Shard(d)`` cuts dim d into the mesh dim's ``torch.chunk``
    pieces and keeps this rank's, mesh dims in order (DTensor's layout).
    Worked out on the host from the mesh coordinate: torch's own helper
    computes offsets in tensors, which a fake tensor mode cannot read."""
    mesh = sharding.mesh
    coord = mesh.get_coordinate()
    start, size = [0] * x.ndim, list(x.shape)
    for i, pl in enumerate(sharding.placements):
        if isinstance(pl, Shard):
            d = pl.dim
            chunk = -(-size[d] // mesh.size(i))
            lo = min(coord[i] * chunk, size[d])
            start[d] += lo
            size[d] = min(chunk, size[d] - lo)
    return x[tuple(slice(o, o + n) for o, n in zip(start, size))]


def distribute(x: torch.Tensor, sharding: NamedSharding):
    """``x`` laid out on its sharding's mesh: a DTensor whose local tensor
    is this rank's block of ``x``, cut where ``x`` lies and then moved to
    the mesh's device (every rank passes the whole tensor; no
    communication). A block that already lies there contiguous is kept,
    not copied."""
    local = local_block(x, sharding).to(mesh_device(sharding.mesh))
    return DTensor.from_local(local.contiguous(), sharding.mesh,
                              sharding.placements, run_check=False,
                              shape=x.shape, stride=_contiguous(x.shape))


def distribute_tree(tree, shardings):
    """Every tensor of ``tree`` as a DTensor on its ``NamedSharding`` in
    ``shardings`` (a tree of the same structure)."""
    return tree_map2(distribute, tree, shardings)


def tree_map2(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of one structure (``tree``'s
    tensors are its leaves)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, other)
    if isinstance(tree, dict):
        return {k: tree_map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map2(fn, v, o)
                            for v, o in zip(tree, other)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map2(fn, v, o) for v, o in zip(tree, other))
    return tree


def _contiguous(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


# ----------------------------------------------------------------------------
# activation sharding hooks (called inside the model code)
# ----------------------------------------------------------------------------
# Propagation alone replicates attention activations whenever the head count
# does not divide the TP axis (qwen2 12 heads, granite 24, whisper 8 on
# model = 16). These hooks pin activation layouts with divisibility-aware
# fallbacks: heads over "model" when divisible, else sequence over "model",
# else replicated. With no mesh set they return their input.
_ACTIVE: dict = {"mesh": None, "scheme": "tp"}


def set_activation_mesh(mesh, scheme: str = "tp"):
    """scheme: "tp" (heads/vocab over model; default) | "tokpar" (sequence
    over model everywhere: with replicated/fsdp weights) | "fsdp" (batch
    over data AND model; no model-axis tensor parallelism)."""
    _ACTIVE["mesh"] = mesh
    _ACTIVE["scheme"] = scheme


def activation_mesh():
    return _ACTIVE["mesh"]


def constrain(x, spec):
    """The DTensor ``x`` laid out as ``spec`` on the active mesh."""
    mesh = _ACTIVE["mesh"]
    want = placements(spec, mesh, x.ndim)
    out = x if tuple(x.placements) == want else x.redistribute(mesh, want)
    if out.requires_grad:
        # as JAX's with_sharding_constraint, whose transpose constrains
        # the cotangent: the gradient takes the same layout (a partial sum
        # is reduced here, not carried into the next product)
        out.register_hook(lambda g: g if tuple(g.placements) == want
                          else g.redistribute(mesh, want))
    return out


def activation_spec(shape: tuple, kind: str) -> P | None:
    """The spec ``shard_activation`` pins a ``kind`` of activation of
    ``shape`` to on the active mesh; None for a kind it leaves alone."""
    mesh = _ACTIVE["mesh"]
    scheme = _ACTIVE.get("scheme", "tp")
    da = data_axes(mesh)
    md = "model"
    if scheme == "fsdp":            # batch carries the model axis too
        da = da + ("model",)
        md = None
    seqpar = scheme == "tokpar"
    if kind == "attn_q":            # [b, s, H, hd]
        b, s, h, hd = shape
        bs = _pick(mesh, b, da)
        if seqpar:
            return P(bs, _pick(mesh, s, "model"), None, None)
        if md and _fits(mesh, h, md):
            return P(bs, None, md, None)
        if md and _fits(mesh, s, md):
            return P(bs, md, None, None)
        return P(bs, None, None, None)
    if kind == "attn_kv":           # [b, t, H, hd] (KV heads per query head)
        b, t, h, hd = shape
        bs = _pick(mesh, b, da)
        if not seqpar and md and _fits(mesh, h, md):
            return P(bs, None, md, None)
        return P(bs, None, None, None)
    if kind == "hidden":            # [b, s, d]
        bs = _pick(mesh, shape[0], da)
        if seqpar and len(shape) == 3:
            return P(bs, _pick(mesh, shape[1], "model"), None)
        return P(bs, *([None] * (len(shape) - 1)))
    if kind == "logits":            # [b, s, V] or [b, V]
        v = shape[-1]
        bs = _pick(mesh, shape[0], da)
        vs = md if (md and _fits(mesh, v, md)) else None
        if len(shape) == 3:
            ss = "model" if ((seqpar or vs is None)
                             and _fits(mesh, shape[1], "model")
                             and scheme != "fsdp") else None
            if ss is not None:
                vs = None
            return P(bs, ss, vs)
        return P(bs, vs)
    if kind == "moe_dispatch":      # [E, C, d]
        es = md if _fits(mesh, shape[0], md) else None
        cs = md if (es is None and _fits(mesh, shape[1], md)) else None
        return P(es, cs, None)
    if kind == "moe_dispatch4":     # [G, E, C, *]: grouped dispatch buffers
        gsd = _pick(mesh, shape[0], da)
        es = md if _fits(mesh, shape[1], md) else None
        cs = md if (es is None and _fits(mesh, shape[2], md)) else None
        return P(gsd, es, cs, None)
    if kind == "ssm_intra":         # [B, nc, Q, Q, H]: SSD intra-chunk mask
        bs = _pick(mesh, shape[0], da)
        hs = "model" if (scheme == "tp"
                         and _fits(mesh, shape[-1], "model")) else None
        return P(bs, None, None, None, hs)
    return None


def shard_activation(x, kind: str):
    """Pin an activation's layout (and its gradient's). No-op when no mesh
    is set, and on a plain tensor: under a mesh that is one rank's block
    inside a ``local_map`` body, which has no global layout to pin."""
    if _ACTIVE["mesh"] is None or not isinstance(x, DTensor):
        return x
    spec = activation_spec(tuple(x.shape), kind)
    return x if spec is None else constrain(x, spec)


def fsdp_gather(params):
    """A layer's params (a tree of ``ParameterDict``s, ``ModuleDict``s and
    dicts) ready to compute with: with a mesh set, each DTensor gathered
    over the axes that split it as storage only (the data axes, and
    "model" too under the "fsdp" scheme), its tensor-parallel split kept:
    the all-gather FSDP does before a layer, which GSPMD infers. Without a
    mesh, ``params`` itself. Called where a layer is computed (inside a
    remat group), so the gathered copy lives only while it is used."""
    mesh = _ACTIVE["mesh"]
    if mesh is None:
        return params
    names = list(mesh.mesh_dim_names)
    gather = set(data_axes(mesh))
    if _ACTIVE["scheme"] == "fsdp":
        gather.add("model")

    def one(t):
        if not isinstance(t, DTensor):
            return t
        want = [Replicate() if names[i] in gather else pl
                for i, pl in enumerate(t.placements)]
        return t if want == list(t.placements) else t.redistribute(
            t.device_mesh, want)

    def walk(m):
        if isinstance(m, torch.Tensor):
            return one(m)
        if isinstance(m, (list, tuple)) or (
                hasattr(m, "__len__") and hasattr(m, "__getitem__")
                and not hasattr(m, "keys")):
            return [walk(v) for v in m]
        return {k: walk(m[k]) for k in m.keys()}

    return walk(params)


def on_local_rows(fn, x, params, *extra, n_out: int):
    """``fn(x, params, *extra)`` (``n_out`` tensor results, each with a
    leading batch dim) on DTensors: every rank runs ``fn`` on its own batch
    rows of ``x`` and ``extra`` with ``params`` whole (gathered over every
    mesh dim), and the results are split as the rows are. The mixers whose
    work is a scan over time (the SSD and RG-LRU blocks) run so: data
    parallel, no tensor parallelism. Each rank's parameter gradient covers
    its rows: a partial sum over the mesh dims that split them. On plain
    tensors, ``fn`` itself."""
    if not isinstance(x, DTensor):
        return fn(x, params, *extra)
    mesh = x.device_mesh
    rows = [pl if pl == Shard(0) else Replicate() for pl in x.placements]
    rep = [Replicate()] * mesh.ndim
    grad = [Partial() if pl == Shard(0) else Replicate() for pl in rows]
    keys = list(params.keys())
    ps = [params[k].redistribute(mesh, rep) for k in keys]
    ex = [e.redistribute(mesh, rows) for e in extra]

    def local(xl, *rest):
        return fn(xl, dict(zip(keys, rest[:len(keys)])), *rest[len(keys):])

    return local_map(
        local, out_placements=tuple([rows] * n_out),
        in_placements=(rows, *[rep] * len(keys), *[rows] * len(ex)),
        in_grad_placements=(rows, *[grad] * len(keys), *[rows] * len(ex)),
        device_mesh=mesh)(x.redistribute(mesh, rows), *ps, *ex)


def replicate_like(t: torch.Tensor, ref):
    """``t`` (a tensor every rank builds alike: positions, rotary tables)
    as a replicated DTensor on ``ref``'s mesh when ``ref`` is a DTensor,
    so that no plain tensor meets a distributed one; else ``t``."""
    if not isinstance(ref, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
