"""Async checkpointing with atomic publish, in PyTorch: the port of
``repro.checkpoint.checkpointer`` (DESIGN.md §16).

Layout: one directory per step, the JAX package's byte for byte:
    <dir>/step_000000010/
        manifest.json      tree structure, shapes, dtypes, step, extra meta
        leaf_000000.npy    one file per pytree leaf (host-gathered)
        ...

  * atomic publish: write to ``<dir>/.tmp_step_x``, fsync, rename; a
    crashed writer never corrupts the latest checkpoint.
  * async save: the device -> host copy happens on the caller's thread (a
    synchronous ``.cpu()``: the writer thread must never see bytes the card
    has not finished sending), file I/O in a background thread; ``wait()``
    joins it and re-raises a writer failure.
  * retention: keep the last K steps.

Trees are flattened with ``torch.utils._pytree``. A flat list of leaves
(what the graph checkpointer saves) gets the manifest ``treedef`` JAX
writes for it, ``PyTreeDef([*, *, ...])``, so a graph checkpoint's
manifest equals the JAX package's apart from ``time``. ``restore`` places
the leaves on the card unless the caller names another device.

bfloat16 leaves are written as the JAX package writes them: ``np.save`` of
ml_dtypes' bfloat16 gives the header descr ``'<V2'`` and the raw bits, and
the manifest names the dtype ``bfloat16``. They are read back bit for bit
through an int16 view (no ml_dtypes needed). The LM train loop saves its
``(params, opt_state)`` in the JAX package's tree (``convert.jax_layout``),
so either package resumes from the other's directory. ``restore(
shardings=)`` places each leaf as a DTensor on its mesh; a tree of DTensors
is gathered by every process on ``save`` and written by global rank 0.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree

from repro_torch.core.graph import resolve_device
from repro_torch.parallel.sharding import NamedSharding, distribute


def _node_str(spec) -> str | None:
    """JAX's ``PyTreeDef`` spelling of a tree of dicts (keys in JAX's
    sorted order), lists, tuples and NamedTuples; None for any other."""
    if spec.is_leaf():
        return "*"
    kids = [_node_str(c) for c in spec.children()]
    if None in kids:
        return None
    if spec.type is dict:
        if list(spec.context) != sorted(spec.context):
            return None
        return "{" + ", ".join(f"{k!r}: {v}"
                               for k, v in zip(spec.context, kids)) + "}"
    if spec.type is list:
        return "[" + ", ".join(kids) + "]"
    if spec.type is tuple:
        return "(" + ", ".join(kids) + ("," if len(kids) == 1 else "") + ")"
    if isinstance(spec.context, type) and issubclass(spec.context, tuple):
        return (f"CustomNode(namedtuple[{spec.context.__name__}], ["
                + ", ".join(kids) + "])")
    return None


def _treedef_str(spec) -> str:
    """The manifest's ``treedef``: JAX's spelling where ``_node_str`` has
    one, torch's ``TreeSpec`` text otherwise."""
    node = _node_str(spec)
    return str(spec) if node is None else f"PyTreeDef({node})"


def is_bf16_bits(a: np.ndarray) -> bool:
    """A numpy array that holds bfloat16: ml_dtypes' type, or the raw bits
    as a two-byte void (what ``np.load`` gives for a ``'<V2'`` file)."""
    return a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                          and a.dtype.itemsize == 2)


def to_host(x) -> np.ndarray:
    """A host copy the caller can no longer write: tensors through one
    synchronous copy (``copy=True`` also copies a CPU tensor, whose
    ``.numpy()`` would share the caller's memory), bfloat16 as its raw
    bits in a two-byte void."""
    if isinstance(x, torch.Tensor):
        if _is_dtensor(x):
            x = x.full_tensor()          # a collective: every rank calls it
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(x)


def _is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def _writes(leaves) -> bool:
    """Whether this process writes a tree of DTensors: every process
    takes part in gathering each leaf, only global rank 0 copies it to the
    host and writes it."""
    if not any(_is_dtensor(x) for x in leaves):
        return True
    return not dist.is_initialized() or dist.get_rank() == 0


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if is_bf16_bits(a) else str(a.dtype)


def _save_npy(f, a: np.ndarray) -> None:
    """``np.save``'s bytes; bfloat16 with the header JAX's leaves get."""
    if not is_bf16_bits(a):
        np.save(f, a)
        return
    np.lib.format.write_array_header_1_0(
        f, {"descr": "<V2", "fortran_order": False, "shape": a.shape})
    f.write(a.tobytes())


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A loaded leaf as a CPU tensor of its dtype, shape and bits."""
    if not a.flags.c_contiguous:
        a = np.ascontiguousarray(a)
    if is_bf16_bits(a):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _fsync_dir(path: str) -> None:
    """fsync a directory so renames/creates inside it are durable."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# tmp dirs with a LIVE writer thread in this process: the stale-tmp sweep
# below must not reap a write that is still going to publish (a simulated
# in-process crash leaves the background writer running; a real kill -9
# leaves no writer, so its debris is always sweepable)
_live_tmp_lock = threading.Lock()
_live_tmp: set[str] = set()


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)
        # a crashed writer (kill between tmp write and rename) leaves a
        # stale .tmp_step_* dir; it never shadows a published step, but
        # clean it so retention math and disk usage stay honest
        with _live_tmp_lock:
            live = set(_live_tmp)
        for name in os.listdir(directory):
            path = os.path.join(directory, name)
            if name.startswith(".tmp_step_") and path not in live:
                shutil.rmtree(path, ignore_errors=True)

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree, *, extra: dict | None = None,
             blocking: bool = False):
        """Snapshot ``tree`` at ``step``. Returns immediately unless blocking.

        ``blocking=True`` joins the writer thread before returning, so the
        checkpoint is fully published (fsynced + renamed) on return: the
        guarantee recovery cadence and WAL truncation build on.
        """
        self.wait()
        leaves, spec = pytree.tree_flatten(tree)
        if not _writes(leaves):
            for x in leaves:       # take part in each leaf's gather only
                if _is_dtensor(x):
                    x.full_tensor()
            return
        host_leaves = [to_host(x) for x in leaves]    # device -> host now
        manifest = {
            "step": int(step),
            "treedef": _treedef_str(spec),
            "n_leaves": len(host_leaves),
            "shapes": [list(x.shape) for x in host_leaves],
            "dtypes": [_dtype_name(x) for x in host_leaves],
            "shard_hint": "host-gathered (single-process); per-shard on fleet",
            "extra": extra or {},
            "time": time.time(),
        }

        # register the tmp path BEFORE the thread starts: a concurrently
        # constructed Checkpointer on the same directory must never sweep
        # a write that is still going to publish
        tmp = os.path.join(self.dir, f".tmp_step_{step:09d}")
        with _live_tmp_lock:
            _live_tmp.add(tmp)

        def write():
            try:
                self._write(step, host_leaves, manifest)
            except BaseException as e:  # surfaced by the next wait()/save()
                self._error = e
            finally:
                with _live_tmp_lock:
                    _live_tmp.discard(tmp)

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _write(self, step: int, host_leaves, manifest: dict,
               publish: bool = True):
        """Write tmp dir, fsync every file + the dirs, then atomic rename.
        ``publish=False`` stops before the rename: the ``ckpt-mid-write``
        crash stage."""
        tmp = os.path.join(self.dir, f".tmp_step_{step:09d}")
        final = os.path.join(self.dir, f"step_{step:09d}")
        os.makedirs(tmp, exist_ok=True)
        for i, leaf in enumerate(host_leaves):
            p = os.path.join(tmp, f"leaf_{i:06d}.npy")
            with open(p, "wb") as f:
                _save_npy(f, leaf)
                f.flush()
                os.fsync(f.fileno())
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        if not publish:
            return
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(self.dir)
        self._retain()

    def wait(self):
        """Join the in-flight writer; re-raise any background failure (a
        silently-dropped checkpoint must not look like a durable one)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("background checkpoint write failed") from err

    def _retain(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _manifest(self, step: int | None) -> tuple[str, dict]:
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "manifest.json")) as f:
            return path, json.load(f)

    def restore(self, template, *, step: int | None = None, shardings=None,
                device=None):
        """Load into the structure of ``template`` (values ignored) as
        tensors on the card unless ``device`` names another; a leaf takes
        the dtype of its template leaf where that has one. Returns (tree,
        manifest).

        ``shardings``: a tree of the template's structure whose leaves are
        ``parallel.sharding.NamedSharding`` (or None): each such leaf is
        placed on its mesh as a DTensor, the process cutting its own block
        out of the file on the host and moving only that to its device
        (the elastic re-placement of JAX's ``device_put`` on a
        ``NamedSharding``; the saving mesh may differ)."""
        dev = resolve_device(device)
        shard_leaves = None
        if shardings is not None:
            shard_leaves = pytree.tree_flatten(
                shardings, is_leaf=lambda x: x is None
                or isinstance(x, NamedSharding))[0]
        path, manifest = self._manifest(step)
        leaves_t, spec = pytree.tree_flatten(template)
        if manifest["n_leaves"] != len(leaves_t):
            raise ValueError(f"tree structure changed: checkpoint has "
                             f"{manifest['n_leaves']} leaves, template "
                             f"{len(leaves_t)}")
        if shard_leaves is not None and len(shard_leaves) != len(leaves_t):
            raise ValueError(f"shardings have {len(shard_leaves)} leaves, "
                             f"the template {len(leaves_t)}")
        out = []
        for i, tmpl in enumerate(leaves_t):
            arr = np.load(os.path.join(path, f"leaf_{i:06d}.npy"))
            if isinstance(tmpl, torch.Tensor):
                t = _tensor(arr).to(tmpl.dtype)
            else:
                t = _tensor(arr.astype(tmpl.dtype) if hasattr(tmpl, "dtype")
                            else arr)
            if shard_leaves is not None and shard_leaves[i] is not None:
                out.append(distribute(t, shard_leaves[i]))
            else:
                out.append(t.to(dev))
        return pytree.tree_unflatten(out, spec), manifest

    def restore_raw(self, *, step: int | None = None
                    ) -> tuple[list[np.ndarray], dict]:
        """Load the raw host leaves + manifest without a template. The
        graph checkpointer (runtime/recovery.py) needs this: its trees
        carry a VARIABLE number of leaves (epoch-ring records vary per
        checkpoint), so a template's leaf count cannot apply."""
        path, manifest = self._manifest(step)
        leaves = [np.load(os.path.join(path, f"leaf_{i:06d}.npy"))
                  for i in range(manifest["n_leaves"])]
        return leaves, manifest
