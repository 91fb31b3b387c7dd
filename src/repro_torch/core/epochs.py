"""Wait-free epoch ring: retained snapshot history as packed deltas, in
PyTorch: the port of ``repro.core.epochs`` (DESIGN.md §13).

The ingest pool (runtime/ingest.py) publishes one immutable state per
admission round: epochs 0, 1, 2, ... in publish order. The ring retains a
bounded window of them as

    (epoch, version_vector, packed row deltas)

records, one per published epoch. A delta is an XOR patch: for every row
whose bytes changed between epoch e-1 and e the record holds the row index
and the XOR of the five row fields (vkey, valive, vver, ecnt and the packed
out-adjacency row). XOR is its own inverse, so ``state_at(e)`` starts from
the newest published state and XORs records backward until it lands on e.

The records are host numpy with the JAX package's dtypes and bytes
(``rows`` int32, ``valive_xor`` bool, ``adj_xor`` uint32 bit patterns), so
``dump()`` leaves are byte-identical to the JAX ring's. What differs is
where the work runs, because the states live on the card:

  * **``push`` diffs on the device.** The port's engines are functional (a
    batch clones its input once), so a published state is never written
    again and the ring keeps the newest one by reference, on its device,
    without a copy. ``push`` finds the changed rows there (any scalar field
    differs, or any word of the ``adj_packed`` row) and copies to the host
    only their XOR patches and the (ecnt, vver) version vector, in one
    transfer. Torch tensors are mutable, so the ring stamps each field's
    version counter when it takes a state and raises if a read or a push
    finds the newest state written in place since: the records XOR against
    it, and such a write would change every retained epoch. The JAX ring copies all five fields of every published state
    to the host and diffs them whole: at V = 69,632 that is 69,632 x 2,176
    x 4 B = 606 MB of ``adj_packed`` per publish (a byte count from the
    shapes), where a round changes a few hundred rows.
  * **``state_at`` rebuilds both mirrors without a [V, V] transient.** It
    folds the newer records' patches on the host into one patch per row
    (XOR is associative, so a row touched by several records gets the XOR
    of its patches), copies that to the device once, clones the newest
    state's ``adj_packed`` and ``adj_in_packed``, XORs the patch into the
    out mirror, and for each set bit (r, c) of it flips bit (c, r) of the
    in mirror. Every published state keeps the transpose invariant and
    the transpose is linear over XOR, so the result equals
    ``pack_transpose`` of the rebuilt out mirror, which is never formed.
  * ``diff`` rebuilds only ``vkey`` at each end, and ``versions_at`` /
    ``epoch_of_versions`` only (ecnt, vver), on the host, as JAX does.

A mesh-sharded state (``core.partition.ShardedGraphState``) is held the
same way, its version stamps covering every row block: ``push`` diffs it
row block by row block against the previous state's same rows, with no
gathered [V, W] copy, and ``state_at`` returns the dense ``GraphState``,
as the JAX ring does.

Capacity growth is a retention barrier: a ``grow`` changes every row's
shape, so the ring resets at the grown epoch and earlier epochs report
``EpochEvictedError``, the same typed signal an epoch past the bounded
retention window produces.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.distributed import _on
from repro_torch.core.graph import (WORD_BITS, GraphState,
                                    pack_transpose_blocks, resolve_device,
                                    wrap_int32)
from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import global_registry as _obs_registry

# The five per-row fields a delta record patches, in GraphState order
# (adj_in_packed is derived, never stored; see the module docstring).
_ROW_FIELDS = ("vkey", "valive", "vver", "ecnt", "adj_packed")
_SCALARS = _ROW_FIELDS[:4]


def _tensors(state) -> tuple:
    """Every tensor of a dense or sharded state."""
    return tuple(state) if isinstance(state, GraphState) else state.tensors()


def _stamp(state) -> tuple[int, ...]:
    """The version counters of a state's tensors (for a sharded state every
    row block and metadata copy): an in-place write to any of them moves
    its counter."""
    return tuple(t._version for t in _tensors(state))


def _row_blocks(state) -> list:
    """(first row, int32[R, W] block) of a state's ``adj_packed``, in row
    order: one block for a dense state, S for a sharded one."""
    if isinstance(state, GraphState):
        return [(0, state.adj_packed)]
    per = state.rows_per_shard
    return [(s * per, b) for s, b in enumerate(state.adj_packed)]


def _rows_of(state, lo: int, hi: int, dev) -> torch.Tensor:
    """``adj_packed`` rows [lo, hi) of a dense or sharded state on ``dev``:
    a view when one block holds them all on that device."""
    pieces = []
    for b0, blk in _row_blocks(state):
        a, z = max(lo, b0), min(hi, b0 + blk.shape[0])
        if a < z:
            pieces.append(_on(blk[a - b0:z - b0], dev))
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def _take_rows(state, rows: torch.Tensor) -> torch.Tensor:
    """``adj_packed[rows]`` (rows ascending) on the state's device,
    gathered block by block from a sharded state."""
    if isinstance(state, GraphState):
        return state.adj_packed[rows]
    out = []
    for b0, blk in _row_blocks(state):
        sel = rows[(rows >= b0) & (rows < b0 + blk.shape[0])] - b0
        out.append(_on(blk[_on(sel, blk.device)], state.device))
    return torch.cat(out)


def _dense_fields(state) -> list:
    """The six fields of the state as dense tensors of their own on its
    device (a sharded state's row blocks concatenated)."""
    if isinstance(state, GraphState):
        return [t.clone() for t in state]
    d = state.as_dense()
    return [t.clone() for t in d[:4]] + [d[4], d[5]]


class EpochEvictedError(LookupError):
    """Typed miss for a time-travel or diff query outside the retained
    window; carries the requested epoch and the window that was available.
    """

    def __init__(self, epoch: int, window: tuple[int, int]):
        self.epoch = int(epoch)
        self.window = (int(window[0]), int(window[1]))
        super().__init__(
            f"epoch {epoch} outside retained window "
            f"[{window[0]}, {window[1]}]")


@dataclass(frozen=True)
class EpochRecord:
    """One retained epoch: its version vector + the XOR patch from e-1."""

    epoch: int
    capacity: int
    versions: np.ndarray      # int32[V, 2]: (ecnt, vver) AT this epoch
    rows: np.ndarray          # int32[K]: slots whose bytes changed
    vkey_xor: np.ndarray      # int32[K]
    valive_xor: np.ndarray    # bool[K]
    vver_xor: np.ndarray      # int32[K]
    ecnt_xor: np.ndarray      # int32[K]
    adj_xor: np.ndarray       # uint32[K, W]: packed out-adjacency rows


@dataclass(frozen=True)
class EpochDiff:
    """Epoch-diff answer: the rows touched between two retained epochs."""

    e_from: int
    e_to: int
    rows: np.ndarray          # int32[K]: union of touched slots
    keys_before: np.ndarray   # int32[K]: vkey at e_from (-1 = empty slot)
    keys_after: np.ndarray    # int32[K]: vkey at e_to


def _transposed_flips(rows: torch.Tensor, xw: torch.Tensor, words: int):
    """(flat word indices into the in mirror, int32 XOR masks) that flip
    bit (c, r) for every set bit (r, c) of a record's out-mirror patch
    ``xw`` (int32[K, W] on the rows ``rows``), or None when it has none.
    The patch's rows are distinct, so the bits one in-mirror word receives
    are distinct and their sum is their XOR."""
    nz = torch.nonzero(xw)
    if nz.numel() == 0:
        return None
    i, wi = nz[:, 0], nz[:, 1]
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=xw.device)
    n, b = torch.nonzero(((xw[i, wi][:, None] >> shifts) & 1).bool(),
                         as_tuple=True)
    col = wi[n].long() * WORD_BITS + b           # out column = in row
    src = rows[i[n]]                             # out row = in column
    flat = col * words + src // WORD_BITS
    bit = torch.ones_like(src) << (src % WORD_BITS)
    uniq, inv = torch.unique(flat, return_inverse=True)
    acc = torch.zeros(uniq.shape, dtype=torch.int64, device=xw.device)
    return uniq, wrap_int32(acc.index_add_(0, inv, bit))


def _fold(records, words: int) -> tuple[int, np.ndarray]:
    """One XOR patch per row for a run of records, as one int32 buffer:
    (K, the K distinct rows, then the patches of the five row fields on
    them, K * (5 + words) words), each row's patch the XOR of its patches
    in ``records``. A record's rows are distinct, so each record XORs into
    the buffer with one indexed write a field."""
    rows, inv = np.unique(np.concatenate([rec.rows for rec in records]),
                          return_inverse=True)
    k = rows.size
    buf = np.zeros(k * (5 + words), np.int32)
    buf[:k] = rows
    scalars = buf[k:5 * k].reshape(4, k)
    adj = buf[5 * k:].reshape(k, words)
    o = 0
    for rec in records:
        at = inv[o:o + rec.rows.size]
        o += rec.rows.size
        for row, n in zip(scalars, _SCALARS):
            row[at] ^= getattr(rec, f"{n}_xor")
        adj[at] ^= rec.adj_xor.view(np.int32)
    return k, buf


class EpochRing:
    """Bounded retention of published epochs as backward-replayable deltas.

    ``retain`` bounds the number of addressable epochs (records kept =
    retain - 1 plus the newest full state): after publishing epoch N the
    window is ``[max(reset_epoch, N - retain + 1), N]``. The ingest pool
    drives ``push`` under its admission mutex; the read surfaces touch only
    immutable records and the newest state, so readers never block writers.
    """

    def __init__(self, retain: int = 64):
        if retain < 1:
            raise ValueError(f"retain must be >= 1, got {retain}")
        self.retain = int(retain)
        self.evicted = 0              # cumulative records dropped (stats)
        self._records: list[EpochRecord] = []
        self._latest: GraphState | None = None   # by reference, on device
        self._latest_stamp: tuple[int, ...] = ()
        self._newest = 0
        self._host_bytes = 0          # bytes this ring copied off the device

    def _hold(self, state: GraphState) -> None:
        self._latest = state
        self._latest_stamp = _stamp(state)

    def _newest_state(self) -> GraphState | None:
        """The newest published state, checked unwritten since the ring
        took it: every record XORs against it."""
        s = self._latest
        if s is not None and _stamp(s) != self._latest_stamp:
            raise RuntimeError(
                f"the published state of epoch {self._newest} was written "
                f"in place; the ring's records XOR against it, so every "
                f"retained epoch would be rebuilt wrong")
        return s

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        self._host_bytes += t.numel() * t.element_size()
        return t.cpu().numpy()

    # -- maintenance (writer side) ------------------------------------------
    def reset(self, epoch: int, state: GraphState) -> None:
        """Restart retention at ``epoch`` (initial state or a grow barrier:
        a capacity change invalidates every row-shaped delta)."""
        self.evicted += len(self._records)
        self._records = []
        self._hold(state)
        self._newest = int(epoch)

    def push(self, epoch: int, state: GraphState) -> None:
        """Record the transition newest -> ``epoch`` (consecutive publishes):
        the changed rows are found on the device, and only their patches
        and the version vector cross to the host, in one copy. Traced as
        ``ring.push`` (``rows`` changed, ``bytes`` copied to the host; 0
        and 0 where a capacity change resets the ring)."""
        with _trace.span("ring.push", epoch=int(epoch)) as sp:
            prev = self._newest_state()
            if prev is None or state.capacity != prev.capacity:
                self.reset(epoch, state)
                sp.set(rows=0, bytes=0)
                return
            if epoch != self._newest + 1:
                raise ValueError(
                    f"non-consecutive publish: {self._newest} -> {epoch}")
            v, w = state.capacity, state.words
            dev = state.device
            # row block by row block against the previous state's same rows
            # (a sharded state is never gathered)
            changed = torch.zeros((v,), dtype=torch.bool, device=dev)
            for lo, blk in _row_blocks(state):
                hi = lo + blk.shape[0]
                diff = (_rows_of(prev, lo, hi, blk.device) != blk).any(1)
                changed[lo:hi] = _on(diff, dev)
            for name in _SCALARS:
                changed |= getattr(prev, name) != getattr(state, name)
            rows = torch.nonzero(changed).flatten()
            k = rows.numel()
            patch = [(getattr(prev, name)[rows] ^ getattr(state, name)[rows])
                     .to(torch.int32).flatten() for name in _SCALARS]
            patch.append((_take_rows(prev, rows) ^ _take_rows(state, rows))
                         .flatten())
            host = self._to_host(torch.cat(
                [torch.stack([state.ecnt, state.vver], -1).flatten(),
                 rows.to(torch.int32)] + patch))
            sp.set(rows=k, bytes=host.nbytes)
            ends = np.cumsum([2 * v, k, k, k, k, k])
            versions, rows_h, vk, va, vv, ec, adj = np.split(host, ends)
            rec = EpochRecord(
                epoch=int(epoch), capacity=v,
                versions=versions.reshape(v, 2).copy(), rows=rows_h.copy(),
                vkey_xor=vk.copy(), valive_xor=va.astype(np.bool_),
                vver_xor=vv.copy(), ecnt_xor=ec.copy(),
                adj_xor=adj.reshape(k, w).view(np.uint32).copy())
            self._records.append(rec)
            self._hold(state)
            self._newest = int(epoch)
            while len(self._records) > self.retain - 1:
                self._records.pop(0)
                self.evicted += 1
                if _trace.enabled():
                    _obs_registry().inc("ring.evictions")
            if _trace.enabled():
                _obs_registry().set("ring.occupancy", len(self._records))
                _trace.counter("ring.occupancy", len(self._records))

    # -- read side ----------------------------------------------------------
    def window(self) -> tuple[int, int]:
        """(oldest addressable epoch, newest published epoch), inclusive."""
        return self._newest - len(self._records), self._newest

    def __len__(self) -> int:
        return len(self._records)

    def contains(self, epoch: int) -> bool:
        lo, hi = self.window()
        return lo <= int(epoch) <= hi

    def _check(self, epoch: int) -> None:
        lo, hi = self.window()
        if not lo <= int(epoch) <= hi:
            raise EpochEvictedError(epoch, (lo, hi))

    def _newer(self, epoch: int):
        """The records XORed backward to reach ``epoch``, newest first."""
        for rec in reversed(self._records):
            if rec.epoch <= epoch:
                return
            yield rec

    def _host_scalars_at(self, epoch: int, names) -> list[np.ndarray]:
        """Host copies of the scalar fields ``names`` at a retained epoch,
        rebuilt from the newest state's (one copy of each) alone."""
        self._check(epoch)
        latest = self._newest_state()
        cur = [self._to_host(getattr(latest, n)).copy() for n in names]
        for rec in self._newer(epoch):
            for a, n in zip(cur, names):
                a[rec.rows] ^= getattr(rec, f"{n}_xor")
        return cur

    def state_at(self, epoch: int) -> GraphState:
        """Reconstruct the published state of ``epoch`` on the newest
        state's device, bit-identical to what the pool published then, both
        mirrors included. Raises ``EpochEvictedError`` outside the window."""
        with _trace.span("ring.state_at", epoch=int(epoch)) as sp:
            self._check(epoch)
            if _trace.enabled():
                # replay depth: records XORed backward from the newest state
                depth = min(len(self._records),
                            max(0, self._newest - int(epoch)))
                sp.set(depth=depth)
                _obs_registry().observe("ring.resolve_depth", depth)
            latest = self._newest_state()
            cur = _dense_fields(latest)
            newer = [rec for rec in self._newer(epoch) if rec.rows.size]
            if not newer:
                return GraphState(*cur)
            k, buf = _fold(newer, latest.words)
            parts = torch.split(torch.from_numpy(buf).to(latest.device),
                                [k] * 5 + [k * latest.words])
            r = parts[0].long()
            for t, p in zip(cur[:4], parts[1:5]):
                t[r] ^= p.to(t.dtype)
            xw = parts[5].view(k, latest.words)
            cur[4][r] ^= xw
            flips = _transposed_flips(r, xw, latest.words)
            if flips is not None:
                cur[5].view(-1)[flips[0]] ^= flips[1]
            return GraphState(*cur)

    def versions_at(self, epoch: int) -> np.ndarray:
        """(ecnt, vver) int32[V, 2] of a retained epoch (stored for every
        record; rebuilt on the host only for the window's oldest epoch)."""
        self._check(epoch)
        for rec in self._records:
            if rec.epoch == epoch:
                return rec.versions
        ecnt, vver = self._host_scalars_at(epoch, ("ecnt", "vver"))
        return np.stack([ecnt, vver], axis=-1)

    def epoch_of_versions(self, versions, capacity: int) -> int | None:
        """Newest retained epoch whose version vector equals ``versions``
        (the index-stamp lookup of DESIGN.md §13), or None. Equal versions
        imply a byte-identical graph (the counters are monotone)."""
        if self._latest is None or capacity != self._latest.capacity:
            return None
        if isinstance(versions, torch.Tensor):
            versions = versions.cpu().numpy()
        want = np.asarray(versions)
        lo, hi = self.window()
        for e in range(hi, lo - 1, -1):
            if np.array_equal(self.versions_at(e), want):
                return e
        return None

    # -- checkpoint serialization (DESIGN.md §16) ---------------------------
    def dump(self) -> tuple[list[np.ndarray], dict]:
        """Flatten the ring into (leaves, meta), byte-identical to the JAX
        ring's: the 5 newest-state fields (``adj_packed`` as uint32), then
        7 arrays per retained record (versions, rows, the five patches)."""
        meta = {"retain": self.retain, "newest": self._newest,
                "evicted": self.evicted, "n_records": len(self._records),
                "has_latest": self._latest is not None,
                "record_epochs": [r.epoch for r in self._records]}
        leaves: list[np.ndarray] = []
        latest = self._newest_state()
        if latest is not None:
            leaves += [self._to_host(getattr(latest, n)).copy()
                       for n in _SCALARS]
            leaves.append(self._to_host(_rows_of(
                latest, 0, latest.capacity, latest.device))
                .view(np.uint32).copy())
        for rec in self._records:
            leaves += [rec.versions, rec.rows, rec.vkey_xor, rec.valive_xor,
                       rec.vver_xor, rec.ecnt_xor, rec.adj_xor]
        return leaves, meta

    @classmethod
    def load(cls, leaves: list[np.ndarray], meta: dict,
             device=None) -> "EpochRing":
        """Rebuild a ring from ``dump`` output (the port's or the JAX
        ring's), with the newest state on the card unless ``device`` names
        another: same window, same records, same eviction counter. The in
        mirror is rebuilt as the blockwise transpose of ``adj_packed``."""
        dev = resolve_device(device)
        ring = cls(retain=int(meta["retain"]))
        ring._newest = int(meta["newest"])
        ring.evicted = int(meta["evicted"])
        i = 0
        cap = 0
        if meta.get("has_latest"):
            vk, va, vv, ec, adj = (np.asarray(x) for x in leaves[:5])
            i = len(_ROW_FIELDS)
            cap = int(vk.shape[0])
            words = torch.from_numpy(
                np.ascontiguousarray(adj).view(np.int32).copy()).to(dev)
            ring._hold(GraphState(
                torch.from_numpy(np.array(vk, np.int32)).to(dev),
                torch.from_numpy(np.array(va, np.bool_)).to(dev),
                torch.from_numpy(np.array(vv, np.int32)).to(dev),
                torch.from_numpy(np.array(ec, np.int32)).to(dev),
                words, pack_transpose_blocks(words, cap)))
        for epoch in meta.get("record_epochs", []):
            versions, rows, vk, va, vv, ec, adj = leaves[i:i + 7]
            i += 7
            ring._records.append(EpochRecord(
                epoch=int(epoch), capacity=cap,
                versions=np.asarray(versions),
                rows=np.asarray(rows, dtype=np.int32),
                vkey_xor=np.asarray(vk), valive_xor=np.asarray(va),
                vver_xor=np.asarray(vv), ecnt_xor=np.asarray(ec),
                adj_xor=np.ascontiguousarray(adj).view(np.uint32)))
        return ring

    def diff(self, e1: int, e2: int) -> EpochDiff:
        """Rows (and their keys) that changed between two retained epochs.
        Raises ``EpochEvictedError`` if either endpoint left the window."""
        lo, hi = sorted((int(e1), int(e2)))
        w = self.window()
        for e in (lo, hi):
            if not w[0] <= e <= w[1]:
                raise EpochEvictedError(e, w)
        touched: set[int] = set()
        for rec in self._records:
            if lo < rec.epoch <= hi:
                touched.update(int(r) for r in rec.rows)
        rows = np.asarray(sorted(touched), dtype=np.int32)
        (vk_lo,) = self._host_scalars_at(lo, ("vkey",))
        (vk_hi,) = self._host_scalars_at(hi, ("vkey",))
        return EpochDiff(lo, hi, rows, vk_lo[rows], vk_hi[rows])
