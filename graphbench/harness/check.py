"""The comparison that decides ``correct``.

Once the window has closed, the plain reference replays every round the
program ran (set-up's warm rounds and the window's), lane by lane, from
the same loaded edge list, and:

  codes_wrong      lanes whose result code differs from the reference's
                   (every lane of every batch); of a ``clients`` mix, the
                   reference replays the batches that landed in a round's
                   pumps in the order the server claims (its epochs, then
                   its batch ids), and every lane of a batch that never
                   landed counts
  paths_wrong      GetPath answers that differ, over a sample of the
                   window's sessions drawn from the seed (and its last
                   one): the found flag against the reference's search on
                   the state the session was validated on (the state after
                   the round's batch: one caller, so no write races it),
                   and a found path against that state: it runs from the
                   source to the target over live edges and has as many
                   hops as a shortest path
  vertices_wrong   keys alive in one store and not in the other, at the end
  edges_wrong      live edges of the out-mirror in one store and not in
                   the other, at the end
  in_edges_wrong   the same of the in-mirror, read transposed
  grow_events      capacity grows of the server (a grow would need four
                   times the state's memory)
  order_wrong      (``clients`` mixes only) batches that landed before,
                   in the order the server claims, a batch their client
                   had submitted before them

Every number is exact: its limit is 0. The reference is the
``ReferenceStore`` of the file the configuration names.
"""
from __future__ import annotations

import numpy as np

from graphbench.harness import spec

LIMITS = {"codes_wrong": 0, "paths_wrong": 0, "vertices_wrong": 0,
          "edges_wrong": 0, "in_edges_wrong": 0, "grow_events": 0}
CLIENT_LIMITS = {"order_wrong": 0}   # compared where the mix has clients
ROWS_A_BLOCK = 8192


def sampled_sessions(rounds: list, window: set, n: int, rng) -> set:
    """Indices of ``n`` sessions of the window drawn by ``rng``, and the
    window's last session."""
    have = [log.index for log in rounds
            if log.answers is not None and log.index in window]
    if not have:
        return set()
    pick = rng.choice(len(have), size=min(n, len(have)), replace=False)
    return {have[i] for i in pick} | {have[-1]}


def answer_wrong(ref, pair, hops: int, answer) -> bool:
    found, keys = answer
    if bool(found) != (hops >= 0):
        return True
    if not found:
        return False
    k, l = (int(x) for x in pair)
    keys = [int(x) for x in keys]
    if len(keys) != hops + 1 or keys[0] != k or keys[-1] != l:
        return True
    if not all(0 <= x < ref.nk and ref.alive[x] for x in keys):
        return True
    return not all(ref.present(a, b) for a, b in zip(keys, keys[1:]))


def store_sets(state, n_keys: int):
    """(alive keys, out-mirror edge ids, in-mirror edge ids read
    transposed) of the program's final state, as sorted int64 arrays; an
    edge id is ``source * n_keys + target`` over live endpoints. Read on
    the state's device in blocks of rows."""
    import torch

    dev = state.vkey.device
    valive = state.valive
    vkey = state.vkey.to(torch.int64)
    v = state.vkey.shape[0]
    shifts = torch.arange(32, device=dev, dtype=torch.int64)
    sets = []
    for words, transposed in ((state.adj_packed, False),
                              (state.adj_in_packed, True)):
        ids = []
        for r0 in range(0, v, ROWS_A_BLOCK):
            blk = words[r0:r0 + ROWS_A_BLOCK]
            at = (blk != 0).nonzero()
            vals = blk[at[:, 0], at[:, 1]].to(torch.int64) & 0xFFFFFFFF
            on = ((vals[:, None] >> shifts) & 1) != 0
            hit = on.nonzero()
            rows = at[hit[:, 0], 0] + r0
            cols = at[hit[:, 0], 1] * 32 + hit[:, 1]
            keep = cols < v
            rows, cols = rows[keep], cols[keep]
            live = valive[rows] & valive[cols]
            rows, cols = rows[live], cols[live]
            a, b = ((vkey[cols], vkey[rows]) if transposed
                    else (vkey[rows], vkey[cols]))
            ids.append((a * n_keys + b).cpu())
        sets.append(np.sort(torch.cat(ids).numpy()) if ids
                    else np.zeros(0, np.int64))
    keys = np.sort(vkey[valive].cpu().numpy())
    return keys, sets[0], sets[1]


def set_gap(got: np.ndarray, want: np.ndarray) -> int:
    """Members of one set and not the other, and members ``got`` holds
    twice, of two sorted arrays (``want`` without repeats)."""
    again = got[1:] == got[:-1]
    dup = int(np.count_nonzero(again))
    if dup:
        got = got[np.r_[True, ~again]]
    at = np.searchsorted(want, got)
    inside = at < len(want)
    common = int(np.count_nonzero(want[at[inside]] == got[inside]))
    return len(got) + len(want) - 2 * common + dup


def lanes_wrong(want: np.ndarray, got) -> int:
    """Lanes whose code differs, and lanes that one side lacks."""
    got = np.asarray(got).reshape(-1)
    n = min(len(want), len(got))
    return int((want[:n] != got[:n]).sum()) + abs(len(want) - len(got))


def order_wrong(rounds: list) -> int:
    """Batches that landed before, in the claimed order, a batch their
    client had submitted before them."""
    latest: dict = {}
    wrong = 0
    for log in rounds:
        for tk in log.tickets or ():
            if tk.status != "applied":
                continue
            if tk.client in latest and tk.claimed < latest[tk.client]:
                wrong += 1
            latest[tk.client] = max(latest.get(tk.client, tk.claimed),
                                    tk.claimed)
    return wrong


def compare(setup, window: set, sample_n: int, rng, final_sets,
            grow_events: int, device="cpu"):
    """({name: value} of every number compared, GetPath answers checked).
    ``final_sets`` is ``store_sets`` of the program's final state (or of a
    stand-in); the reference searches on ``device``."""
    g = setup.graph
    nk = g.n + int(setup.mix["churn_keys"])
    ref = spec.reference_store(setup.cfg)(g.n, nk, setup.capacity, g.u, g.v,
                                          setup.churn_start, device=device)
    sample = sampled_sessions(setup.rounds, window, sample_n, rng)
    codes_wrong = paths_wrong = 0

    def replay(landed):
        return sum(lanes_wrong(ref.apply_batch(tk.ops), tk.codes)
                   for tk in landed if tk.status == "applied")

    for log in setup.rounds:
        if log.compacted:
            ref.compact()
        if log.batch is not None:
            codes_wrong += lanes_wrong(ref.apply_batch(log.batch), log.codes)
        codes_wrong += replay(log.landed)
        if log.index in sample:
            hops = ref.distances(log.pairs)
            answers = list(log.answers) + [(False, [])] * max(
                0, len(log.pairs) - len(log.answers))
            paths_wrong += sum(answer_wrong(ref, p, h, a) for p, h, a in
                               zip(log.pairs.tolist(), hops.tolist(),
                                   answers))
            paths_wrong += max(0, len(log.answers) - len(log.pairs))
    codes_wrong += replay(setup.drained)
    codes_wrong += sum(len(tk.ops) for log in setup.rounds
                       for tk in log.tickets or () if tk.done_ns is None)
    keys, out_ids, in_ids = final_sets
    alive = np.flatnonzero(np.frombuffer(bytes(ref.alive), np.uint8))
    u, v = ref.live_edges()
    want_ids = u * nk + v
    numbers = {
        "codes_wrong": codes_wrong,
        "paths_wrong": paths_wrong,
        "vertices_wrong": set_gap(keys, alive),
        "edges_wrong": set_gap(out_ids, want_ids),
        "in_edges_wrong": set_gap(in_ids, want_ids),
        "grow_events": int(grow_events),
    }
    if setup.mix.get("clients"):
        numbers["order_wrong"] = order_wrong(setup.rounds)
    return numbers, sum(len(log.pairs) for log in setup.rounds
                        if log.index in sample)
