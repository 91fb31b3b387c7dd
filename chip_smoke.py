#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]

Phases (each prints lines; the last line is the JSON result):
  1. device: the card's name and power limit (nvidia-smi), the kernel build
  1a. analysis, after the build: ``python -m repro_torch.analysis`` (the
     port's linter and kernel sanitizer) as a child must exit 0 on this
     machine, which has no jax; every module of ``repro_torch`` (but
     ``__main__`` modules) must import (``modwalk.preflight_imports``);
     and the build's ``ptxas -v`` report of each library must agree with
     the packages' ``KERNEL_META['device_kernels']``
     (``repro_torch.analysis.ptxas``: every kernel and template instance
     declared, static shared memory equal, registers within a declared
     ``max_registers``, every declared kernel built). One line a kernel:
     smem, registers and spills beside the card's name and power limit
  2. kernels: B1 (multi push), B2 (pull), B3 (single push), B6 (dense
     multi push) and B7 (dense single push) against their plain PyTorch
     versions on the card, bit for bit (tolerance 0: every output is an
     integer or a bool), over densities 0 / 0.01 / 0.3, V in {2000, 2048},
     Q in {1, 5, 16, 70} (and 1,024, the index closures' Q, at V = 2048),
     an edge in column 31 and row slices; B6 also without parents, at
     V = 2001 (the byte-wise tail) and at Q in {64, 65, 129} on a hub
     column and rows with every 16-byte chunk nonzero, sliced from an odd
     row; B5 (packed edge writes) and B9
     (dense) against theirs over B in {1, 1024} lanes with duplicate
     targets, masked lanes parked out of range, column 31 and dense values
     outside {0, 1}, and on adversarial lanes (``edge_patterns``: every
     firing lane on one target, the bits of 32 words set then cleared, one
     row with distinct columns, every lane masked, firing lanes past the
     last column, B = 0, the one-block cap and one past it); B4 (packed label
     join) and B8 (dense label join) against theirs and against each other
     over Q in {1, 5, 64, 1000}, L in {31, 32, 1024, 1030}, densities
     0 / 0.01 / 0.3, a common landmark in column 31 and all-zero OUT rows;
     B8 (against its plain version, and B4 on the same labels packed) at
     Q in {0, 1, 64, 65, 4096} x L in {1, 3, 4, 31, 1024, 1025, 1030} on
     ``LABEL_PATTERNS`` slabs (random 0/1, a common landmark only at
     L - 1, all-zero OUT rows, all-one rows, negative entries) at each of
     ``LABEL_OFFSETS`` (views that start at an element offset, sharing
     their 16-byte alignment or not);
     B4 by slot (what ``query_reach`` launches) against its plain version
     and against B4 on the rows it gathers, with slots of -1 and past the
     end and dead endpoints; then multi_bfs / bfs on "hybrid_cuda" against
     "hybrid" at V = 4096, Q = 8 on a Graph500 graph, every result field
  2w. B1, B2 and B3 against their plain versions at Q = 1,024 and 1,025
     on a random graph (V = 2048) and on skewed graphs (V = 20,480 and
     20,001, wide enough for every form of B1): rows with every word
     nonzero, rows with only bit 31 of their words, B2 in-rows too long
     for its staged lists; full and row slices, with and without parents
     (``parents=False`` also equals the launch with parents on new and
     reach)
  2s. B3 against its plain version at V in {2000, 20001, 69632, 90000}
     (W not a multiple of 4; the cell's; two frontier passes) on skewed
     graphs, for frontiers of the rows = 31 (mod 32), none, every row (many
     rounds of its shared row list), one bit-31-only row and 5% of the rows
  2b. closure routing: closure-mode multi_bfs (Q = 256) and build_index
     (the 256 highest-degree slots) on "hybrid_cuda" against "hybrid", and
     on "dense_cuda" (B6, launched without parents) against
     "hybrid_cuda", on a Graph500 SCALE-12
     graph, every field; a complete index (every alive vertex a
     landmark) of a SCALE-10 graph answers 1,024 pairs and their sources'
     reachable counts exactly as scipy's BFS does
  3. main path at full size: a Graph500 SCALE-16 graph (65,536 vertices,
     1,048,576 generated edges, A/B/C/D = 0.57/0.19/0.19/0.05) in a state of
     capacity 69,632; 8 rounds of one ``apply_ops_fast`` batch
     (B = 1024, the paper's "equal" mix), one ``get_paths_session`` (Q = 64;
     in rounds 1 and 5 a mutator commits a batch on the first two fetches,
     so the double collect must retry) and one ``get_path_session``
  4. checks: each of the 8 batches equals ``apply_ops`` on the state it is
     applied to (codes and the six arrays; the serial pass kernel runs on
     every batch's conflicting lanes); the transpose invariant
     holds at the end; every matched answer equals scipy's BFS on the live
     edges of the state it was validated on, and every path is a chain of
     live edges; each kernel was launched on the main path
  3b. the dense engine (JAX "pallas", here "dense_cuda": B6/B7 on the
     uint8 [V, V] view, unpacked in row chunks) at full width on the
     phase-3 end state: the view's build time and size, 4 rounds of
     ``get_paths_session`` (Q = 64) and one ``get_path_session``; every
     ``multi_bfs``/``bfs`` field equals "hybrid_cuda" on the same pairs,
     every answer equals scipy's BFS; B6 and B7 must have launched there
  5. the device's busy and idle share over one batch, one session, one
     single session and one session on the dense engine, after phase
     7 over one index build and one fresh index-served session, and after
     phase 8 over one admission round (``pump``), one ring push and one
     ``state_at`` at replay depth 8 (torch.profiler; Chrome traces in
     build/chip_smoke_traces/). Every trace of this script (here, phase
     6's device times, the launch floor and ``query_reach_kernels``) opens
     with 5 ms of settling calls and counts only the device events after
     a ``record_function`` marker: a trace can lose the kernel records of
     its first milliseconds
  6. per-kernel times at full size (CUDA events, L2 flushed between
     launches, and the kernels' own device time from a profiler trace) on
     inputs captured from one more Q = 64 traversal (B1-B3), one on the
     dense engine (B6, and B7 from one single-query traversal) and one
     Q = 64 probe of the phase-7 index (B4); B8 on the same probe's labels
     unpacked to 0/1 rows, and wide (``wide_*`` keys) on the labels of
     16,384 pairs of the index's live slots gathered and unpacked
     (``B8_WIDE_Q``), and on a 0/1 slab of that shape at density 0.3
     (``wide_dense_*`` keys); B5 on ``adj_packed`` and B9 on the dense view
     with the 1,024 lanes of one equal-mix batch's AddE/RemE slots (timed
     in place; the public wrappers copy the matrix first), and with the
     lanes of 16,384 (``wide_*`` keys: the global-scratch path); B5 and B9
     also against their plain versions there at B = cap + 1 and 65,536 on
     random lanes; ``wrapper_ms``: the public wrapper's wall, its copy of
     the matrix included. Beside them the
     plain versions' times and the bytes/operations bound, and each
     kernel's device time per sub-kernel (``device_sub_ms``); B6 also
     without parents on the same launches (``no_parents_*`` keys). B1 and
     B2 also on the Q = 1,024
     launches of one ``build_index`` over phase 7's landmarks (closure
     mode, no parents): every launch against its plain version, the 3
     largest timed (``q1024_*`` keys of the kernels line). B2's Q = 64 and
     Q = 1 launches are timed apart (the row's main numbers and its
     ``q1_*`` keys). B4 is its slot form, the one the sessions launch,
     also timed in turns with the gather and gathered-rows entry it
     replaced (``paired_*_ms`` keys), with the count
     of CUDA kernels one ``query_reach`` on the probe launches
     (``query_reach_kernels``, torch.profiler). Every row carries the
     launch floor: a one-element ``torch.zeros(1)`` fill's device ms and
     its back-to-back CUDA-events ms (``floor_device_ms``, ``floor_ms``)
  6b. the serial pass kernel (SP) at the benchmark's size: a Graph500
     SCALE 18 state at capacity 266,240 (``SP_*``; a block's slice of the
     slot table outgrows its 1,024 threads, so a thread owns two slots,
     and the free slots are such second slots), one update-mix batch
     (``UPDATE_MIX``) through ``apply_ops_fast`` equal to ``apply_ops``
     (one launch); then the launch alone on that batch's conflicting
     lanes, each of ``SP_REPS`` on a fresh copy of the state after the
     clean pass (CUDA events; the copy flushes L2), its device time from a
     profiler trace, the host pass on the same input, and the bytes bound
     of the lanes the launch applied; the kernels line's ``SP`` entry
  6c. the path walk kernel (PW) at the benchmark's size: a Graph500
     SCALE 18 state at capacity 266,240, one fused collect of Q = 64 pairs
     (sources of degree >= 1, as phase 3's), the launch against its plain
     version (``path_walk_ref``) bit for bit and the session's paths
     against the host walk the port made before (``parent_walk``: the
     whole forest home, ``extract_path`` and a key gather over V a pair);
     then the launch alone (CUDA events, L2 flushed, ``SP_REPS``), its
     device time from a profiler trace, the session's materialization on
     the host clock, the host walk and the plain version on host tensors,
     and the bytes bound of the paths; the kernels line's ``PW`` entry
  6d. a bare server's batch applied in place (``apply_ops_fast_``) beside
     the same batch applied to a copy (``apply_ops_fast``): a Graph500
     SCALE 18 state at capacity 266,240, one update-mix batch of
     ``LANES`` from the phase's seed; the two held against each other bit
     for bit (codes and six arrays), the in-place call's ``ops.apply``
     span (``in_place`` true, no ``ops.copy``); then both timed in turns,
     ``SP_REPS`` each (CUDA events and the host clock; the in-place one on
     a fresh copy of the state), each one's rise of
     ``max_memory_allocated`` over what was held, and each one's device
     launches (kernels, copies, fills) and device time from a profiler
     trace; one log line, ``inplace_apply``
  6e. the epoch ring's push at the benchmark's size: a Graph500 SCALE 18
     state at capacity 266,240 and the state one fused apply of the
     ingest cell's clients later (7 x 64 lanes of its mix, padded to
     512); ``EpochRing.push``'s record (rows, five patches, version
     vector) held byte for byte against the whole-mirror diff of the two
     states computed in the phase; then the push timed (CUDA events and
     the host clock, ``SP_REPS``, a fresh ring each) in turns with that
     whole-mirror diff, its device launches and time from a profiler
     trace, and its bytes bound (the four scalars of both states, the
     allocated slots' in-rows, both states' rows of the record, the
     version vector, the patch); one log line, ``ring_push``
  7. the reachability index at full size on the phase-3 state:
     ``build_index`` on the 1,024 highest-degree alive slots, computed here
     and passed as ``landmark_slots`` (``pick_landmarks`` follows the JAX
     package's order, which puts isolated vertices first: 18,756 of the
     65,536 keys at seed 0),
     refreshed with ``full_threshold=1.0`` so that no full refresh re-picks
     them (every refresh is incremental), then 4 rounds of a fresh
     ``reach_session`` (Q = 64), an equal-mix batch, a ``reach_session``
     on the stale index (must fall back) and a ``refresh``; then one AddE
     whose affected set is small, so that the refresh is incremental;
     last, one more equal-mix batch and a ``refresh`` at the default
     threshold, which must be full (a fresh ``pick_landmarks``) and equal
     ``build_index(state, 1024)``; the pinned index is what phases 5
     and 6 use. Every answer equals scipy's BFS on the state it was
     answered on; every refreshed index equals a full rebuild. The
     counts are read around the build and refreshes alone (B1 and B2 must
     have run there) and around the sessions alone (B4 by slot must have
     run there, and equals its plain version on the last probe), never
     around the verification rebuilds. No path serves
     through B8, as in the JAX package: its launches there are 0
  8. the multi-tenant serving path at full width, after phase 7 on the
     phase-3 end state: an ``IngestPool`` (retain 64 epochs, 1,024
     coalesced lanes) takes 48 admission rounds from 7 clients of 64-lane
     equal-mix batches (RemoveVertex lanes as HasVertex) and an 8th
     client's exclusive 16-lane batches holding RemoveVertex, one every
     4th round (r = 0 mod 4, so that none is queued in the starved
     rounds, r = 3 mod 4: an exclusive batch at the queue's head is
     admitted alone, and the mutator's commit would wait a round); between
     rounds one ``get_paths_session`` (Q = 64) with ``on_conflict=
     "epoch"``, starved in 4 rounds by a mutator that commits a round on
     each fetch (it then resolves at the pinned epoch); every 8 rounds
     ``state_at`` of the newest epoch less 1, of the last check's epoch
     (depth >= 8) and of the window's oldest equals the state published
     then in all six arrays, a session on the rebuilt state and the
     sessions equal scipy, ``epoch_diff`` equals a device compare of the
     two states, and epochs outside the window raise
     ``EpochEvictedError``; then ``build_index`` over the 1,024 hubs and a
     ``reach_session(ring=...)`` whose state fetch commits a round, which
     must serve pinned at the index's epoch through B4 and answer as
     scipy; then the pool's linearization replayed batch by batch through
     ``apply_ops_fast`` from epoch 0 (padded lanes) equals every ticket
     and the head in all six arrays, transpose invariant included; last,
     ``GraphCoServer(ingest=True, index=True)`` on a Graph500 SCALE-12
     graph loaded through its own ``submit``: 4 clients through
     ``submit_client``/``pump``, ``get_paths``, ``get_path`` (B3),
     ``get_reach`` stale and fresh, ``get_reach_counts``, ``get_reach_at``
     retained and evicted, ``epoch_diff``, ``index_tick``, degraded mode
     (reads pinned while the pool publishes, writes R_RECOVERING) and
     ``handle_crash`` without a WAL, ``get_metrics``; every answer equals
     scipy on the state it was answered on. Printed: round wall split
     into admit / fused apply / publish (ring push), lanes/s, the ring
     push's host bytes beside a full-state copy, ``state_at`` ms by
     depth, epoch-mode and time-travel session ms, coalescing, retries
     and waits, the records' host memory, peak device memory and the
     phase's launches (``serving_launches`` in the kernels line); B1, B2,
     B4 and B3 must have launched
  9. durable ingest at full width (``build/chip_smoke_durable/``, cleared
     at the start, removed after phase 10; the phase fails, naming the free
     space, when the disk holds less than it needs): (a) an ``IngestPool``
     on the phase-3 end state with a ``WriteAheadLog``, a
     ``GraphCheckpointer(keep=2)`` (a checkpoint at epoch 0, then one every
     8 rounds) and phase 8's client mix, 32 rounds with one crash per
     stage, in order ``wal-append``, ``wal-fsync``, ``ckpt-mid-write`` (at
     a cadence checkpoint) and ``post-publish-pre-ack``; after each,
     ``recover`` on the card: every acked batch is in the recovered
     linearization, the pre-crash linearization is its prefix, all six
     fields equal the pre-crash published state at its epoch
     (``torch.equal``), and the stage's own effect holds (a torn frame
     dropped and no epoch gained; one epoch gained; the previous step
     plus the WAL tail; the published round kept), then ``resume_pool``
     and on; (b) ``python -m repro_torch.launch.durable_serve`` at
     capacity 69,632 killed by SIGKILL after step 7 and recovered for 3
     more steps: return code -9, no acked batch lost, the recovered epoch
     at least the last acked one, serving resumed past it; (c) on the
     last recovered SCALE-16 state, a Q = 64 ``get_paths_session`` and a
     ``get_path_session`` equal scipy, with B1, B2 and B3 launched; (d)
     ``GraphCoServer(wal_dir=, ckpt_every=4)`` on phase 8's SCALE-12
     graph: a planned ``post-publish-pre-ack`` crash, reads pinned while
     degraded, writes R_RECOVERING, ``recover_now`` and ``handle_crash``
     keep all six fields bit for bit, the endpoints answer as scipy.
     Printed beside the card: the durable round wall by part (admit,
     fused apply, WAL append with fsync, publish) and lanes/s beside
     phase 8's, WAL bytes a record, checkpoint save wall and bytes,
     ``recover`` wall by part (checkpoint load, copy to the card, ring
     load, replay ms a record), the directory's filesystem type and free
     space, and the phase's launches (``durable_launches`` in the kernels
     line)
 10. the mesh-sharded graph on the card: phase 3's end state in 8 row
     blocks of 8,704 rows, all on ``cuda:0`` (``make_graph_mesh(shards=8)``);
     (a) ``partition.apply_ops_fast`` on phase 3's 8 batches beside the
     dense engine: codes and the six arrays after ``unshard`` equal; (b) on
     "hybrid_cuda" (B1 on each block's rows, B2 over its in-rows) a Q = 64
     ``get_paths_session`` retried under a mutator and a
     ``get_path_session``: answers equal scipy, ``multi_bfs`` equals the
     dense engine on every field, the Q = 1 traversal equals the dense
     single ``bfs``; (c) ``multi_bfs`` on "dense_cuda" (B6 on each block's
     unpacked rows) and "packed_cuda" equal the dense engine; (d)
     ``build_index`` on the sharded state over the 1,024 hubs equals the
     dense build, and a stale ``reach_session`` falls back to the sharded
     BFS and equals scipy; (e) ``IngestPool(mesh=)`` with its ring for 8
     rounds of phase 8's mix beside a dense pool (tickets and ``state_at``
     equal), ``GraphCoServer(mesh=)`` beside a dense server on phase 8's
     SCALE-12 graph (every endpoint answer and the ``get_metrics``
     counters equal), ``recover(mesh=)`` of phase 9's ``durable_serve``
     directory equal to the dense recover; (f) the legacy engines
     ``dapply_ops`` (equal to ``apply_ops``; AddVertex lanes as HasVertex,
     since their owner blocks are full), ``dbfs`` (equal to ``bfs``) and
     ``dget_path_session`` (equal to scipy) at the cell's width; (g)
     ``make_graph_mesh()`` is the one card, and its one-shard session
     equals the dense one. Printed beside the card: sharded and dense
     times of a batch, a Q = 64 session and a single session, supersteps
     and exchange bytes, launches a superstep, peak memory and the phase's
     wall; B1, B2 and B6 must launch on the sharded path
     (``sharded_launches`` in the kernels line)
 11. the LM co-serving path: qwen2-1.5b at its published width (28
     layers, d 1,536, 12 heads / 2 KV heads of 128, d_ff 8,960, vocab
     151,936, bf16, tied embeddings; 1.54 B params drawn on the card from a
     seeded ``torch.Generator``); (a) a prefill of 8 prompts of 512 tokens
     and 16 teacher-forced decode steps equal one ``forward`` of 528 tokens
     at every decoded position within LM_TOL (bf16), the argmax equal
     wherever the forward's top-2 margin exceeds twice it, every logit
     finite, and greedy decoding (64 tokens, cache 1,024) gives the same
     tokens in two runs; (b) ``serve()`` with that model on 8 x 512
     prompts, 64 new tokens, cache 1,024, co-serving phase 8's SCALE-12
     ``GraphCoServer(ingest=True, index=True)`` with ``clients=`` (4
     tenants' 64-lane equal-mix batches a step) and a ``query_stream`` (64
     pairs every 4th step, a lone pair on the others): the ``ServeStats``
     counters add up, the tokens equal the bare loop's, a ``get_reach``
     batch after it equals scipy, and B1, B2 and B4 launched inside
     ``serve()`` (``lm_serve_launches`` in the kernels line); (c) ``python
     -m repro_torch.launch.serve --no-smoke --ingest --batch 8 --prompt-len
     512 --new 64 --cache-len 1024`` exits 0 with its decode, ingest, ring
     tour and stale-index lines; (d) printed beside the card: prefill ms,
     decode step median and p90, tokens/s, the step's bound (weights and
     KV cache read once), the device idle share of one decode step and of
     one ``serve()`` step with graph traffic (phase 5's ``profiled``
     traces), peak device memory
 12. the remaining LM families at their published widths (bf16, params
     from a seeded ``torch.Generator`` on the card, each config's widths
     asserted; each model freed before the next): olmoe-1b-7b (64
     experts, top 8, qk-norm), granite-moe-3b-a800m (40 experts, top 8),
     mamba2-780m (48 SSD layers, chunk 128), recurrentgemma-9b ((rec,
     rec, local) x 12 + (rec, rec), MQA, window 2,048) and whisper-base
     (6 + 6 layers, 1,500 frames); (a) for each, a prefill of 8 prompts
     and 16 teacher-forced decode steps against one full forward within
     LM_TOL, argmax equal where the top-2 margin exceeds twice it (whisper:
     the decoder over ``encode`` of 1,500 seeded random frames, its self
     caches padded to 1,024); the prompts are 496 tokens for the MoE
     configs (512 tokens of forward keep every token: 512 x 8 = 4,096,
     the drop-free limit), 112 for mamba2 and whisper (128 of forward, a
     multiple of mamba2's chunk), 512 for recurrentgemma; (b) for
     olmoe-1b-7b, mamba2-780m and recurrentgemma-9b: greedy decoding (32
     tokens, cache 1,024) gives the same tokens in two runs, the decode
     step's median and p90 beside its bound (the weights outside the
     experts, the experts each step routed to, counted from the routing,
     and the caches or states, read once at 3.35 TB/s), then ``serve()``
     beside one SCALE-12 ``GraphCoServer(ingest=True, index=True)`` with
     phase 11's traffic: the ``ServeStats`` counters add up, the tokens
     equal the bare loop's, a ``get_reach`` after it equals scipy, and
     B1, B2 and B4 launched inside each ``serve()`` (their sum is
     ``lm_family_launches`` in the kernels line); (c) ``python -m
     repro_torch.launch.serve --arch mamba2-780m --no-smoke --ingest
     --batch 8 --prompt-len 512 --new 32 --cache-len 1024`` exits 0 with
     the lines phase 11 (c) requires; (d) the device idle share of one
     decode step of each served family (phase 5's ``profiled``), and each
     family's peak device memory
 13. the LM training path: qwen2-1.5b at its published width (phase 11's
     config, params from a seeded ``torch.Generator`` on the card); (a)
     ``repro_torch.runtime.train_loop.train`` on ``GraphPathData(seed=0)``
     with its graph on the card (every example's ``get_path`` runs B2:
     with 24 live vertices the direction test picks pull throughout, as
     in JAX), B = 8, S = 512, 6 steps,
     remat, lr 3e-4, one checkpoint at the last step under
     ``build/chip_smoke_train/`` (the phase fails, naming the free space,
     when the disk holds less than it needs): every loss finite, B2
     launched inside ``train()`` (``lm_train_launches`` in the kernels
     line); printed: the losses, the step wall median and p90 after the
     first step beside its bound (6 N T plus the causal attention products
     at the bf16 peak, against the optimizer's traffic), tokens/s, each
     batch's generation time, the checkpoint's bytes and save wall beside
     the directory's filesystem type, peak device memory; (b)
     ``Checkpointer.restore`` of that directory (JAX's stacked layout)
     equals the params, moments and step in memory bit for bit; the device
     idle share of one more train step (batch, step and loss read; phase
     5's ``profiled``); (c) at smoke width in f32 and bf16, a
     ``SimulatedFailure`` at step 3 of 6 and a resumed ``train()`` against
     an uninterrupted run within RESUME_TOL; (d) one ``make_train_step`` of
     the trunk kinds "moe" (granite-moe-3b-a800m), "ssm" (mamba2-780m) and
     "rec" (recurrentgemma-9b) at smoke shapes (f32) on the card against
     the same step on the CPU, within TRAIN_KIND_RTOL / TRAIN_KIND_GTOL;
     (e) ``python -m repro_torch.launch.train --arch qwen2-1.5b --smoke
     --data graph --steps 8`` exits 0 with its ``done; final loss`` line;
     the step-6 checkpoint stays for phase 14
 14. the LM mesh on DTensor: (a) ``Checkpointer.restore(shardings=)`` of
     phase 13's checkpoint onto the (1, 1) ("data", "model") mesh of
     ``launch.mesh.make_host_mesh`` (a one-process nccl group), every
     leaf's local tensor equal to its file bit for bit; then
     ``train(mesh=, shardings=)`` resumed from that checkpoint for 4 steps
     at qwen2-1.5b's full width on ``GraphPathData(seed=0)`` (B2 inside
     every batch; the step pins each gradient, ``make_train_step(
     grad_specs=)``) and the same 4 steps without a mesh: losses and
     params equal bit for bit, else the differing leaves printed and the
     loss held within MESH_LOSS_RTOL; B2 launched inside ``train(mesh=)``
     (``mesh_launches`` in the kernels line, with (b) and (c)); the step
     wall median, tokens/s and peak memory of both runs, and the device
     idle share of one more meshed step (phase 5's ``profiled``); (b) the
     three ``examples/*_torch.py`` as children on the card and with
     ``--device cpu``: rc 0, the same answer lines, B2 launched in the
     card children; (c) ``run_and_check`` of 50 schedules drawn by
     ``batch_lists_strategy`` (a read after each round) on an
     ``IngestPool`` on the card, every trace linearizable, and
     ``shrink_schedule`` shrinking a deliberately broken check's failing
     schedule to a smaller one that still fails; (d) ``python -m
     repro_torch.launch.dryrun --subprocess`` of qwen2-1.5b train_4k /
     prefill_32k / decode_32k and olmoe-1b-7b train_4k on the single (16
     x 16) mesh of fake ranks, with no device, beside (a)-(c): every
     record ok, its per-device memory, FLOPs and collective bytes printed

It imports nothing of JAX and nothing of the JAX package. It exits non-zero
without a result when no CUDA device is present or the port is missing.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SCALE = 16
EDGEFACTOR = 16
CAPACITY = 69_632            # 2**16 keys + 4,096 free slots for re-adds
LANES = 1024
QUERIES = 64
ROUNDS = 8
INDEX_LANDMARKS = 1024
INDEX_ROUNDS = 4
DENSE_ROUNDS = 4
SERVE_ROUNDS = 48            # phase 8: admission rounds on the cell's state
SERVE_CLIENTS, SERVE_LANES = 7, 64
SERVE_EXCL_LANES = 16        # the 8th client's exclusive (RemoveVertex) batches
SERVE_RETAIN, SERVE_COALESCE = 64, 1024
SERVE_CHECK_EVERY = 8
SERVE_STARVE = (3, 15, 27, 39)   # rounds whose session a mutator starves
SERVE_MAX_ROUNDS = 3
SERVER_SCALE, SERVER_CAPACITY = 12, 4160
SERVER_CLIENTS, SERVER_ROUNDS, SERVER_RETAIN = 4, 10, 8
SERVER_LANDMARKS, SERVER_LOAD_LANES = 256, 8192
DURABLE_ROUNDS, DURABLE_CKPT_EVERY, DURABLE_KEEP = 32, 8, 2
# (round a crash stage is armed in, stage): each fires in that round,
# ckpt-mid-write at the first cadence checkpoint after it (round 21)
DURABLE_CRASHES = ((2, "wal-append"), (5, "wal-fsync"),
                   (14, "ckpt-mid-write"), (26, "post-publish-pre-ack"))
DURABLE_DIR = ROOT / "build" / "chip_smoke_durable"
# the child's keep=3 checkpoints and one being written, ~1.9 GB each; part
# (a) needs 2 + a torn one and is removed before the child starts
DURABLE_NEED_BYTES = 8 << 30
DURABLE_CHILD_STEPS, DURABLE_CHILD_CRASH, DURABLE_CHILD_RESUME = 12, 7, 3
DURABLE_CHILD_CLIENTS, DURABLE_CHILD_CKPT_EVERY = 8, 4
DURABLE_SERVER_CKPT_EVERY = 4
SHARDS = 8                   # phase 10: row blocks of the sharded state
SHARD_SERVE_ROUNDS = 8       # phase 10(e): pool rounds beside the dense pool
SHARD_REPS = 3               # phase 10(b): timed sessions of each engine
SHARD_KERNELS = ("B1", "B2", "B6")
LM_ARCH = "qwen2-1.5b"        # phase 11: the launcher's default arch
LM_BATCH, LM_PROMPT, LM_NEW, LM_CACHE = 8, 512, 64, 1024
LM_CHECK_STEPS = 16          # teacher-forced decode steps held against forward
# bf16 decode against the full forward: both round every product and
# activation to bf16 (2**-8 relative), in other GEMM shapes and sum orders,
# through 28 layers; logits of the random model are O(1)
LM_TOL = 0.125
LM_TENANTS, LM_QUERY_BATCH = 4, 64
LM_CHILD_TIMEOUT_S = 300
LM_SMOKE = False             # True only to rehearse phases 11 and 12 on the CPU
# phase 12: each remaining LM family at its published width (bf16), the
# widths asserted as the configs publish them
FAMILY_WIDTHS = {
    "olmoe-1b-7b": dict(family="moe", n_layers=16, d_model=2048, n_heads=16,
                        n_kv=16, hd=128, vocab=50304, n_experts=64, top_k=8,
                        expert_ff=1024, qk_norm=True, dtype="bfloat16"),
    "granite-moe-3b-a800m": dict(family="moe", n_layers=32, d_model=1536,
                                 n_heads=24, n_kv=8, hd=64, vocab=49155,
                                 n_experts=40, top_k=8, expert_ff=512,
                                 dtype="bfloat16"),
    "mamba2-780m": dict(family="ssm", n_layers=48, d_model=1536, vocab=50280,
                        ssm_state=128, ssm_conv=4, ssm_headdim=64,
                        ssm_expand=2, ssm_chunk=128, dtype="bfloat16"),
    "recurrentgemma-9b": dict(family="hybrid", n_layers=38, d_model=4096,
                              n_heads=16, n_kv=1, hd=256, d_ff=12288,
                              vocab=256000, sliding_window=2048,
                              block_pattern=("rec", "rec", "attn_local"),
                              d_lru=4096, mlp_act="gelu", dtype="bfloat16"),
    "whisper-base": dict(family="encdec", n_layers=6, enc_layers=6,
                         enc_frames=1500, d_model=512, n_heads=8, n_kv=8,
                         hd=64, d_ff=2048, vocab=51865, mlp_act="gelu",
                         norm_type="layernorm", dtype="bfloat16"),
}
# the prompt of phase 12's decode-against-forward check and of its serve():
# a MoE forward of 496 + 16 tokens keeps every token (gs * k = 4,096, the
# drop-free limit), mamba2's 112 and 128 are multiples of its chunk or
# below it, recurrentgemma's 528 stays inside its window of 2,048
FAMILY_PROMPT = {"olmoe-1b-7b": 496, "granite-moe-3b-a800m": 496,
                 "mamba2-780m": 112, "recurrentgemma-9b": 512,
                 "whisper-base": 112}
# phase 12's tolerance of bf16 decode against the forward (max |diff| of
# the logits) where LM_TOL does not hold, each held beside the same check
# of the f32 model (the same draws, unrounded) at rtol = atol = 5e-3. The
# run also measures the bf16 forward's own distance from the f32 forward.
# - MoE: bf16 rounding of the forward's and the decode's products moves the
#   router enough to pick another expert on ~10% of the (token, layer)
#   top-8 decisions (219 of 2,048 for olmoe-1b-7b, 460 of 4,096 for
#   granite-moe-3b-a800m, counted by the run); decode then differs by up
#   to 0.434 / 0.246, the bf16 forward from the f32 one by 0.377 / 0.262.
#   In f32 no decision moves and the f32 check holds (1.0e-5).
# - recurrentgemma-9b: the bf16 forward is itself 0.535 from the f32
#   forward (38 layers of random weights, logits up to ~8); decode is
#   0.352 from the bf16 forward; f32 decode holds at 1.7e-4.
# - mamba2-780m (None): 48 SSD layers of random weights amplify rounding
#   chaotically (the bf16 forward is 5.68 from the f32 one), so no
#   tolerance is meaningful for the whole bf16 model: JAX's own bf16
#   decode differs from its forward by 5.19 (logits up to 4.06) and its
#   f32 decode by 0.056 at this width (B = 2, the JAX package on a CPU).
#   Held instead: the first SSD layer's bf16 decode against its chunked
#   forward on the same inputs, and the f32 model's decode against its
#   forward at LM_TOL (FAMILY_F32_TOL; 0.027 measured)
# (measured by this script on NVIDIA H100 80GB HBM3, 700.00 W)
FAMILY_TOL = {"olmoe-1b-7b": 0.625, "granite-moe-3b-a800m": 0.625,
              "recurrentgemma-9b": 0.5, "mamba2-780m": None}
F32_TOL = 5e-3               # rtol = atol, as tests/test_models_smoke.py
SSM_LAYER_RTOL = 1 / 64      # bf16 keeps 8 bits: 1/256 a rounding
FAMILY_F32_TOL = {"mamba2-780m": (LM_TOL, 0.0)}
FAMILY_SERVED = ("olmoe-1b-7b", "mamba2-780m", "recurrentgemma-9b")
FAMILY_NEW = 32              # phase 12's greedy and serve() decode steps
FAMILY_CHILD = "mamba2-780m"
# phase 13: the LM training path, qwen2-1.5b at its published width
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 512, 6, 3e-4
TRAIN_DIR = ROOT / "build" / "chip_smoke_train"
TRAIN_NEED_BYTES = 24 << 30     # the 15.4 GB checkpoint and the child's
BF16_PEAK_OPS_PER_S = 989e12    # bf16 tensor cores, dense
# (c): crash at step 3 of 6 with a checkpoint every 2 steps, at smoke width
# on GraphPathData(n_vertices=8); the resumed run against an uninterrupted
# one. f32: 1% of one lr = 1e-3 Adam step; bf16: an Adam step moves an
# element by ~lr, so a last-update direction or rounding that a
# non-deterministic reduction moves shifts it by up to 2 lr plus one bf16
# ulp (2**-8 of |p| <= 0.5)
RESUME_STEPS, RESUME_CRASH, RESUME_EVERY, RESUME_LR = 6, 3, 2, 1e-3
RESUME_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (4e-3, 1e-2)}  # params, loss
# (d): one train step of each trainable trunk kind, card against CPU, f32:
# loss within TRAIN_KIND_RTOL, each first-moment (gradient) leaf within
# TRAIN_KIND_GTOL of its max, each param within 1e-5 except where the first
# Adam step's direction is undetermined (|g| within TRAIN_KIND_GTOL of 0:
# up to 2.2 lr)
TRAIN_KINDS = {"moe": "granite-moe-3b-a800m", "ssm": "mamba2-780m",
               "rec": "recurrentgemma-9b"}
TRAIN_KIND_RTOL, TRAIN_KIND_GTOL = 1e-4, 1e-3
TRAIN_CHILD_STEPS = 8
# phase 14: the LM mesh. (a) resumes phase 13's checkpoint for MESH_STEPS
# steps (three step walls after the first) on the (1, 1) mesh and without
# it: equal bit for bit (every collective of a one-rank mesh is the
# identity), else the differing leaves printed with their largest
# difference and the loss held within MESH_LOSS_RTOL; (b) the examples;
# (c) MESH_SCHEDULES schedules; (d) the dry-run cells, children capped at
# MESH_DRY_TIMEOUT_S (they run beside (a)-(c))
MESH_DIR = ROOT / "build" / "chip_smoke_mesh"
MESH_STEPS = 4
MESH_LOSS_RTOL = 1e-6
MESH_EXAMPLES = ("quickstart", "distributed_graph", "serve_graph_queries")
MESH_CHILD_TIMEOUT_S = 300
MESH_SCHEDULES = 50
MESH_POOL_CAPACITY = 32
MESH_DRY_CELLS = ("qwen2-1.5b:train_4k", "qwen2-1.5b:prefill_32k",
                  "qwen2-1.5b:decode_32k", "olmoe-1b-7b:train_4k")
MESH_DRY_TIMEOUT_S = 240
CLOSURE_SCALE, CLOSURE_CAPACITY, CLOSURE_Q = 12, 4160, 256
COMPLETE_SCALE, COMPLETE_CAPACITY, COMPLETE_PAIRS = 10, 1088, 1024
WIDE_QS = (1024, 1025)       # the index closures' Q, and a ragged group
DENSE_QS = (64, 65, 129)     # B6 over one, two and three query groups
# (V, skewed): from V = 16,385 on, Q / 32 x 128-word column blocks fills
# 132 SMs, so B1's closure launches take its query-grouped form
WIDE_VS = ((2048, False), (20480, True), (20001, True))
# B3's frontier cases: W = 63 and 626 (not a multiple of 4), 2,176 (the
# cell's), and 2,813 (two of B3's 81,920-row frontier passes)
SINGLE_VS = (2000, 20001, 69632, 90000)
WIDE_TIMED = 3               # Q = 1,024 launches timed per kernel in phase 6
WIDE_BUDGET = 1 << 30        # the plain versions' transient at Q = 1,024
BFS_KERNELS = ("B1", "B2", "B3")
DENSE_KERNELS = ("B6", "B7")
EDGE_KERNELS = ("B5", "B9")
WIDE_EDGE_LANES = 16384      # B5/B9's global-scratch path, timed in phase 6
MIX = (12.5, 12.5, 25, 12.5, 12.5, 25)   # AddV RemV HasV AddE RemE HasE
# phase 6b: the serial pass at the benchmark's g500-s18 size, under the
# paper's update-intensive mix
SP_SCALE = 18
SP_CAPACITY = 266_240        # 2**18 keys + 4,096 free slots
SP_CHURN = 4_096             # AddV / RemV keys: the top 2,048 loaded, 2,048 new
SP_REPS = 6
SP_THREADS = 1024             # kernel.cu's THREADS: the slots a block reads at once
UPDATE_MIX = (22.5, 22.5, 5, 22.5, 22.5, 5)
DEVICE = "cuda"
TRACE_DIR = ROOT / "build" / "chip_smoke_traces"
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
ALU_OPS_PER_S = 67e12        # float32 outside the tensor cores (32-bit ALU)
INT8_OPS_PER_S = 1979e12     # int8 tensor cores, dense (a MAC is 2 ops)


def log(*a):
    print(*a, flush=True)


def sync(torch):
    if DEVICE == "cuda":
        torch.cuda.synchronize()


# ----------------------------------------------------------------------------
# Data
# ----------------------------------------------------------------------------
def graph500_edges(scale: int, edgefactor: int, rng):
    """The Graph500 Kronecker generator (reference kronecker_generator):
    R-MAT bits with A=0.57, B=0.19, C=0.19, then a random relabelling of the
    vertices and a shuffle of the edges. Returns (u, v) int64 arrays."""
    n, m = 1 << scale, edgefactor << scale
    a, b, c = 0.57, 0.19, 0.19
    ab, c_norm, a_norm = a + b, c / (1 - (a + b)), a / (a + b)
    u = np.zeros(m, np.int64)
    v = np.zeros(m, np.int64)
    for ib in range(scale):
        ii = rng.random(m) > ab
        jj = rng.random(m) > np.where(ii, c_norm, a_norm)
        u |= ii.astype(np.int64) << ib
        v |= jj.astype(np.int64) << ib
    perm = rng.permutation(n)
    order = rng.permutation(m)
    return perm[u][order], perm[v][order]


def pack_edges(rows, cols, cap: int) -> np.ndarray:
    """uint32[cap, ceil(cap/32)] words with bit (r, c) set for each
    (distinct) edge."""
    w = -(-cap // 32)
    idx = rows * w + cols // 32
    bits = np.left_shift(np.uint32(1), (cols % 32).astype(np.uint32))
    order = np.argsort(idx, kind="stable")
    idx, bits = idx[order], bits[order]
    starts = np.flatnonzero(np.r_[True, idx[1:] != idx[:-1]])
    words = np.zeros(cap * w, np.uint32)
    words[idx[starts]] = np.bitwise_or.reduceat(bits, starts)
    return words.reshape(cap, w)


def graph500_state_arrays(scale: int, cap: int, rng):
    """The six state arrays of a Graph500 graph: keys 0..n-1 in slots
    0..n-1, vver 1 on live slots, ecnt = distinct out-degree (what AddE
    lanes would leave: duplicate edges collapse, self-loops stay)."""
    n = 1 << scale
    u, v = graph500_edges(scale, EDGEFACTOR, rng)
    e = np.unique(u * n + v)
    u, v = e // n, e % n
    vkey = np.full(cap, -1, np.int32)
    vkey[:n] = np.arange(n, dtype=np.int32)
    valive = np.zeros(cap, np.bool_)
    valive[:n] = True
    vver = valive.astype(np.int32)
    ecnt = np.bincount(u, minlength=cap).astype(np.int32)
    return (vkey, valive, vver, ecnt, pack_edges(u, v, cap),
            pack_edges(v, u, cap)), len(e)


def equal_mix(rng, n_keys: int, lanes: int):
    """(opcodes, key1, key2) of ``lanes`` lanes of the paper's "equal" mix,
    keys uniform."""
    from repro_torch.core import (OP_ADD_E, OP_ADD_V, OP_CON_E, OP_CON_V,
                                  OP_REM_E, OP_REM_V)

    ops = np.array([OP_ADD_V, OP_REM_V, OP_CON_V, OP_ADD_E, OP_REM_E,
                    OP_CON_E], np.int32)
    opc = rng.choice(ops, size=lanes, p=np.array(MIX) / 100)
    return opc, rng.integers(0, n_keys, lanes), rng.integers(0, n_keys, lanes)


def equal_mix_batch(rng, n_keys: int, device, lanes: int = LANES):
    from repro_torch.convert import op_batch_from_numpy

    opc, k1, k2 = equal_mix(rng, n_keys, lanes)
    return op_batch_from_numpy(opc, k1, k2, np.full(lanes, -1), device)


def random_words(rng, v: int, density: float):
    """(bool[v, v] adjacency as packed uint32 words) with extra edges in
    columns 31 and 63 (the int32 sign bit of a word)."""
    bits = rng.random((v, v)) < density
    bits[0, 31] = bits[v // 2, 31] = bits[v - 1, 63] = True
    padded = np.zeros((v, -(-v // 32) * 32), np.bool_)
    padded[:, :v] = bits
    return np.packbits(padded, axis=1, bitorder="little").view(np.uint32)


# ----------------------------------------------------------------------------
# Timing
# ----------------------------------------------------------------------------
class Timer:
    """Per-launch device time from CUDA events, with L2 flushed between
    launches (a 64 MiB write) and the flush's own time subtracted."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8,
                                     device="cuda")
        self.flush_ms = self._raw(lambda: None, 20)

    def _raw(self, fn, reps):
        torch = self.torch
        fn()
        self.flush_buf.zero_()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            self.flush_buf.zero_()
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def ms(self, fn, reps):
        return max(0.0, self._raw(fn, reps) - self.flush_ms)

    def device_ms(self, fn, reps):
        """(per-call device time of the port's own kernels and memsets that
        ``fn`` launches, {sub-kernel: per-call ms}) from a torch.profiler
        trace (PyTorch's kernels and copies, the flush among them, left
        out); (None, {}) when the trace holds no device events. Unlike
        ``ms`` it leaves out the time the card waits for the host to
        enqueue the next launch."""
        def run():
            for _ in range(reps):
                self.flush_buf.zero_()
                fn()

        _, path = profiled(self.torch, run, "kernel_time")
        _, per_name = _busy_ms(path)
        own = {k: v / reps for k, v in per_name.items()
               if not k.startswith(("at::", "Memcpy"))}
        if not per_name:
            return None, {}
        return sum(own.values()), own


# ----------------------------------------------------------------------------
# Phases
# ----------------------------------------------------------------------------
def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch: {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"build: {len(paths)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, so in paths.items():
        log_file = so.with_suffix(".log")
        lines = log_file.read_text().splitlines() if log_file.exists() else []
        regs = [ln.split("info    : ")[-1] for ln in lines if "registers" in ln]
        spills = [ln.strip() for ln in lines if "spill" in ln
                  and not re.search(r"\b0 bytes spill stores, 0 bytes spill", ln)]
        log(f"  {name}: " + " | ".join(regs)
            + (f"; spills: {spills}" if spills else "; no spills"))
    return card


def phase_analysis(card: str) -> None:
    """1a: the port's linter as a child, the import preflight of every
    module of the port, and the build's ptxas report against each
    package's KERNEL_META. The child runs while this process checks the
    rest. A failed check ends the run."""
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis", "--root", str(ROOT)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        from repro_torch.analysis import modwalk, ptxas
        from repro_torch.kernels import _build

        rows, failures = ptxas.check_build(
            {n: _build.library_path(n) for n in _build.PACKAGES})
        t_ptxas = time.perf_counter() - t0
        mods = [m for m, _ in modwalk.iter_package_modules(
            ROOT / "src" / "repro_torch", "repro_torch")
            if not m.endswith(".__main__")]
        errors = modwalk.preflight_imports(mods)
        t_imports = time.perf_counter() - t0 - t_ptxas
        out, _ = child.communicate(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if child.returncode != 0:
        raise AssertionError(f"python -m repro_torch.analysis exited "
                             f"{child.returncode}:\n{out}")
    log(f"analysis: {out.strip().splitlines()[-1]} (child, "
        f"{time.perf_counter() - t0:.1f} s)")
    if errors:
        raise AssertionError("modules of repro_torch do not import:\n"
                             + "\n".join(errors))
    log(f"analysis: all {len(mods)} modules of repro_torch import "
        f"({t_imports:.1f} s)")
    for row in rows:
        log(f"  ptxas {ptxas.render(row)} [{card}]")
    if failures:
        raise AssertionError("the ptxas report disagrees with KERNEL_META:"
                             "\n" + "\n".join(failures))
    log(f"analysis: {len(rows)} kernels of {len(_build.PACKAGES)} libraries "
        f"match their KERNEL_META ({t_ptxas:.1f} s); phase "
        f"{time.perf_counter() - t0:.1f} s")


def _counters():
    """kernel -> (its wrappers' module, the name of its launch count)."""
    from repro_torch.kernels.bfs_multi_step import ops as b1
    from repro_torch.kernels.bfs_pull_step import ops as b2
    from repro_torch.kernels.bfs_step import ops as b3
    from repro_torch.kernels.edge_update import ops as eu
    from repro_torch.kernels.label_join import ops as lj

    return {"B1": (b1, "launches"), "B2": (b2, "launches"),
            "B3": (b3, "launches"), "B4": (lj, "slot_launches"),
            "B5": (eu, "packed_launches"), "B6": (b1, "dense_launches"),
            "B7": (b3, "dense_launches"), "B8": (lj, "dense_launches"),
            "B9": (eu, "dense_launches")}


def reset_counts():
    for m, attr in _counters().values():
        setattr(m, attr, 0)


def counts():
    return {k: getattr(m, attr) for k, (m, attr) in _counters().items()}


def counted(total, fn):
    """``fn()`` with every count set to 0 just before it; the launches it
    made are added to ``total`` just after."""
    reset_counts()
    out = fn()
    for k, v in counts().items():
        total[k] += v
    return out


def require_launched(n, keys, where):
    missing = [k for k in keys if n[k] == 0]
    if missing:
        raise AssertionError(f"{missing} never ran {where}: {n}")


def same(got, want, what):
    """Outputs equal bit for bit; ``None`` (no parents asked for) only
    matches ``None``."""
    for x, y in zip(got, want, strict=True):
        if (x is None) != (y is None) or (x is not None and not x.equal(y)):
            raise AssertionError(f"kernel != plain: {what}")


def edge_lanes(rng, v: int, b: int, device):
    """rows, cols, vals, mask int32[b] of edge writes: lane 0 fires on
    column 31 (the int32 sign bit), the last three lanes repeat its target
    (the last firing one must win), masked lanes (mask <= 0) are partly
    parked out of range, and values lie outside {0, 1} too."""
    import torch

    rows = rng.integers(0, v, b)
    cols = rng.integers(0, v, b)
    cols[0] = 31
    vals = rng.choice([0, 1, 2, 7, 255, 256, -1], b)
    mask = rng.choice([0, 1, 3, -2], b)
    mask[0] = 1
    if b > 4:
        rows[-3:], cols[-3:] = rows[0], cols[0]
        mask[-1] = 1
    off = mask <= 0
    rows[off & (rng.random(b) < 0.5)] = 10**6
    cols[off & (rng.random(b) < 0.5)] = -10**6
    return [torch.from_numpy(x.astype(np.int32)).to(device)
            for x in (rows, cols, vals, mask)]


def edge_patterns(rng, v: int):
    """name -> rows, cols, vals, mask (numpy int32) of adversarial
    edge-write lanes on a v x v graph (W = ceil(v / 32) words a row)."""
    from repro_torch.kernels.edge_update.ops import one_block_lanes

    w = -(-v // 32)
    b = 1024
    out = {}
    # every firing lane on one cell in column 31 (the sign bit), set and
    # clear in turns; every third lane and the last masked, parked far off
    rows, cols = np.full(b, v // 3), np.full(b, 31)
    mask = np.ones(b)
    mask[2::3] = mask[-1] = 0
    rows[mask == 0], cols[mask == 0] = 10**6, -10**6
    vals = np.zeros(b)
    vals[mask > 0] = np.resize([1, 0], int(mask.sum()))
    out["one target"] = (rows, cols, vals, mask)
    # the 32 bits of 32 words of one row set, then cleared by later lanes
    # in another order (2,048 lanes)
    out["32 words set then cleared"] = (
        np.full(2048, v - 2),
        np.concatenate([rng.permutation(1024), rng.permutation(1024)]),
        np.repeat([255, 0], 1024), np.ones(2048))
    # every lane on one row, each on a column of its own
    out["one row"] = (np.full(v, 5), rng.permutation(v),
                      rng.choice([0, 1, 2, 255], v), np.ones(v))
    # no lane fires
    out["all masked"] = (rng.integers(-5, v + 5, b), rng.integers(-5, v + 5, b),
                         rng.choice([0, 1, 7], b), rng.choice([0, -2], b))
    # firing lanes past the last column of the dense row and of the packed
    # one (lane 1: column v, past the dense row alone) beside in-range
    # ones; the last three repeat lane 0's target
    rows, cols = rng.integers(0, v, b), rng.integers(0, v, b)
    rows[-3:], cols[-3:] = rows[0], cols[0]
    far = rng.random(b) < 0.5
    far[:1] = far[-3:] = False
    cols[far] = 32 * w + rng.integers(0, 10**6, int(far.sum()))
    rows[1], cols[1] = v - 1, v
    out["columns out of range"] = (rows, cols, rng.choice([0, 1, 7], b),
                                   rng.choice([0, 1], b, p=[0.1, 0.9]))
    out["B = 0"] = tuple(np.zeros(0) for _ in range(4))
    cap = one_block_lanes()
    for n in (cap, cap + 1):
        rows, cols = rng.integers(0, v, n), rng.integers(0, v, n)
        hot = rng.random(n) < 0.3                # many duplicate targets
        rows[hot], cols[hot] = rng.integers(0, 4, (2, int(hot.sum())))
        out[f"B = {n}"] = (rows, cols, rng.choice([0, 1, 2, 255, -1], n),
                           rng.choice([0, 1, -2], n))
    return {k: tuple(np.asarray(x).astype(np.int32) for x in x4)
            for k, x4 in out.items()}


def phase_kernels(torch, rng, rng2, rng3, rng4):
    """Every kernel against its plain version on the card, bit for bit.
    The dense and edge-write cases draw from ``rng2``, so that ``rng``
    leaves this phase where the packed cases alone leave it (the later
    phases' graphs do not depend on those cases), the dense cases over
    several query groups from ``rng3`` and the adversarial edge writes
    from ``rng4``, so that ``rng2`` leaves it where it did before them."""
    from repro_torch.core.graph import pack_bits
    from repro_torch.kernels.bfs_multi_step.ops import (
        multi_bfs_step_packed_kernel)
    from repro_torch.kernels.bfs_multi_step.ref import (
        multi_bfs_step_packed_ref)
    from repro_torch.kernels.bfs_pull_step.ops import bfs_pull_step_rows
    from repro_torch.kernels.bfs_pull_step.ref import bfs_pull_step_ref
    from repro_torch.kernels.bfs_step.ops import bfs_step_packed_kernel
    from repro_torch.kernels.bfs_step.ref import bfs_step_packed_ref

    dev = DEVICE
    cases = edge_cases = 0
    for v in (2000, 2048):
        for dens in (0.0, 0.01, 0.3):
            adj_np = random_words(rng, v, dens)
            adj = torch.from_numpy(adj_np.view(np.int32)).to(dev)
            bits = torch.from_numpy(np.unpackbits(
                adj_np.view(np.uint8), axis=1, bitorder="little")[:, :v]
                .astype(np.bool_)).to(dev)
            adj_in = pack_bits(bits.T.contiguous())
            alive = torch.from_numpy(rng.random(v) < 0.9).to(dev)
            for q in (1, 5, 16, 70):        # 70: B2's second query group
                fr = torch.from_numpy(rng.random((q, v)) < 0.05).to(dev)
                fr[0, 0] = True
                if q > 1:
                    fr[-1] = False          # an empty frontier
                vis = torch.from_numpy(rng.random((q, v)) < 0.3).to(dev)
                args = (fr, adj, alive, vis)
                same(multi_bfs_step_packed_kernel(*args),
                     multi_bfs_step_packed_ref(*args), f"B1 v={v} q={q}")
                r0, r1 = v // 4, v // 4 + 700    # a row slice, R < V
                sl = (fr[:, r0:r1].contiguous(), adj[r0:r1], alive, vis)
                same(multi_bfs_step_packed_kernel(*sl),
                     multi_bfs_step_packed_ref(*sl), f"B1 slice v={v}")
                fw = pack_bits(fr & alive[None, :])
                pa = (fw, adj_in, alive, vis)
                same(bfs_pull_step_rows(*pa), bfs_pull_step_ref(*pa),
                     f"B2 v={v} q={q}")
                ps = (fw, adj_in[r0:r1], alive[r0:r1],
                      vis[:, r0:r1].contiguous())
                same(bfs_pull_step_rows(*ps), bfs_pull_step_ref(*ps),
                     f"B2 slice v={v}")
                sa = (fr[0], adj, alive, vis[0])
                same(bfs_step_packed_kernel(*sa),
                     bfs_step_packed_ref(*sa), f"B3 v={v}")
                dense_cases(torch, fr, bits, alive, vis, (r0, r1), v)
                cases += 1
            patterns = edge_patterns(rng4, v)
            edge_cases += edge_update_cases(torch, rng2, adj, bits, v,
                                            patterns)
    v = 2001                                # rows not 4-byte aligned
    bits = torch.from_numpy(rng2.random((v, v)) < 0.01).to(dev)
    bits[0, 31] = True
    alive = torch.from_numpy(rng2.random(v) < 0.9).to(dev)
    for q in (1, 5, 16, 70):
        fr = torch.from_numpy(rng2.random((q, v)) < 0.05).to(dev)
        fr[0, 0] = True
        vis = torch.from_numpy(rng2.random((q, v)) < 0.3).to(dev)
        dense_cases(torch, fr, bits, alive, vis, (501, 1201), v)
        cases += 1
    # the dense kernels over one, two and three query groups, on a hub
    # column (every row hits it) and rows with every 16-byte chunk
    # nonzero, sliced from an odd row; V = 2048 takes the 16-byte loads,
    # V = 2001 the byte-wise tail
    for v in (2048, 2001):
        bits = torch.from_numpy(rng3.random((v, v)) < 0.01).to(dev)
        bits[:, v - 7] = True
        full = torch.from_numpy(rng3.choice(v, 64, replace=False)).to(dev)
        bits[full, 5::16] = True
        alive = torch.from_numpy(rng3.random(v) < 0.9).to(dev)
        alive[v - 7] = True
        for q in DENSE_QS:
            fr = torch.from_numpy(rng3.random((q, v)) < 0.05).to(dev)
            fr[:, full[:8]] = True
            vis = torch.from_numpy(rng3.random((q, v)) < 0.3).to(dev)
            dense_cases(torch, fr, bits, alive, vis, (333, 1555), v)
            cases += 1
    sync(torch)
    log(f"kernels vs plain: {cases} cases x (B1, B1 slice, B2, B2 slice, "
        f"B3, B6, B6 slice, B7, B6 and its slice without parents; at "
        f"V = 2001 and Q in {DENSE_QS} the dense ones alone) and "
        f"{edge_cases} edge-write cases x (B5, B9) bit-identical "
        f"(tolerance 0; patterns: {', '.join(patterns)})")


def dense_cases(torch, fr, bits, alive, vis, rows, v):
    """B6 (full and a row slice, with and without parents) and B7 against
    their plain versions."""
    from repro_torch.kernels.bfs_multi_step.ops import multi_bfs_step
    from repro_torch.kernels.bfs_multi_step.ref import multi_bfs_step_ref
    from repro_torch.kernels.bfs_step.ops import bfs_step
    from repro_torch.kernels.bfs_step.ref import bfs_step_ref

    dense = bits.to(torch.uint8)
    q = fr.shape[0]
    r0, r1 = rows
    full = (fr, dense, alive, vis)
    sl = (fr[:, r0:r1].contiguous(), dense[r0:r1], alive, vis)
    for args, what in ((full, f"B6 v={v} q={q}"),
                       (sl, f"B6 slice {r0}:{r1} v={v} q={q}")):
        same(multi_bfs_step(*args), multi_bfs_step_ref(*args), what)
        same(multi_bfs_step(*args, parents=False),
             multi_bfs_step_ref(*args, parents=False),
             f"{what} without parents")
    sa = (fr[0], dense, alive, vis[0])
    same(bfs_step(*sa), bfs_step_ref(*sa), f"B7 v={v}")


def edge_update_cases(torch, rng, adj, bits, v, patterns):
    """B5 on the packed words and B9 on the dense matrix against their
    plain versions, at B = 1 and 1,024 random lanes and on ``patterns``
    (``edge_patterns``); returns the case count."""
    dense = bits.to(torch.uint8)
    ecnt = torch.from_numpy(rng.integers(0, 5, v).astype(np.int32)).to(
        DEVICE)
    cases = {f"b={b}": edge_lanes(rng, v, b, DEVICE) for b in (1, 1024)}
    cases.update({k: [torch.from_numpy(x).to(DEVICE) for x in lanes]
                  for k, lanes in patterns.items()})
    for what, lanes in cases.items():
        edge_check(adj, dense, ecnt, lanes, f"v={v} {what}")
    return len(cases)


def edge_check(words, dense, ecnt, lanes, what):
    """B5 on ``words`` and B9 on ``dense`` through their public wrappers
    against their plain versions, bit for bit."""
    from repro_torch.kernels.edge_update.ops import (edge_update,
                                                     edge_update_packed)
    from repro_torch.kernels.edge_update.ref import (edge_update_packed_ref,
                                                     edge_update_ref)

    same(edge_update_packed(words, ecnt, *lanes),
         edge_update_packed_ref(words, ecnt, *lanes), f"B5 {what}")
    same(edge_update(dense, ecnt, *lanes),
         edge_update_ref(dense, ecnt, *lanes), f"B9 {what}")


def phase_index_kernels(torch, rng):
    """The kernels at the index's shapes against their plain versions, bit
    for bit: B1 and B2 at the closures' Q = 1024; B4 and B8, and B4 == B8
    on the same labels packed and unpacked; B4 by slot, and equal to B4 on
    the rows it gathers."""
    from repro_torch.core.graph import pack_bits
    from repro_torch.kernels.bfs_multi_step.ops import (
        multi_bfs_step_packed_kernel)
    from repro_torch.kernels.bfs_multi_step.ref import (
        multi_bfs_step_packed_ref)
    from repro_torch.kernels.bfs_pull_step.ops import bfs_pull_step_rows
    from repro_torch.kernels.bfs_pull_step.ref import bfs_pull_step_ref
    from repro_torch.kernels.label_join.ops import (label_join,
                                                    label_join_packed,
                                                    label_join_slots)
    from repro_torch.kernels.label_join.ref import (label_join_packed_ref,
                                                    label_join_ref,
                                                    label_join_slots_ref)

    v, bq = 2048, 1024
    adj_np = random_words(rng, v, 0.01)
    adj = torch.from_numpy(adj_np.view(np.int32)).to(DEVICE)
    bits = torch.from_numpy(np.unpackbits(
        adj_np.view(np.uint8), axis=1, bitorder="little")[:, :v]
        .astype(np.bool_)).to(DEVICE)
    alive = torch.from_numpy(rng.random(v) < 0.9).to(DEVICE)
    fr = torch.from_numpy(rng.random((bq, v)) < 0.05).to(DEVICE)
    fr[-1] = False
    vis = torch.from_numpy(rng.random((bq, v)) < 0.3).to(DEVICE)
    args = (fr, adj, alive, vis)
    same(multi_bfs_step_packed_kernel(*args),
         multi_bfs_step_packed_ref(*args), f"B1 v={v} q={bq}")
    pa = (pack_bits(fr & alive[None, :]), pack_bits(bits.T.contiguous()),
          alive, vis)
    same(bfs_pull_step_rows(*pa), bfs_pull_step_ref(*pa),
         f"B2 v={v} q={bq}")

    cases = 0
    for q in (1, 5, 64, 1000):
        for l in (31, 32, 1024, 1030):
            for dens in (0.0, 0.01, 0.3):
                a = torch.from_numpy(rng.random((q, l)) < dens).to(DEVICE)
                b = torch.from_numpy(rng.random((q, l)) < dens).to(DEVICE)
                if l > 31:
                    a[0, 31] = b[0, 31] = True  # the word's sign bit
                if q > 1:
                    a[-1] = False               # an all-zero OUT row
                ai, bi = a.to(torch.int32), b.to(torch.int32)
                pa, pb = pack_bits(a), pack_bits(b)
                dense = label_join(ai, bi)
                packed = label_join_packed(pa, pb)
                same(dense, label_join_ref(ai, bi), f"B8 q={q} l={l}")
                same(packed, label_join_packed_ref(pa, pb),
                     f"B4 q={q} l={l}")
                same(packed, dense, f"B4 != B8 q={q} l={l}")
                cases += 1
    b8_cases = 0
    gen = torch.Generator(device=DEVICE).manual_seed(int(rng.integers(2**31)))
    for q in (0, 1, 64, 65, 4096):
        for l in (1, 3, 4, 31, 1024, 1025, 1030):
            for pattern in LABEL_PATTERNS:
                a, b = label_pattern(torch, gen, pattern, q, l)
                for oa, ob in LABEL_OFFSETS:
                    ta, tb = at_offset(torch, a, oa), at_offset(torch, b, ob)
                    what = f"B8 {pattern} q={q} l={l} offsets {oa}/{ob}"
                    dense = label_join(ta, tb)
                    same(dense, label_join_ref(ta, tb), what)
                    same(label_join_packed(pack_bits(ta > 0),
                                           pack_bits(tb > 0)), dense,
                         f"B4 != {what}")
                    if pattern == "all_one" and not bool(
                            (dense[0] == l).all()):
                        raise AssertionError(f"{what}: hits != L")
                    b8_cases += 1
    # B4 by slot: slots of -1 and past the end, dead endpoints, the sign bit
    slot_cases = 0
    for l in (31, 1024, 1030):
        labels = []
        for _ in range(2):
            bits = torch.from_numpy(rng.random((v, l)) < 0.01).to(DEVICE)
            bits[::7, min(31, l - 1)] = True
            labels.append(pack_bits(bits))
        alive_l = torch.from_numpy(rng.random(v) < 0.8).to(DEVICE)
        for q in (1, 64, 1000):
            src, dst = (torch.from_numpy(rng.integers(-1, v + 3, q).astype(
                np.int32)).to(DEVICE) for _ in range(2))
            args = (*labels, alive_l, src, dst)
            got = label_join_slots(*args)
            same(got, label_join_slots_ref(*args), f"B4 by slot q={q} l={l}")
            same(got[:2], label_join_packed(*gathered_rows(args)),
                 f"B4 by slot != B4 on gathered rows q={q} l={l}")
            slot_cases += 1
    sync(torch)
    log(f"index kernels vs plain: B1 and B2 at Q={bq} V={v}; {cases} cases "
        f"x (B4, B8, B4 == B8); {b8_cases} B8 edge cases x (B8, B4 on the "
        f"labels packed); {slot_cases} cases x (B4 by slot, B4 by "
        f"slot == B4 on the gathered rows); bit-identical (tolerance 0)")


LABEL_PATTERNS = ("random", "last", "empty_out", "all_one", "signed")
# (OUT, IN) element offsets of the slabs' views: aligned, both one word
# off (B8's head and tail entries), and off by different words (B8's
# 4-byte-load instance)
LABEL_OFFSETS = ((0, 0), (1, 1), (1, 2))
SIGNED_ENTRIES = (-5, -1, 0, 1, 2, -2**31, 2**31 - 1)


def label_pattern(torch, gen, pattern, q: int, l: int):
    """int32 OUT/IN slabs [q, l] on the card, drawn from ``gen``: "random"
    (0/1 at density 0.05, a common landmark in column 31, an all-zero last
    OUT row), "last" (the only common landmark at l - 1), "empty_out"
    (all-zero OUT rows), "all_one" (hits = l) or "signed" (entries of
    ``SIGNED_ENTRIES``: only those > 0 are labels)."""
    def draw(dens):
        return (torch.rand((q, l), generator=gen, device=DEVICE) < dens).to(
            torch.int32)
    if pattern == "signed":
        vals = torch.tensor(SIGNED_ENTRIES, dtype=torch.int32, device=DEVICE)
        return tuple(vals[torch.randint(len(SIGNED_ENTRIES), (q, l),
                                        generator=gen, device=DEVICE)]
                     for _ in range(2))
    a, b = draw(0.05), draw(0.05)
    if pattern == "random":
        if q > 0 and l > 31:
            a[0, 31] = b[0, 31] = 1
        if q > 1:
            a[-1] = 0
    elif pattern == "last":
        b.zero_()
        a[:, -1] = b[:, -1] = 1
    elif pattern == "empty_out":
        a.zero_()
    else:
        a.fill_(1)
        b.fill_(1)
    return a, b


def at_offset(torch, x, off: int):
    """A contiguous copy of ``x`` that starts ``off`` elements into its
    buffer (a row start is then not 16-byte aligned when off % 4 != 0)."""
    buf = torch.zeros(off + x.numel(), dtype=x.dtype, device=x.device)
    buf[off:] = x.reshape(-1)
    return buf[off:].view(x.shape)


def skewed_words(rng, v: int):
    """(out-words, in-words) uint32[v, ceil(v/32)] of a sparse random graph
    (8 edges a vertex) with skewed rows: out-row 1 and in-row 2 have every
    word nonzero, out-row 3 and in-row 4 only bit 31 of their words, and
    in-rows 33, 41 and 49 (rows one warp of a 32-row B2 tile stages
    together) ~200 nonzero words each, so that their lists overflow."""
    w = -(-v // 32)
    k = np.arange(w)
    every = np.minimum(32 * k + 7, v - 1)        # one bit in every word
    top = 32 * k[32 * k + 31 < v] + 31           # bit 31 of each word
    many = 32 * rng.choice(w, min(w, 200), replace=False)
    rows = [rng.integers(0, v, 8 * v), np.full(every.size, 1), every,
            np.full(top.size, 3), top]
    cols = [rng.integers(0, v, 8 * v), every, np.full(every.size, 2), top,
            np.full(top.size, 4)]
    for hub in (33, 41, 49):
        src = np.minimum(many + rng.integers(0, 32, many.size), v - 1)
        rows.append(src)
        cols.append(np.full(src.size, hub))
    r, c = np.concatenate(rows), np.concatenate(cols)
    return pack_edges(r, c, v), pack_edges(c, r, v)


def wide_inputs(rng, q: int, v: int, device):
    """frontier bool[q, v] with mixed densities, queries holding only the
    last vertex or only bit-31 vertices, and an empty one; visited with the
    skewed rows mostly unvisited; alive."""
    import torch

    fr = rng.random((q, v)) < rng.choice([0.0005, 0.005, 0.05], (q, 1))
    fr[1::7] = False
    fr[1::7, v - 1] = True                       # only the last vertex
    fr[2::7] = False
    fr[2::7, 31::32] = True                      # only bit-31 vertices
    fr[-1] = False                               # an empty frontier
    vis = rng.random((q, v)) < 0.3
    vis[:, [2, 4, 33, 41, 49]] = rng.random((q, 5)) < 0.1
    alive = rng.random(v) < 0.95
    alive[[1, 2, 3, 4, 33, 41, 49]] = True
    return [torch.from_numpy(x).to(device) for x in (fr, vis, alive)]


def phase_wide_kernels(torch, rng):
    """B1, B2 and B3 against their plain versions at Q = 1,024 and 1,025
    (many query groups, a ragged last one) on a random graph and on skewed
    graphs (rows with every word nonzero, rows with only bit 31, B2 in-row
    lists too long to stage), V with and without a multiple of 32 or 128
    columns, full and row slices, with and without parents; the launches
    without parents also equal the ones with, on new and reach."""
    from repro_torch.core.graph import pack_bits
    from repro_torch.kernels.bfs_multi_step.ops import (
        multi_bfs_step_packed_kernel as b1)
    from repro_torch.kernels.bfs_multi_step.ref import (
        multi_bfs_step_packed_ref as b1_ref)
    from repro_torch.kernels.bfs_pull_step.ops import bfs_pull_step_rows as b2
    from repro_torch.kernels.bfs_pull_step.ref import bfs_pull_step_ref as b2_ref
    from repro_torch.kernels.bfs_step.ops import bfs_step_packed_kernel as b3
    from repro_torch.kernels.bfs_step.ref import bfs_step_packed_ref as b3_ref

    cases = 0
    for v, skewed in WIDE_VS:
        if skewed:
            out_np, in_np = skewed_words(rng, v)
        else:
            out_np = random_words(rng, v, 0.01)
            in_np = pack_bits(torch.from_numpy(np.unpackbits(
                out_np.view(np.uint8), axis=1, bitorder="little")[:, :v]
                .astype(np.bool_)).T.contiguous()).numpy()
        adj = torch.from_numpy(out_np.view(np.int32)).to(DEVICE)
        adj_in = torch.from_numpy(np.ascontiguousarray(in_np).view(
            np.int32)).to(DEVICE)
        r0, r1 = 1, v // 2 + 3                   # a slice holding the hubs
        for q in WIDE_QS:
            fr, vis, alive = wide_inputs(rng, q, v, DEVICE)
            fw = pack_bits(fr & alive[None, :])
            push = {"full": (fr, adj, alive, vis),
                    "slice": (fr[:, r0:r1].contiguous(), adj[r0:r1], alive,
                              vis)}
            pull = {"full": (fw, adj_in, alive, vis),
                    "slice": (fw, adj_in[r0:r1], alive[r0:r1],
                              vis[:, r0:r1].contiguous())}
            for name, fn, ref, inputs in (("B1", b1, b1_ref, push),
                                          ("B2", b2, b2_ref, pull)):
                for part, args in inputs.items():
                    what = f"{name} {part} v={v} q={q}"
                    with_p = fn(*args)
                    same(with_p, ref(*args, budget=WIDE_BUDGET), what)
                    without = fn(*args, parents=False)
                    same(without, ref(*args, parents=False,
                                      budget=WIDE_BUDGET),
                         f"{what} parents=False")
                    same(without[::2], with_p[::2],
                         f"{what}: parents=False changes new/reach")
                    cases += 1
            for i in range(3):
                sa = (fr[i], adj, alive, vis[i])
                same(b3(*sa), b3_ref(*sa), f"B3 v={v} query {i}")
    sync(torch)
    log(f"wide kernels vs plain: {cases} cases x (parents, no parents, "
        f"no parents == parents on new/reach) of B1 and B2 at Q in "
        f"{WIDE_QS}, V in {[v for v, _ in WIDE_VS]}, full and sliced, skewed "
        f"rows (every word / only bit 31 / lists past B2's stage), and B3; "
        f"bit-identical (tolerance 0)")


def phase_single_push(torch, rng):
    """B3 against its plain version on the frontiers that stress its row
    list: only rows = 31 (mod 32), none, every row (past one 4,096-row
    round of the shared list, and past one 81,920-row frontier pass at
    V = 90,000), 5% of the rows and one row; over skewed graphs (a row with
    every word nonzero, a row with only bit 31 of its words), V not a
    multiple of 32 and W not a multiple of 4 (the word-wise loads)."""
    from repro_torch.kernels.bfs_step.ops import bfs_step_packed_kernel
    from repro_torch.kernels.bfs_step.ref import bfs_step_packed_ref

    cases = 0
    for v in SINGLE_VS:
        out_np, _ = skewed_words(rng, v)
        adj = torch.from_numpy(out_np.view(np.int32)).to(DEVICE)
        alive = torch.from_numpy(rng.random(v) < 0.9).to(DEVICE)
        alive[[1, 2, 3, 4]] = True
        vis = torch.from_numpy(rng.random(v) < 0.3).to(DEVICE)
        fronts = {"rows 31 mod 32": np.arange(31, v, 32), "empty": [],
                  "every row": np.arange(v), "one row": [3],
                  "5%": np.flatnonzero(rng.random(v) < 0.05)}
        for what, rows in fronts.items():
            fr = torch.zeros(v, dtype=torch.bool, device=DEVICE)
            fr[torch.as_tensor(np.asarray(rows, np.int64), device=DEVICE)] = True
            args = (fr, adj, alive, vis)
            same(bfs_step_packed_kernel(*args), bfs_step_packed_ref(*args),
                 f"B3 v={v} frontier {what}")
            cases += 1
    sync(torch)
    log(f"single push vs plain: {cases} cases of B3 (V in {SINGLE_VS}; "
        f"frontiers of rows = 31 mod 32, none, every row, one row, 5%) "
        f"bit-identical (tolerance 0)")


def phase_hybrid(torch, rng):
    """multi_bfs / bfs: "hybrid_cuda" == "hybrid" on a Graph500 graph."""
    from repro_torch.convert import state_from_numpy
    from repro_torch.core import bfs, multi_bfs

    arrays, _ = graph500_state_arrays(12, 4096, rng)
    st = state_from_numpy(*arrays, device=DEVICE)
    deg = arrays[3]
    srcs = rng.choice(np.flatnonzero(deg > 0), 8).astype(np.int32)
    dsts = rng.integers(-1, 4096, 8).astype(np.int32)
    reset_counts()
    a = multi_bfs(st, srcs, dsts, backend="hybrid_cuda")
    b = multi_bfs(st, srcs, dsts, backend="hybrid")
    for f, x, y in zip(a._fields, a, b):
        if not torch.equal(x, y):
            raise AssertionError(f"multi_bfs hybrid_cuda != hybrid: {f}")
    for s, d in zip(srcs[:4], dsts[:4]):
        x = bfs(st, int(s), int(d), backend="hybrid_cuda")
        y = bfs(st, int(s), int(d), backend="hybrid")
        for f, p, q in zip(x._fields, x, y):
            if not torch.equal(p, q):
                raise AssertionError(f"bfs hybrid_cuda != hybrid: {f}")
    n = counts()
    require_launched(n, BFS_KERNELS, "in the hybrid check")
    log(f"hybrid_cuda == hybrid at V=4096 Q=8 (supersteps "
        f"{int(a.supersteps)}, steps {a.steps.tolist()})")
    log(f"kernels: B1 multi_bfs_step_packed {n['B1']} launches, B2 "
        f"bfs_pull_step {n['B2']}, B3 bfs_step_packed {n['B3']} "
        f"(hybrid_cuda check)")


def hub_slots(state, n: int) -> np.ndarray:
    """The ``n`` highest-degree alive slots (degree descending, ties by
    slot): the hubs a landmark budget is meant for. ``pick_landmarks``
    follows the JAX package's order instead, which puts alive vertices of
    degree 0 first, so the index phases pin these as ``landmark_slots``."""
    from repro_torch.index.labels import live_degrees

    deg = live_degrees(state).cpu().numpy()
    alive = state.valive.cpu().numpy()
    order = np.lexsort((np.arange(deg.shape[0]), -deg))
    return order[alive[order]][:n].astype(np.int32)


def same_index(a, b, what):
    """Two ReachIndexes agree on every array and on ``complete``."""
    for f in ("landmarks", "out_label", "in_label", "fwd", "bwd", "alive",
              "versions"):
        if not getattr(a, f).equal(getattr(b, f)):
            raise AssertionError(f"{what}: {f} differs")
    if a.complete != b.complete:
        raise AssertionError(f"{what}: complete differs")


def phase_closure(torch, rng):
    """Closure mode through the kernels == the plain closure; a complete
    index answers exactly as scipy does."""
    from repro_torch.convert import state_from_numpy
    from repro_torch.core import multi_bfs
    from repro_torch.index import (build_index, reach_counts_session,
                                   reach_session)

    arrays, _ = graph500_state_arrays(CLOSURE_SCALE, CLOSURE_CAPACITY, rng)
    st = state_from_numpy(*arrays, device=DEVICE)
    q = CLOSURE_Q
    srcs = rng.choice(np.flatnonzero(arrays[1]), q).astype(np.int32)
    dsts = np.full(q, -1, np.int32)
    reset_counts()
    a = multi_bfs(st, srcs, dsts, backend="hybrid_cuda", parents=False)
    n = counts()
    b = multi_bfs(st, srcs, dsts, backend="hybrid", parents=False)
    for f, x, y in zip(a._fields, a, b):
        if not torch.equal(x, y):
            raise AssertionError(f"closure hybrid_cuda != hybrid: {f}")
    require_launched(n, ("B1", "B2"), "in the kernel-routed closure")
    reset_counts()
    d = multi_bfs(st, srcs, dsts, backend="dense_cuda", parents=False)
    nd = counts()
    for f, x, y in zip(a._fields, d, a):
        if not torch.equal(x, y):
            raise AssertionError(f"closure dense_cuda != hybrid_cuda: {f}")
    require_launched(nd, ("B6",), "in the dense closure")
    hubs = hub_slots(st, q)
    ia = build_index(st, landmark_slots=hubs,
                     backend="hybrid_cuda")      # also warms cuBLAS
    times = {}
    for be in ("hybrid", "hybrid_cuda", "dense_cuda"):
        t0 = time.perf_counter()
        ib = build_index(st, landmark_slots=hubs, backend=be)
        sync(torch)
        times[be] = time.perf_counter() - t0
        same_index(ia, ib, f"build_index hybrid_cuda != {be}")
    log(f"closure: multi_bfs(parents=False) hybrid_cuda == hybrid == "
        f"dense_cuda at V={st.capacity} Q={q} ({int(a.supersteps)} "
        f"supersteps, B1 {n['B1']} / B2 {n['B2']} launches, B6 "
        f"{nd['B6']}); build_index over the {q} highest-degree slots "
        f"hybrid_cuda == hybrid == dense_cuda on every array "
        f"({times['hybrid_cuda'] * 1e3:.3f} ms vs "
        f"{times['hybrid'] * 1e3:.3f} ms vs "
        f"{times['dense_cuda'] * 1e3:.3f} ms)")
    del a, b, d, ia, ib, st

    n_keys, n_pairs = 1 << COMPLETE_SCALE, COMPLETE_PAIRS
    arrays, _ = graph500_state_arrays(COMPLETE_SCALE, COMPLETE_CAPACITY, rng)
    st = state_from_numpy(*arrays, device=DEVICE)
    index = build_index(st)
    if not index.complete or index.num_landmarks != n_keys:
        raise AssertionError("the default index is not complete")
    pairs = list(zip(rng.integers(0, n_keys, n_pairs).tolist(),
                     rng.integers(0, n_keys, n_pairs).tolist()))
    res = reach_session(lambda: st, index, pairs)
    if res.from_index != len(pairs) or res.stale:
        raise AssertionError(f"complete index left pairs undecided: {res}")
    reachable = check_reach(st, pairs, res.found, "complete index")
    keys = [k for k, _ in pairs]
    got, served = reach_counts_session(lambda: st, index, keys)
    g, _, slot_of = live_graph(st)
    srcs, dist = scipy_dist(g, slot_of, keys)
    want = [int(np.isfinite(dist[s]).sum()) for s in srcs]
    if not served or got.tolist() != want:
        raise AssertionError("reach_counts_session differs from scipy")
    log(f"complete index: SCALE {COMPLETE_SCALE}, {n_keys} landmarks, label "
        f"bits OUT {int(index.out_label_bits.sum())} / IN "
        f"{int(index.in_label_bits.sum())} of {int(index.fwd.sum())} closure "
        f"bits; {n_pairs} pairs all from the index, {reachable} reachable "
        f"and {n_pairs - reachable} exact negatives; their sources' "
        f"reachable counts equal scipy")


def live_graph(state):
    """(scipy CSR of the live edges, sorted edge ids r * V + c, key -> slot
    of the alive vertices) of ``state``."""
    import scipy.sparse as sp

    from repro_torch.core.graph import traversable_packed, unpack_bits

    v = state.capacity
    live = traversable_packed(state.adj_packed, state.valive,
                              state.alive_words)
    rows, cols = [], []
    for r0 in range(0, v, 4096):
        nz = unpack_bits(live[r0:r0 + 4096], v).nonzero()
        rows.append((nz[:, 0] + r0).cpu().numpy())
        cols.append(nz[:, 1].cpu().numpy())
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    g = sp.csr_matrix((np.ones(len(rows), np.int8), (rows, cols)),
                      shape=(v, v))
    vkey = state.vkey.cpu().numpy()
    valive = state.valive.cpu().numpy()
    slot_of = {int(vkey[s]): int(s) for s in np.flatnonzero(valive)}
    return g, np.sort(rows.astype(np.int64) * v + cols), slot_of


def scipy_dist(g, slot_of, keys):
    """(slot per key, -1 if absent; BFS hop rows of the present ones, by
    slot) from scipy."""
    from scipy.sparse.csgraph import shortest_path

    srcs = [slot_of.get(k, -1) for k in keys]
    uniq = sorted({s for s in srcs if s >= 0})
    dist = (shortest_path(g, unweighted=True, indices=uniq)
            if uniq else np.zeros((0, g.shape[0])))
    return srcs, {s: dist[i] for i, s in enumerate(uniq)}


def check_reach(state, pairs, found, tag):
    """Each reachability answer against scipy's BFS on the live edges of
    ``state``; returns how many pairs are reachable."""
    g, _, slot_of = live_graph(state)
    srcs, dist = scipy_dist(g, slot_of, [k for k, _ in pairs])
    want = [s >= 0 and slot_of.get(l, -1) >= 0
            and bool(np.isfinite(dist[s][slot_of[l]]))
            for (_, l), s in zip(pairs, srcs)]
    bad = [(p, f) for p, f, w in zip(pairs, found, want) if f != w]
    if bad:
        raise AssertionError(f"{tag}: {len(bad)} answers differ from scipy, "
                             f"e.g. {bad[:3]}")
    return sum(want)


def check_answers(state, pairs, answers, tag):
    """Each answer against scipy's BFS on the live edges of ``state``."""
    g, edge_ids, slot_of = live_graph(state)
    v = state.capacity
    srcs, dist = scipy_dist(g, slot_of, [k for k, _ in pairs])

    def is_chain(slots):
        e = np.asarray(slots[:-1], np.int64) * v + np.asarray(slots[1:])
        i = np.searchsorted(edge_ids, e)
        return bool(np.all((i < len(edge_ids))
                           & (edge_ids[np.minimum(i, len(edge_ids) - 1)] == e)))

    for (k, l), s, (found, keys) in zip(pairs, srcs, answers):
        d = slot_of.get(l, -1)
        hops = dist[s][d] if s >= 0 and d >= 0 else np.inf
        if found != bool(np.isfinite(hops)):
            raise AssertionError(f"{tag}: found {found} for {k}->{l}, "
                                 f"scipy hops {hops}")
        if found:
            if len(keys) != int(hops) + 1 or keys[0] != k or keys[-1] != l:
                raise AssertionError(f"{tag}: path {k}->{l} of "
                                     f"{len(keys)} vertices, want {hops + 1}")
            if not is_chain([slot_of[x] for x in keys]):
                raise AssertionError(f"{tag}: path {k}->{l} is not a chain "
                                     f"of live edges")
    return len(edge_ids)


def phase_main(torch, rng, rounds: int):
    from repro_torch.convert import state_from_numpy
    from repro_torch.core import (apply_ops, apply_ops_fast,
                                  get_path_session, get_paths_session,
                                  transpose_invariant)
    from repro_torch.kernels.serial_pass import ops as sp_ops
    from repro_torch.obs import trace

    n = 1 << SCALE
    t0 = time.perf_counter()
    arrays, n_edges = graph500_state_arrays(SCALE, CAPACITY, rng)
    st = state_from_numpy(*arrays, device=DEVICE)
    sync(torch)
    log(f"graph500: SCALE {SCALE}, {n} vertices, {EDGEFACTOR << SCALE} "
        f"generated edges, {n_edges} distinct, capacity {CAPACITY}, state "
        f"{sum(t.numel() * t.element_size() for t in st) / 1e9:.3f} GB, "
        f"built in {time.perf_counter() - t0:.1f} s")
    deg_src = np.flatnonzero(arrays[3][:n] > 0)
    del arrays

    batches = [equal_mix_batch(rng, n, DEVICE) for _ in range(rounds + 4)]
    extra = iter(batches[rounds:])
    pair_sets = [list(zip(rng.choice(deg_src, QUERIES).tolist(),
                          rng.integers(0, n, QUERIES).tolist()))
                 for _ in range(rounds)]
    singles = [(int(rng.choice(deg_src)), int(rng.integers(0, n)))
               for _ in range(rounds)]

    cur = {"st": st}
    serial_launches = sp_ops.launches
    apply_s, session_s, single_s = [], [], []
    rounds_seen, single_rounds = [], []
    supersteps, pulls = [], []
    per_session, per_single = [], []   # kernel launches per session
    checked_edges = []
    reset_counts()
    with trace.capture() as rec:
        for r in range(rounds):
            # the fast engine (its conflicting lanes in one launch of the
            # serial pass kernel) against the serial specification
            ser_st, ser_res = apply_ops(cur["st"], batches[r])
            sync(torch)
            t0 = time.perf_counter()
            fast_st, fast_res = apply_ops_fast(cur["st"], batches[r])
            sync(torch)
            apply_s.append(time.perf_counter() - t0)
            for f, x, y in zip(("codes",) + st._fields,
                               (fast_res,) + fast_st, (ser_res,) + ser_st):
                if not torch.equal(x, y):
                    raise AssertionError(
                        f"round {r}: apply_ops_fast != apply_ops: {f}")
            cur["st"] = fast_st
            del ser_st, fast_st

            mutate = {"left": 2 if r in (1, 5) else 0}
            seen = []

            def fetch():
                if mutate["left"]:
                    mutate["left"] -= 1
                    cur["st"], _ = apply_ops_fast(cur["st"], next(extra))
                seen.append(cur["st"])
                return cur["st"]

            n_ev = len(rec.events())
            c0 = counts()
            t0 = time.perf_counter()
            out, nr = get_paths_session(fetch, pair_sets[r])
            sync(torch)
            session_s.append(time.perf_counter() - t0)
            c1 = counts()
            per_session.append({k: c1[k] - c0[k] for k in c0})
            rounds_seen.append(nr)
            steps = [e for e in rec.events()[n_ev:]
                     if e["name"] == "bfs.superstep"]
            supersteps.append(len(steps))
            pulls.append(sum(e["args"]["direction"] == "pull" for e in steps))
            k, l = singles[r]
            t0 = time.perf_counter()
            pr = get_path_session(lambda: cur["st"], k, l)
            c2 = counts()
            per_single.append({k: c2[k] - c1[k] for k in c1})
            sync(torch)
            single_s.append(time.perf_counter() - t0)
            single_rounds.append(int(pr.rounds))
            keys = pr.keys[:int(pr.length)].tolist()
            # the single session ran on the state the batch session matched
            checked_edges.append(check_answers(
                seen[-1], pair_sets[r] + [(k, l)],
                out + [(bool(pr.found), keys)], f"round {r}"))
            log(f"round {r}: apply {apply_s[-1] * 1e3:.3f} ms, session "
                f"{session_s[-1] * 1e3:.3f} ms ({nr} collects, "
                f"{supersteps[-1]} supersteps, {pulls[-1]} pull), found "
                f"{sum(f for f, _ in out)}/{QUERIES}; single "
                f"{single_s[-1] * 1e3:.3f} ms ({int(pr.rounds)} collects, "
                f"found {bool(pr.found)})")
    launches = counts()
    require_launched(launches, BFS_KERNELS, "on the main path")
    # one launch for each fast-engine batch with conflicting lanes
    fast = [e["args"] for e in rec.events() if e["name"] == "ops.apply"]
    serial_lanes = [a["serial_lanes"] for a in fast]
    want = sum(not a["replay"] and a["serial_lanes"] > 0 for a in fast)
    serial_launches = sp_ops.launches - serial_launches
    if serial_launches != want or not want:
        raise AssertionError(f"the serial pass kernel ran {serial_launches} "
                             f"times for {want} batches with serial lanes "
                             f"({serial_lanes})")
    log(f"apply_ops_fast == apply_ops on all {rounds} batches (codes + 6 "
        f"arrays, B={LANES}, capacity {CAPACITY}); serial lanes a batch "
        f"{serial_lanes}, {serial_launches} serial pass launches")
    if max(rounds_seen) <= 2:
        raise AssertionError("no session needed more than 2 collects")
    if not bool(transpose_invariant(cur["st"])):
        raise AssertionError("transpose invariant broken after the last round")
    med = statistics.median
    log(f"main path medians: apply_ops_fast {med(apply_s) * 1e3:.3f} ms/batch"
        f" (B={LANES}), get_paths_session {med(session_s) * 1e3:.3f} ms "
        f"(Q={QUERIES}), get_path_session {med(single_s) * 1e3:.3f} ms; "
        f"collects per session {rounds_seen}, single {single_rounds}; "
        f"supersteps {supersteps}, pull {pulls}")
    log(f"checks: transpose invariant holds; {rounds} sessions + {rounds} "
        f"single sessions equal scipy BFS (live edges {checked_edges[-1]})")
    log(f"main-path launches: {launches}; per get_paths_session "
        f"{per_session}; per get_path_session {per_single}")
    single = {k: sum(p[k] for p in per_single) for k in launches}
    return (cur["st"], launches, single, pair_sets[0], batches[:rounds],
            deg_src)


def same_result(got, want, what):
    for f, x, y in zip(want._fields, got, want):
        if not x.equal(y):
            raise AssertionError(f"{what}: {f} differs")


def phase_dense(torch, st, deg_src, rng):
    """The dense engine (B6/B7 on the uint8 view) at full width on the
    phase-3 end state ``st``: sessions answer as scipy does, and every BFS
    field equals "hybrid_cuda" on the same pairs."""
    from repro_torch.core import (bfs, find_slots, get_path_session,
                                  get_paths_session, multi_bfs)

    n = 1 << SCALE
    sync(torch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    view = st.adj
    sync(torch)
    view_s = time.perf_counter() - t0
    view_peak = torch.cuda.max_memory_allocated() - base
    view_bytes = view.numel() * view.element_size()
    del view

    def slots(keys):
        return find_slots(st, torch.tensor(keys, dtype=torch.int32,
                                           device=st.device))

    launches = dict.fromkeys(counts(), 0)
    session_s, steps = [], []
    for r in range(DENSE_ROUNDS):
        pairs = list(zip(rng.choice(deg_src, QUERIES).tolist(),
                         rng.integers(0, n, QUERIES).tolist()))
        sync(torch)
        t0 = time.perf_counter()
        out, nr = counted(launches, lambda: get_paths_session(
            lambda: st, pairs, backend="dense_cuda"))
        sync(torch)
        session_s.append(time.perf_counter() - t0)
        sk, dk = slots([k for k, _ in pairs]), slots([l for _, l in pairs])
        got = multi_bfs(st, sk, dk, backend="dense_cuda")
        same_result(got, multi_bfs(st, sk, dk, backend="hybrid_cuda"),
                    f"dense round {r}: multi_bfs dense_cuda != hybrid_cuda")
        steps.append(int(got.supersteps))
        edges = check_answers(st, pairs, out, f"dense round {r}")
        log(f"dense round {r}: get_paths_session {session_s[-1] * 1e3:.3f} "
            f"ms ({nr} collects, {steps[-1]} supersteps), found "
            f"{sum(f for f, _ in out)}/{QUERIES}")
    k, l = int(rng.choice(deg_src)), int(rng.integers(0, n))
    sync(torch)
    t0 = time.perf_counter()
    pr = counted(launches, lambda: get_path_session(lambda: st, k, l,
                                                    backend="dense_cuda"))
    sync(torch)
    single_s = time.perf_counter() - t0
    check_answers(st, [(k, l)], [(bool(pr.found),
                                  pr.keys[:int(pr.length)].tolist())],
                  "dense single")
    sk, dk = slots([k]), slots([l])
    same_result(bfs(st, sk, dk, backend="dense_cuda"),
                bfs(st, sk, dk, backend="hybrid_cuda"),
                "dense single: bfs dense_cuda != hybrid_cuda")
    peak = torch.cuda.max_memory_allocated() - base
    require_launched(launches, DENSE_KERNELS, "on the dense engine")
    med = statistics.median
    log(f"dense view: uint8 [{st.capacity}, {st.capacity}] = "
        f"{view_bytes / 1e9:.3f} GB built in {view_s * 1e3:.3f} ms (row "
        f"chunks; {view_peak / 1e9:.3f} GB peak above the start)")
    log(f"dense engine medians over {DENSE_ROUNDS} rounds: "
        f"get_paths_session {med(session_s) * 1e3:.3f} ms (Q={QUERIES}; "
        f"supersteps {steps}), get_path_session {single_s * 1e3:.3f} ms "
        f"(once, found {bool(pr.found)}); peak {peak / 1e9:.3f} GB above "
        f"the {base / 1e9:.3f} GB held at the start; every multi_bfs/bfs "
        f"field equals hybrid_cuda, every answer equals scipy (live edges "
        f"{edges})")
    log(f"dense-engine launches: {launches}")
    return launches, pairs


def small_refresh_edge(torch, index, st):
    """Keys (k, l) of an AddE whose refresh stays incremental: k and l are
    alive non-landmarks that reach no landmark, so the backward closures
    are unaffected, and k is reached by as few landmarks as possible (at
    least one), so some forward closures are re-traversed."""
    is_lm = torch.zeros_like(st.valive)
    is_lm[index.landmarks.long()] = True
    reached_by = index.fwd.sum(0)
    cand = st.valive & ~is_lm & ~index.bwd.any(0)
    slots = torch.nonzero(cand).flatten()
    if slots.numel() < 2:
        raise AssertionError("no vertex outside the landmarks' reach")
    score = reached_by[slots]
    score = torch.where(score > 0, score, score.max() + 1)
    x = int(slots[int(score.argmin())])
    z = int(slots[0] if int(slots[0]) != x else slots[1])
    return int(st.vkey[x]), int(st.vkey[z]), int(reached_by[x])


def phase_index(torch, st, deg_src, rng):
    """The reachability index at full size on the phase-3 state."""
    from repro_torch.convert import op_batch_from_numpy
    from repro_torch.core import OP_ADD_E, apply_ops_fast, find_slots
    from repro_torch.index import build_index, reach_session, refresh
    from repro_torch.index.labels import live_degrees
    from repro_torch.kernels.label_join.ops import label_join_slots
    from repro_torch.kernels.label_join.ref import label_join_slots_ref

    n = 1 << SCALE
    sync(torch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    # launches of the build and refreshes, and of the served sessions
    closure, serve = dict.fromkeys(counts(), 0), dict.fromkeys(counts(), 0)
    hubs = hub_slots(st, INDEX_LANDMARKS)
    t0 = time.perf_counter()
    index = counted(closure, lambda: build_index(st, landmark_slots=hubs))
    sync(torch)
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated() - base
    log(f"index: build_index over the {INDEX_LANDMARKS} highest-degree "
        f"slots {build_s * 1e3:.3f} ms, "
        f"peak {build_peak / 1e9:.3f} GB above the start; "
        f"labels {tuple(index.out_label.shape)} words, OUT bits "
        f"{int(index.out_label_bits.sum())} / IN "
        f"{int(index.in_label_bits.sum())} of {int(index.fwd.sum())} / "
        f"{int(index.bwd.sum())} closure bits; launches {closure}")
    cur = {"st": st}
    fresh_s, stale_s, refresh_s, modes = [], [], [], []
    for r in range(INDEX_ROUNDS):
        pairs = list(zip(rng.choice(deg_src, QUERIES).tolist(),
                         rng.integers(0, n, QUERIES).tolist()))
        t0 = time.perf_counter()
        fres = counted(serve, lambda: reach_session(lambda: cur["st"],
                                                    index, pairs))
        sync(torch)
        fresh_s.append(time.perf_counter() - t0)
        if fres.stale or fres.from_index == 0:
            raise AssertionError(f"round {r}: a fresh index served nothing")
        reach = check_reach(cur["st"], pairs, fres.found, f"index {r} fresh")
        cur["st"], _ = apply_ops_fast(cur["st"],
                                      equal_mix_batch(rng, n, DEVICE))
        t0 = time.perf_counter()
        sres = counted(serve, lambda: reach_session(lambda: cur["st"],
                                                    index, pairs))
        sync(torch)
        stale_s.append(time.perf_counter() - t0)
        if not sres.stale or sres.fellback != QUERIES:
            raise AssertionError(f"round {r}: a stale index served")
        check_reach(cur["st"], pairs, sres.found, f"index {r} stale")
        t0 = time.perf_counter()
        index, info = counted(closure, lambda: refresh(
            index, cur["st"], full_threshold=1.0))
        sync(torch)
        refresh_s.append(time.perf_counter() - t0)
        modes.append(info["mode"])
        same_index(index, build_index(
            cur["st"], landmark_slots=index.landmarks), f"refresh {r}")
        log(f"index round {r}: fresh reach_session {fresh_s[-1] * 1e3:.3f} "
            f"ms (from_index {fres.from_index}, fellback {fres.fellback}, "
            f"reachable {reach}/{QUERIES}); stale {stale_s[-1] * 1e3:.3f} ms "
            f"({sres.rounds} collects); refresh {refresh_s[-1] * 1e3:.3f} ms "
            f"({info['mode']}, rebuilt {info['rebuilt']})")

    k, l, hit = small_refresh_edge(torch, index, cur["st"])
    cur["st"], _ = apply_ops_fast(cur["st"], op_batch_from_numpy(
        [OP_ADD_E], [k], [l], [-1], DEVICE))
    t0 = time.perf_counter()
    index, info = counted(closure, lambda: refresh(index, cur["st"],
                                                   full_threshold=1.0))
    sync(torch)
    inc_s = time.perf_counter() - t0
    if info["mode"] != "incremental":
        raise AssertionError(f"small refresh took {info}")
    same_index(index, build_index(
        cur["st"], landmark_slots=index.landmarks), "incremental refresh")
    fres = counted(serve, lambda: reach_session(lambda: cur["st"], index,
                                                pairs))
    if fres.stale or fres.from_index == 0:
        raise AssertionError("the incrementally refreshed index served nothing")
    check_reach(cur["st"], pairs, fres.found, "index incremental")
    sync(torch)
    peak = torch.cuda.max_memory_allocated()
    log(f"index incremental: AddE {k}->{l} (its source reached by {hit} "
        f"landmarks): refresh {inc_s * 1e3:.3f} ms ({info['mode']}, rebuilt "
        f"{info['rebuilt']}); answers equal scipy")

    # one refresh at the default threshold after an equal-mix batch: the
    # full rebuild a user gets, which re-picks the landmarks in JAX's order
    # (isolated vertices first); the pinned index stays the one returned
    torch.cuda.reset_peak_memory_stats()
    full_base = torch.cuda.memory_allocated()
    full_st, _ = apply_ops_fast(cur["st"], equal_mix_batch(rng, n, DEVICE))
    t0 = time.perf_counter()
    full, finfo = counted(closure, lambda: refresh(index, full_st))
    sync(torch)
    full_s = time.perf_counter() - t0
    full_peak = torch.cuda.max_memory_allocated() - full_base
    if finfo["mode"] != "full":
        raise AssertionError(f"refresh at the default threshold took {finfo}")
    same_index(full, build_index(full_st, index.requested), "full refresh")
    n_isolated = int((live_degrees(full_st)[full.landmarks.long()] == 0)
                     .sum())
    log(f"index full refresh (default threshold, after an equal-mix batch): "
        f"{full_s * 1e3:.3f} ms, peak {full_peak / 1e9:.3f} GB above the "
        f"start of the step; equals build_index(state, "
        f"{index.requested}), whose landmarks are {n_isolated} isolated "
        f"vertices of {full.num_landmarks}")
    del full, full_st
    require_launched(closure, ("B1", "B2"), "in the build and refreshes")
    require_launched(serve, ("B4",), "in the index-served sessions")
    # the sessions' B4 (by slot) against its plain version on the probe
    probe = [find_slots(cur["st"], torch.tensor(
        [p[i] for p in pairs], dtype=torch.int32, device=DEVICE))
        for i in (0, 1)]
    args = (index.out_label, index.in_label, index.alive, *probe)
    same(label_join_slots(*args), label_join_slots_ref(*args),
         "B4 by slot on the probe")
    launches = {k: closure[k] + serve[k] for k in closure}
    med = statistics.median
    log(f"index medians over {INDEX_ROUNDS} rounds: build_index "
        f"{build_s * 1e3:.3f} ms (once), refresh {med(refresh_s) * 1e3:.3f} "
        f"ms (modes {modes}), fresh reach_session {med(fresh_s) * 1e3:.3f} "
        f"ms, stale reach_session {med(stale_s) * 1e3:.3f} ms (Q={QUERIES}); "
        f"peak memory {peak / 1e9:.3f} GB ({(peak - base) / 1e9:.3f} GB above "
        f"the {base / 1e9:.3f} GB held at the start)")
    log(f"index-path launches: build and {INDEX_ROUNDS + 2} refreshes "
        f"{closure}; {2 * INDEX_ROUNDS + 1} sessions {serve}; every refresh "
        f"equals a full rebuild over its landmarks; every answer equals "
        f"scipy")
    return index, cur["st"], pairs, launches


# ----------------------------------------------------------------------------
# Phase 8: the multi-tenant serving path at full width
# ----------------------------------------------------------------------------
def client_ops(rng, n_keys: int, lanes: int, removes: bool) -> list:
    """One client batch of the "equal" mix as (opcode, k1, k2) tuples, keys
    uniform. ``removes=False`` turns RemoveVertex lanes into HasVertex
    (the batch stays non-exclusive); ``removes=True`` holds at least one
    RemoveVertex lane (the batch is exclusive: admitted alone)."""
    from repro_torch.core import OP_CON_V, OP_REM_V

    opc, k1, k2 = equal_mix(rng, n_keys, lanes)
    if removes:
        opc[0] = OP_REM_V
    else:
        opc[opc == OP_REM_V] = OP_CON_V
    return [(int(o), int(a), int(b)) for o, a, b in zip(opc, k1, k2)]


def changed_rows(a, b):
    """Slots whose bytes differ between two states (any field but the in
    mirror), compared on the device."""
    ch = (a.adj_packed != b.adj_packed).any(1)
    for f in ("vkey", "valive", "vver", "ecnt"):
        ch |= getattr(a, f) != getattr(b, f)
    return ch.nonzero().flatten().cpu().numpy().astype(np.int32)


def record_bytes(ring) -> int:
    return sum(getattr(r, f).nbytes for r in ring._records
               for f in ("versions", "rows", "vkey_xor", "valive_xor",
                         "vver_xor", "ecnt_xor", "adj_xor"))


def ms_of(torch, fn):
    sync(torch)
    t0 = time.perf_counter()
    out = fn()
    sync(torch)
    return out, (time.perf_counter() - t0) * 1e3


def phase_serving(torch, st, deg_src, rng):
    """Phase 8: ``IngestPool`` and ``EpochRing`` on the phase-3 end state,
    a ring-validated index, the linearization replayed at full width, and
    ``GraphCoServer`` end to end on a SCALE-12 graph. Returns (launches,
    the pool) for the phase-5 profiles."""
    from repro_torch.core import (OP_ADD_E, OP_ADD_V, EpochEvictedError,
                                  apply_ops_fast, get_paths_session,
                                  make_op_batch, transpose_invariant)
    from repro_torch.index import build_index, reach_session
    from repro_torch.obs import trace
    from repro_torch.runtime.ingest import IngestPool, _next_pow2

    n = 1 << SCALE
    t_phase = time.perf_counter()
    sync(torch)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    reset_counts()
    free = int((st.vkey == -1).sum())
    pool = IngestPool(st, retain_epochs=SERVE_RETAIN,
                      max_coalesce_lanes=SERVE_COALESCE)
    ring = pool.ring
    push_ms, push_bytes = [], []
    plain_push = ring.push

    def timed_push(epoch, state):
        before = ring._host_bytes
        _, ms = ms_of(torch, lambda: plain_push(epoch, state))
        push_ms.append(ms)
        push_bytes.append(ring._host_bytes - before)

    ring.push = timed_push
    # published states held by reference: epoch 0 (the phase-3 state), the
    # one before the newest, and the mark of the last check
    held = {0: st}
    mark = {"e": 0}

    def note():
        e, s = pool.snapshot_epoch()
        held[e] = s
        for k in [k for k in held if k not in (0, mark["e"], e - 1, e)]:
            del held[k]

    queued = {}

    def refill(r):
        for c in range(SERVE_CLIENTS):
            t = queued.get(c)
            if t is None or t.status != "queued":
                queued[c] = pool.submit(f"c{c}", client_ops(
                    rng, n, SERVE_LANES, removes=False))
        t = queued.get("x")
        # never queued when a starved round (r = 3 mod 4) starts: the
        # mutator's commits must land on the session's fetches, and an
        # exclusive batch ahead of them would be admitted alone first
        if r % 4 == 0 and (t is None or t.status != "queued"):
            queued["x"] = pool.submit("x", client_ops(
                rng, n, SERVE_EXCL_LANES, removes=True))

    fresh = iter(range(1 << 20, 1 << 21))
    session_ms, starved_ms, tt_ms, state_at_ms = [], [], [], {}
    rounds_info = []
    with trace.capture() as rec:
        for r in range(SERVE_ROUNDS):
            refill(r)
            pool.pump()
            note()
            pairs = list(zip(rng.choice(deg_src, QUERIES).tolist(),
                             rng.integers(0, n, QUERIES).tolist()))
            starve = r in SERVE_STARVE
            srcs = sorted({k for k, _ in pairs})

            def fetch():
                if starve:
                    # a mutator commits a round on every fetch, bumping
                    # each query source's ecnt: the collects never match
                    k = next(fresh)
                    pool.submit("mutator", [(OP_ADD_V, k)] + [
                        (OP_ADD_E, s, k) for s in srcs])
                    pool.pump()
                    note()
                return pool.snapshot()

            sinfo = {}
            (out, nr), ms = ms_of(torch, lambda: get_paths_session(
                fetch, pairs, max_rounds=SERVE_MAX_ROUNDS,
                on_conflict="epoch", fetch_epoch=pool.snapshot_epoch,
                stats=sinfo))
            (starved_ms if sinfo["starved"] else session_ms).append(ms)
            if starve != bool(sinfo["starved"]):
                raise AssertionError(f"serve round {r}: starved "
                                     f"{sinfo['starved']}, want {starve}")
            if starve or r % SERVE_CHECK_EVERY == 0:
                at = (pool.state_at(sinfo["epoch"]) if starve
                      else pool.snapshot())
                check_answers(at, pairs, out, f"serve round {r}")
            if r % SERVE_CHECK_EVERY == SERVE_CHECK_EVERY - 1:
                lo, hi = pool.epoch_window()
                if lo != 0:
                    raise AssertionError(f"window {lo, hi}: epoch 0 left")
                for e, want in ((hi - 1, held[hi - 1]), (mark["e"],
                                held[mark["e"]]), (lo, st)):
                    got, ms = ms_of(torch, lambda: pool.state_at(e))
                    state_at_ms.setdefault(hi - e, []).append(ms)
                    same_result(got, want, f"state_at({e}) at {hi}")
                    del got
                tt_state = pool.state_at(mark["e"])
                (tout, _), ms = ms_of(torch, lambda: get_paths_session(
                    lambda: tt_state, pairs))
                tt_ms.append(ms)
                check_answers(tt_state, pairs, tout,
                              f"time travel to {mark['e']}")
                del tt_state
                d = pool.epoch_diff(mark["e"], hi)
                rows = changed_rows(held[mark["e"]], held[hi])
                if not np.array_equal(d.rows, rows):
                    raise AssertionError(f"epoch_diff({mark['e']}, {hi}): "
                                         f"{len(d.rows)} rows, a device "
                                         f"compare finds {len(rows)}")
                vk = held[hi].vkey.cpu().numpy()
                if not np.array_equal(d.keys_after, vk[rows]):
                    raise AssertionError("epoch_diff keys_after differ")
                for e in (hi + 1, lo - 1):
                    try:
                        pool.state_at(e)
                    except EpochEvictedError as err:
                        if err.window != (lo, hi) or err.epoch != e:
                            raise AssertionError(f"evicted {err}")
                    else:
                        raise AssertionError(f"state_at({e}) outside "
                                             f"{lo, hi} answered")
                if not np.array_equal(d.keys_before,
                                      held[mark["e"]].vkey.cpu().numpy()[rows]):
                    raise AssertionError("epoch_diff keys_before differ")
                mark["e"] = hi
                note()
            rounds_info.append(nr)
        spans = {}
        for ev in rec.events():
            if ev["name"] in ("ingest.round", "ingest.admit",
                              "ingest.fused_apply"):
                spans.setdefault(ev["name"], []).append(ev["dur"] / 1e3)
    ring.push = plain_push
    ps = pool.stats
    lanes_applied = sum(len(t.ops) for t in pool.tickets.values()
                        if t.status == "applied")
    lo, hi = pool.epoch_window()
    med = statistics.median
    log(f"serving pool: V={st.capacity}, {free} free slots, "
        f"{SERVE_ROUNDS} rounds of {SERVE_CLIENTS} clients x {SERVE_LANES} "
        f"lanes + 1 exclusive client x {SERVE_EXCL_LANES} (RemoveVertex) "
        f"every 4th round; {ps.fused_calls} fused applies, {ps.applied} "
        f"batches applied, coalesce_max {ps.coalesce_max}, "
        f"coalesce_lanes_max {ps.coalesce_lanes_max}, retries "
        f"{ps.retries}, wait {ps.wait_s * 1e3:.3f} ms total / "
        f"{ps.wait_max_s * 1e3:.3f} ms max, epochs {lo}..{hi}, "
        f"{len(ring)} records retained")
    undurable = {"round_ms": med(spans["ingest.round"]),
                 "lanes_s": lanes_applied / (sum(spans["ingest.round"]) / 1e3)}
    log(f"serving round wall ms (median over {len(spans['ingest.round'])}; "
        f"trace spans, fused apply fenced): round "
        f"{med(spans['ingest.round']):.3f}, admit "
        f"{med(spans['ingest.admit']):.3f}, fused apply "
        f"{med(spans['ingest.fused_apply']):.3f}, publish (ring push) "
        f"{med(push_ms):.3f}; {lanes_applied} lanes applied, "
        f"{lanes_applied / (sum(spans['ingest.round']) / 1e3):.0f} lanes/s "
        f"of round wall")
    full = st.adj_packed.numel() * 4 + 4 * 4 * st.capacity
    log(f"ring push: {med(push_bytes) / 1e6:.3f} MB to the host per "
        f"publish (median, max {max(push_bytes) / 1e6:.3f} MB) beside "
        f"{full / 1e6:.1f} MB that a full-state copy of the five row "
        f"fields moves (a byte count from the shapes); retained records "
        f"{record_bytes(ring) / 1e6:.3f} MB host memory")
    log("state_at ms by replay depth: " + "; ".join(
        f"depth {d}: {med(v):.3f}" for d, v in sorted(state_at_ms.items())))
    log(f"epoch-mode get_paths_session (Q={QUERIES}) median "
        f"{med(session_ms):.3f} ms matched over {len(session_ms)}, "
        f"{med(starved_ms):.3f} ms starved over {len(starved_ms)} "
        f"(resolved at a pinned epoch after {SERVE_MAX_ROUNDS} collects); "
        f"time-travel session {med(tt_ms):.3f} ms over {len(tt_ms)}; "
        f"collects per session {rounds_info}")

    # a ring-validated index: built at the head, then a session whose state
    # fetch commits one round first serves pinned at the index's epoch
    e0, s0 = pool.snapshot_epoch()
    hubs = hub_slots(s0, INDEX_LANDMARKS)
    index, build_ms = ms_of(torch, lambda: build_index(
        s0, landmark_slots=hubs))
    ipairs = list(zip(rng.choice(deg_src, QUERIES).tolist(),
                      rng.integers(0, n, QUERIES).tolist()))

    def racing():
        refill(1)
        pool.pump()
        note()
        return pool.snapshot()

    b4_before = counts()["B4"]
    res, pin_ms = ms_of(torch, lambda: reach_session(
        racing, index, ipairs, on_conflict="epoch",
        fetch_epoch=pool.snapshot_epoch, ring=ring))
    if res.pinned_epoch != e0 or pool.epoch != e0 + 1:
        raise AssertionError(f"ring-validated session pinned at "
                             f"{res.pinned_epoch}, index epoch {e0}, head "
                             f"{pool.epoch}")
    if counts()["B4"] == b4_before or res.from_index == 0:
        raise AssertionError("the pinned session served nothing through B4")
    reach = check_reach(s0, ipairs, res.found, "ring-pinned index")
    log(f"ring-validated index: build_index over {INDEX_LANDMARKS} hubs at "
        f"epoch {e0} {build_ms:.3f} ms; reach_session with a round "
        f"committed in its state fetch {pin_ms:.3f} ms, pinned at epoch "
        f"{res.pinned_epoch} (head {pool.epoch}), from_index "
        f"{res.from_index}, fellback {res.fellback}, reachable "
        f"{reach}/{QUERIES}; answers equal scipy on epoch {e0}")
    del index, s0
    sync(torch)
    peak = torch.cuda.max_memory_allocated()

    # linearizability at full width: the claimed order replayed batch by
    # batch from epoch 0 must reach the pool's head bit for bit
    cur, n_b, t0 = st, 0, time.perf_counter()
    for bid in pool.linearization:
        t = pool.tickets[bid]
        cur, res_t = apply_ops_fast(cur, make_op_batch(
            t.ops, lanes=_next_pow2(len(t.ops)), device=DEVICE))
        if not np.array_equal(res_t[:len(t.ops)].cpu().numpy(), t.results):
            raise AssertionError(f"replay of batch {bid} ({t.client_id}) "
                                 f"differs from its ticket")
        n_b += 1
    sync(torch)
    replay_s = time.perf_counter() - t0
    same_result(cur, pool.snapshot(), "serial replay vs the pool's head")
    if not bool(transpose_invariant(cur)):
        raise AssertionError("transpose invariant broken at the pool's head")
    log(f"linearizability: {n_b} batches of the linearization replayed "
        f"through apply_ops_fast from epoch 0 in {replay_s:.1f} s: every "
        f"ticket's results and all six arrays of the head equal; the "
        f"transpose invariant holds")
    del cur

    server_launches = serve_end_to_end(torch, rng)
    launches = counts()
    require_launched(launches, ("B1", "B2", "B4"), "on the serving path")
    require_launched(server_launches, ("B3",), "in GraphCoServer.get_path")
    log(f"serving checks passed; peak device memory "
        f"{peak / 1e9:.3f} GB ({(peak - base_mem) / 1e9:.3f} GB above the "
        f"{base_mem / 1e9:.3f} GB held at the start); phase 8 launches "
        f"{launches}; phase 8 took {time.perf_counter() - t_phase:.1f} s")
    return launches, pool, undurable


def loaded_server(rng, **kw):
    """``GraphCoServer(ingest=True, index=True)`` (and ``kw``) with a
    Graph500 SCALE-12 graph loaded through its own ``submit`` and its index
    built: (server, the AddEdge ops loaded, load seconds)."""
    from repro_torch.core import OP_ADD_E, OP_ADD_V, R_EDGE_ADDED, R_TRUE
    from repro_torch.runtime.fault import FailurePolicy
    from repro_torch.runtime.serve_loop import GraphCoServer

    n = 1 << SERVER_SCALE
    u, v = graph500_edges(SERVER_SCALE, EDGEFACTOR, rng)
    e = np.unique(u * n + v)
    edges = [(OP_ADD_E, int(x // n), int(x % n)) for x in e]
    s = GraphCoServer(capacity=SERVER_CAPACITY, ingest=True, index=True,
                      index_landmarks=SERVER_LANDMARKS,
                      retain_epochs=SERVER_RETAIN,
                      failure_policy=FailurePolicy(max_restarts=3),
                      device=DEVICE, **kw)
    t0 = time.perf_counter()
    res = [s.submit([(OP_ADD_V, k) for k in range(n)])]
    for i in range(0, len(edges), SERVER_LOAD_LANES):
        res.append(s.submit(edges[i:i + SERVER_LOAD_LANES]))
    load_s = time.perf_counter() - t0
    res = np.concatenate(res)
    if not ((res == R_TRUE).sum() == n
            and (res == R_EDGE_ADDED).sum() == len(edges)):
        raise AssertionError("the server's load did not add every key and "
                             "edge")
    if s.index_tick() is not True or s.index_tick() is not False:
        raise AssertionError("index_tick did not build once")
    return s, edges, load_s


def serve_end_to_end(torch, rng):
    """``GraphCoServer(ingest=True, index=True)`` on a Graph500 SCALE-12
    graph loaded through its own ``submit``; every endpoint's answer
    equals scipy on the state it was answered on. Returns the launches
    counted in it (the counts keep running for the phase)."""
    from repro_torch.core import OP_ADD_V, R_RECOVERING

    c0 = counts()
    n = 1 << SERVER_SCALE
    s, edges, load_s = loaded_server(rng)
    deg = np.flatnonzero(s.state.ecnt.cpu().numpy()[:n] > 0)
    for r in range(SERVER_ROUNDS):
        for c in range(SERVER_CLIENTS):
            s.submit_client(f"s{c}", client_ops(rng, n, SERVE_LANES,
                                                removes=c == 3 and r % 3 == 0))
        s.pump()
    s.flush()
    pairs = list(zip(rng.choice(deg, QUERIES).tolist(),
                     rng.integers(0, n, QUERIES).tolist()))
    st = s.state
    out, _ = s.get_paths(pairs)
    check_answers(st, pairs, out, "server get_paths")
    alive = set(st.vkey[st.valive].tolist())
    k, l = next(p for p in pairs if p[0] in alive)
    pr = s.get_path(k, l)
    check_answers(st, [(k, l)], [(bool(pr.found),
                                  pr.keys[:int(pr.length)].tolist())],
                  "server get_path")
    stale = s.get_reach(pairs)
    check_reach(st, pairs, stale.found, "server get_reach (stale index)")
    if not s.index_tick():
        raise AssertionError("index_tick did not refresh a stale index")
    fresh = s.get_reach(pairs)
    check_reach(st, pairs, fresh.found, "server get_reach (fresh index)")
    if fresh.from_index == 0 or stale.from_index != 0:
        raise AssertionError("the index served stale or not at all")
    keys = [p[0] for p in pairs[:16]]
    got = s.get_reach_counts(keys)
    g, _, slot_of = live_graph(st)
    srcs, dist = scipy_dist(g, slot_of, keys)
    if got.tolist() != [int(np.isfinite(dist[x]).sum()) if x >= 0 else 0
                        for x in srcs]:
        raise AssertionError("server get_reach_counts differs from scipy")
    lo, hi = s.epoch_window()
    tt = s.get_reach_at(pairs, lo)
    check_reach(s.pool.state_at(lo), pairs, tt.found, "server get_reach_at")
    if tt.evicted or not s.get_reach_at(pairs, lo - 1).evicted:
        raise AssertionError("get_reach_at evicted flags are wrong")
    d = s.epoch_diff(lo, hi)
    rows = changed_rows(s.pool.state_at(lo), s.pool.state_at(hi))
    if d.evicted or d.rows != rows.tolist():
        raise AssertionError("server epoch_diff differs from a device "
                             "compare")
    # degraded mode without a WAL: reads pinned, writes rejected, then
    # handle_crash un-pins
    s.submit_client("s0", client_ops(rng, n, 8, removes=False))
    s.enter_degraded()
    pinned_e = s._pinned[0]
    s.pump()                               # the pool publishes on
    if s.pool.epoch != pinned_e + 1 or s.state is not s._pinned[1]:
        raise AssertionError("degraded reads did not pin")
    dpairs = pairs[:8]
    dout, _ = s.get_paths(dpairs)
    check_answers(s.pool.state_at(pinned_e), dpairs, dout,
                  "server degraded get_paths")
    rej = s.submit([(OP_ADD_V, n + 1)])
    tick = s.submit_client("s1", [(OP_ADD_V, n + 2)])
    if (rej != R_RECOVERING).any() or tick.status != "rejected":
        raise AssertionError("degraded writes were not rejected")
    wait = s.handle_crash()
    if s.degraded or s.state is not s.pool.snapshot():
        raise AssertionError("handle_crash left the server degraded")
    m = s.get_metrics()
    want = {"server.tt_calls": 2, "server.tt_evicted": 1,
            "server.epoch_diff_calls": 1, "server.rejected_writes": 2,
            "server.index_refreshes": 2, "ring.window_hi": s.pool.epoch,
            "ingest.applied": s.pool.stats.applied}
    bad = {k: (m.get(k), v) for k, v in want.items() if m.get(k) != v}
    if bad or m["server.degraded_reads"] < 1:
        raise AssertionError(f"get_metrics: {bad}")
    c1 = counts()
    launches = {k: c1[k] - c0[k] for k in c1}
    log(f"GraphCoServer: Graph500 SCALE {SERVER_SCALE} ({n} keys, "
        f"{len(edges)} edges) loaded through submit in {load_s:.1f} s "
        f"({SERVER_LOAD_LANES}-lane batches); {SERVER_CLIENTS} clients x "
        f"{SERVER_ROUNDS} rounds; get_paths, get_path, get_reach (stale and "
        f"fresh, from_index {fresh.from_index}), get_reach_counts, "
        f"get_reach_at (epoch {lo}; {lo - 1} evicted), epoch_diff "
        f"({len(d.rows)} rows), index_tick, degraded reads pinned at epoch "
        f"{pinned_e} while the pool published {pinned_e + 1}, writes "
        f"R_RECOVERING, handle_crash backoff {wait} s; every answer equals "
        f"scipy; get_metrics {len(m)} keys; launches {launches}")
    return launches


def serving_work(pool, rng):
    """One pump round (7 client batches queued first), one ``state_at`` at
    depth 8 and one ring push (the newest state against the one before),
    for the phase-5 profiles."""
    from repro_torch.core import EpochRing

    n = 1 << SCALE
    prev = pool.state_at(pool.epoch - 1)
    head = pool.snapshot()
    side = EpochRing(4)

    def pump():
        for c in range(SERVE_CLIENTS):
            pool.submit(f"p{c}", client_ops(rng, n, SERVE_LANES, False))
        pool.pump()

    def push():
        side.reset(0, prev)
        side.push(1, head)

    return {"pump": pump, "ring_push": push,
            "state_at_depth_8": lambda: pool.state_at(pool.epoch - 8)}


# ----------------------------------------------------------------------------
# Phase 9: durable ingest at full width
# ----------------------------------------------------------------------------
def fs_of(path: Path) -> str:
    """Filesystem type and free space of the mount holding ``path``: on a
    tmpfs or overlay mount an fsync costs nothing, so the type stands
    beside every fsync time."""
    real = os.path.realpath(path)
    best = ("?", "?")
    with open("/proc/mounts") as f:
        for line in f:
            dev, mnt, fstype = line.split()[:3]
            if (real == mnt or real.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) >= len(best[0]):
                best = (mnt, fstype)
    free = shutil.disk_usage(path).free
    return f"{best[1]} at {best[0]}, {free / 1e9:.1f} GB free"


def dir_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def phase_durable(torch, st, deg_src, rng, card, undurable):
    """Phase 9: (a) crash stages in process on the phase-3 end state, (b)
    the durable entry point killed by SIGKILL and recovered, (c) sessions
    on the recovered state, (d) ``GraphCoServer`` degrade/recover with a
    WAL. Returns the phase's launches."""
    from repro_torch.core import get_path_session, get_paths_session
    from repro_torch.obs import trace
    from repro_torch.runtime.fault import FaultInjector, SimulatedCrash
    from repro_torch.runtime.ingest import IngestPool
    from repro_torch.runtime.recovery import (GraphCheckpointer, recover,
                                              resume_pool)
    from repro_torch.runtime.wal import WriteAheadLog

    t_phase = time.perf_counter()
    shutil.rmtree(DURABLE_DIR, ignore_errors=True)
    DURABLE_DIR.mkdir(parents=True)
    free = shutil.disk_usage(DURABLE_DIR).free
    if free < DURABLE_NEED_BYTES:
        raise AssertionError(
            f"phase 9 needs {DURABLE_NEED_BYTES / 1e9:.1f} GB free under "
            f"{DURABLE_DIR}, the disk has {free / 1e9:.1f} GB")
    fs = fs_of(DURABLE_DIR)
    log(f"durable directory {DURABLE_DIR}: {fs}; card {card}")
    reset_counts()
    n = 1 << SCALE
    adir = DURABLE_DIR / "pool"
    wal_path, ckpt_dir = str(adir / "wal.log"), str(adir / "ckpt")
    pool_kw = dict(retain_epochs=SERVE_RETAIN,
                   max_coalesce_lanes=SERVE_COALESCE,
                   ckpt_every=DURABLE_CKPT_EVERY)
    wals = [WriteAheadLog(wal_path)]
    ckpt = GraphCheckpointer(ckpt_dir, keep=DURABLE_KEEP)
    publish_ms, ckpt_ms = [], []

    def instrument(p):
        """Time each publish and each whole checkpoint (the device -> host
        copy, which the ``ckpt.save`` span leaves out, included)."""
        publish, checkpoint = p._publish, p.checkpoint_now

        def timed_publish(state):
            epoch, ms = ms_of(torch, lambda: publish(state))
            publish_ms.append(ms)
            return epoch

        def timed_checkpoint(**kw):
            _, ms = ms_of(torch, lambda: checkpoint(**kw))
            ckpt_ms.append(ms)

        p._publish, p.checkpoint_now = timed_publish, timed_checkpoint
        return p

    pool = instrument(IngestPool(st, wal=wals[0], ckpt=ckpt, **pool_kw))
    pool.checkpoint_now()                   # the base every replay starts on
    base_bytes = dir_bytes(Path(ckpt_dir) / "step_000000000")
    queued = {}

    def refill(r):
        for c in range(SERVE_CLIENTS):
            t = queued.get(c)
            if t is None or t.status != "queued":
                queued[c] = pool.submit(f"c{c}", client_ops(
                    rng, n, SERVE_LANES, removes=False))
        t = queued.get("x")
        if r % 4 == 0 and (t is None or t.status != "queued"):
            queued["x"] = pool.submit("x", client_ops(
                rng, n, SERVE_EXCL_LANES, removes=True))

    recs, effects = [], []
    arm = dict(DURABLE_CRASHES)

    def after_crash(dead, exc):
        """The dead pool's published prefix against what ``recover``
        rebuilds from disk; returns the resumed pool."""
        nonlocal ckpt
        pub_epoch, pub_state = dead.snapshot_epoch()
        pre = list(dead.linearization)
        acked = [b for b, t in dead.tickets.items() if t.status == "applied"]
        unacked = [b for b in pre if dead.tickets[b].status != "applied"]
        prev_step = ckpt.latest_step()
        torn_dir = any(x.startswith(".tmp_step_")
                       for x in os.listdir(ckpt_dir))
        dead.wal.close()
        wal = WriteAheadLog(wal_path)       # a restart: reopen, truncate
        gck = GraphCheckpointer(ckpt_dir, keep=DURABLE_KEEP)
        rec, ms = ms_of(torch, lambda: recover(
            gck, wal, capacity=CAPACITY, retain_epochs=SERVE_RETAIN,
            device=DEVICE))
        where = f"after the {exc.stage} crash at epoch {exc.epoch}"
        lin = list(rec.linearization)
        lost = sorted(set(acked) - set(lin))
        if lost or lin[:len(pre)] != pre:
            raise AssertionError(f"{where}: acked batches lost {lost[:5]} or "
                                 f"the published prefix rewritten")
        at = rec.state if rec.epoch == pub_epoch else \
            rec.ring.state_at(pub_epoch)
        same_result(at, pub_state, f"{where}: recovered epoch {pub_epoch}")
        if exc.stage == "wal-append":
            ok = wal.stats.torn_drops > 0 and rec.epoch == pub_epoch
            effect = f"torn frame of {wal.stats.torn_drops} bytes dropped"
        elif exc.stage == "wal-fsync":
            ok = rec.epoch == pub_epoch + 1 == exc.epoch
            effect = "the durable unpublished round replayed (+1 epoch)"
        elif exc.stage == "ckpt-mid-write":
            ok = (torn_dir and rec.ckpt_step == prev_step < exc.epoch
                  and rec.replayed_rounds == rec.epoch - prev_step > 0
                  and rec.epoch == pub_epoch)
            effect = (f"restored step {rec.ckpt_step} + "
                      f"{rec.replayed_rounds} WAL records")
        else:
            ok = rec.epoch == pub_epoch and unacked \
                and set(unacked) <= set(lin)
            effect = f"{len(unacked)} published unacked batches kept"
        if not ok:
            raise AssertionError(f"{where}: the stage's effect is wrong: "
                                 f"epoch {rec.epoch}, published {pub_epoch}, "
                                 f"step {rec.ckpt_step} (before {prev_step})")
        effects.append(f"{exc.stage}: epoch {pub_epoch} -> {rec.epoch}, "
                       f"{effect}")
        recs.append((exc.stage, rec, ms))
        wals.append(wal)
        ckpt = gck
        new = instrument(resume_pool(rec, wal=wal, ckpt=gck, **pool_kw))
        new.tickets.update(dead.tickets)
        queued.clear()                      # unacked batches are resubmitted
        return new

    with trace.capture() as trec:
        for r in range(DURABLE_ROUNDS):
            refill(r)
            if r in arm:
                pool.fault = FaultInjector(plan=[("*", arm[r])])
            try:
                pool.pump()
            except SimulatedCrash as exc:
                pool = after_crash(pool, exc)
        spans = {}
        for ev in trec.events():
            if "dur" not in ev or (ev["name"] == "ingest.round"
                                   and "applied" not in ev.get("args", {})):
                continue          # a counter, or a round a crash cut short
            spans.setdefault(ev["name"], []).append(ev["dur"] / 1e3)
    if [s for s, _, _ in recs] != [s for _, s in DURABLE_CRASHES]:
        raise AssertionError(f"crashes {[s for s, _, _ in recs]}, planned "
                             f"{[s for _, s in DURABLE_CRASHES]}")
    lanes = sum(len(t.ops) for t in pool.tickets.values()
                if t.status == "applied")
    rounds_s = sum(spans["ingest.round"]) / 1e3
    ckpt_in_rounds = sum(ckpt_ms[1:]) / 1e3
    wal_records = sum(w.stats.records for w in wals)
    wal_bytes = sum(w.stats.bytes for w in wals)
    med = statistics.median
    log(f"durable pool ({card}): {DURABLE_ROUNDS} rounds of phase 8's mix, "
        f"WAL + checkpoint every {DURABLE_CKPT_EVERY} rounds (keep "
        f"{DURABLE_KEEP}), epochs 0..{pool.epoch}; crashes: "
        + "; ".join(effects))
    log(f"durable round wall ms (median over {len(spans['ingest.round'])} "
        f"whole rounds; {card}; {fs}): round {med(spans['ingest.round']):.3f}, admit "
        f"{med(spans['ingest.admit']):.3f}, fused apply "
        f"{med(spans['ingest.fused_apply']):.3f}, WAL append with fsync "
        f"{med(spans['wal.append']):.3f} (max {max(spans['wal.append']):.3f})"
        f", publish {med(publish_ms):.3f}; {lanes} lanes applied, "
        f"{lanes / rounds_s:.0f} lanes/s of round wall "
        f"({lanes / (rounds_s - ckpt_in_rounds):.0f} without the cadence "
        f"checkpoints) beside phase 8's undurable "
        f"{undurable['lanes_s']:.0f} lanes/s (round "
        f"{undurable['round_ms']:.3f} ms)")
    log(f"WAL: {wal_records} records, {wal_bytes} bytes, "
        f"{wal_bytes / wal_records:.0f} bytes a record; checkpoint "
        f"(blocking: D2H copies + ring dump, write, fsync, rename): step 0 "
        f"{ckpt_ms[0] / 1e3:.3f} s, {base_bytes / 1e9:.3f} GB; cadence "
        + ", ".join(f"{x / 1e3:.3f} s" for x in ckpt_ms[1:])
        + "; of which the ckpt.save spans (write, fsync, rename) "
        + ", ".join(f"{x / 1e3:.3f} s" for x in spans["ckpt.save"])
        + f" ({card}; {fs})")
    for stage, rec, ms in recs:
        p = rec.parts
        log(f"recover after {stage} ({card}): {ms:.1f} ms wall: checkpoint "
            f"load {p['ckpt_load'] * 1e3:.1f} ms (step {rec.ckpt_step}), copy "
            f"to the card {p['to_device'] * 1e3:.1f} ms, ring load "
            f"{p['ring_load'] * 1e3:.1f} ms, replay {rec.replayed_rounds} "
            f"records {p['replay'] * 1e3:.1f} ms "
            f"({p['replay'] * 1e3 / max(1, rec.replayed_rounds):.2f} ms a "
            f"record), {rec.skipped_records} skipped")
    last = recs[-1][1].state
    for w in wals:
        w.close()
    del pool, recs
    shutil.rmtree(adir)

    child_s = durable_child(DURABLE_DIR / "child", card)

    # (c) sessions on the recovered SCALE-16 state
    c0 = counts()
    pairs = list(zip(rng.choice(deg_src, QUERIES).tolist(),
                     rng.integers(0, n, QUERIES).tolist()))
    (out, nr), s_ms = ms_of(torch, lambda: get_paths_session(
        lambda: last, pairs))
    alive = set(last.vkey[last.valive].tolist())
    k, l = next(p for p in pairs if p[0] in alive)
    pr, p_ms = ms_of(torch, lambda: get_path_session(lambda: last, k, l))
    check_answers(last, pairs + [(k, l)], out + [(
        bool(pr.found), pr.keys[:int(pr.length)].tolist())],
        "sessions on the recovered state")
    c1 = counts()
    session_launches = {x: c1[x] - c0[x] for x in c1}
    require_launched(session_launches, BFS_KERNELS,
                     "on the recovered state")
    log(f"recovered SCALE-16 state: get_paths_session (Q={QUERIES}) "
        f"{s_ms:.3f} ms, {nr} collects, found {sum(f for f, _ in out)}; "
        f"get_path_session {p_ms:.3f} ms; answers equal scipy; launches "
        f"{session_launches}")
    del last

    durable_server(torch, rng, DURABLE_DIR / "server")
    launches = counts()
    # the durable_serve directory stays for phase 10's recover(mesh=)
    shutil.rmtree(DURABLE_DIR / "server")
    log(f"durable checks passed; child processes {child_s:.1f} s; phase 9 "
        f"launches {launches}; phase 9 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def durable_child(wdir: Path, card: str) -> float:
    """(b): ``repro_torch.launch.durable_serve`` at full capacity, killed
    by SIGKILL after step 7, then recovered for 3 steps; no acknowledged
    batch may be lost. Returns the children's wall seconds."""
    report = wdir / "report.jsonl"
    base = [sys.executable, "-m", "repro_torch.launch.durable_serve",
            "--wal-dir", str(wdir), "--report", str(report),
            "--capacity", str(CAPACITY), "--keys", str(1 << SCALE),
            "--clients", str(DURABLE_CHILD_CLIENTS), "--lanes",
            str(SERVE_LANES), "--ckpt-every", str(DURABLE_CHILD_CKPT_EVERY),
            "--device", DEVICE]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    p = subprocess.run(base + ["--steps", str(DURABLE_CHILD_STEPS),
                               "--crash-at-step", str(DURABLE_CHILD_CRASH)],
                       env=env, capture_output=True, text=True, timeout=600)
    t1 = time.perf_counter()
    if p.returncode != -9:
        raise AssertionError(f"the durable child returned {p.returncode}, "
                             f"want -9 (SIGKILL): {p.stderr[-2000:]}")
    ckpts = sorted(os.listdir(wdir / "ckpt"))
    p2 = subprocess.run(base + ["--recover", "--steps",
                                str(DURABLE_CHILD_RESUME)],
                        env=env, capture_output=True, text=True, timeout=600)
    t2 = time.perf_counter()
    if p2.returncode != 0:
        raise AssertionError(f"the recovering child returned "
                             f"{p2.returncode}: {p2.stderr[-2000:]}")
    lines = [json.loads(x) for x in report.read_text().splitlines()]
    acked, last_epoch = set(), 0
    for rec in lines:
        if rec["type"] == "recovered":
            break
        acked.update(rec["acked"])
        last_epoch = rec["epoch"]
    recovered = next(r for r in lines if r["type"] == "recovered")
    done = next(r for r in lines if r["type"] == "done")
    lost = acked - set(recovered["linearization"])
    if lost or recovered["epoch"] < last_epoch \
            or done["epoch"] <= recovered["epoch"] \
            or not set(recovered["linearization"]) <= set(
                done["linearization"]):
        raise AssertionError(f"kill -9 round trip: {len(lost)} acked "
                             f"batches lost, recovered epoch "
                             f"{recovered['epoch']} (last acked "
                             f"{last_epoch}), done {done['epoch']}")
    log(f"kill -9 round trip: durable_serve --capacity {CAPACITY} --keys "
        f"{1 << SCALE} --clients {DURABLE_CHILD_CLIENTS} --lanes "
        f"{SERVE_LANES} --ckpt-every {DURABLE_CHILD_CKPT_EVERY}: killed "
        f"after step {DURABLE_CHILD_CRASH} (rc -9) in {t1 - t0:.1f} s with "
        f"{len(acked)} batches acked up to epoch {last_epoch}, checkpoints "
        f"{ckpts}; --recover --steps {DURABLE_CHILD_RESUME} in "
        f"{t2 - t1:.1f} s: recovered at epoch {recovered['epoch']} with "
        f"every acked batch, served to epoch {done['epoch']} ({card}); "
        f"{p2.stdout.strip().splitlines()[0]}")
    return t2 - t0


def durable_server(torch, rng, wdir: Path):
    """(d): ``GraphCoServer(wal_dir=, ckpt_every=4)`` on phase 8's SCALE-12
    graph: a planned post-publish-pre-ack crash, degraded reads pinned and
    writes rejected, ``recover_now`` and ``handle_crash`` keep all six
    fields, then every endpoint answers as scipy."""
    from repro_torch.core import OP_ADD_V, R_RECOVERING, R_TRUE
    from repro_torch.runtime.fault import FaultInjector, SimulatedCrash

    n = 1 << SERVER_SCALE
    s, edges, load_s = loaded_server(rng, wal_dir=str(wdir),
                                     ckpt_every=DURABLE_SERVER_CKPT_EVERY)
    deg = np.flatnonzero(s.state.ecnt.cpu().numpy()[:n] > 0)
    for r in range(SERVER_ROUNDS):
        for c in range(SERVER_CLIENTS):
            s.submit_client(f"s{c}", client_ops(rng, n, SERVE_LANES,
                                                removes=c == 3 and r % 3 == 0))
        s.pump()
    s.flush()
    saves = s.pool.stats.ckpt_saves
    s.pool.fault = FaultInjector(plan=[("*", "post-publish-pre-ack")])
    crashed = s.submit_client("s0", client_ops(rng, n, 8, removes=False))
    try:
        s.pump()
    except SimulatedCrash:
        pass
    else:
        raise AssertionError("the planned post-publish-pre-ack crash did "
                             "not fire")
    s.enter_degraded()
    pinned_e, pinned = s._pinned
    pairs = list(zip(rng.choice(deg, QUERIES).tolist(),
                     rng.integers(0, n, QUERIES).tolist()))
    out, _ = s.get_paths(pairs[:8])
    check_answers(pinned, pairs[:8], out, "durable server degraded get_paths")
    rej = s.submit([(OP_ADD_V, n + 1)])
    tick = s.submit_client("s1", [(OP_ADD_V, n + 2)])
    if (rej != R_RECOVERING).any() or tick.status != "rejected" \
            or s.state is not pinned:
        raise AssertionError("degraded writes were not rejected or reads "
                             "not pinned")
    t0 = time.perf_counter()
    s.recover_now()
    recover_s = time.perf_counter() - t0
    if s.degraded or s.pool.epoch != pinned_e \
            or crashed.batch_id not in s.pool.linearization:
        raise AssertionError("recover_now lost the published round")
    same_result(s.state, pinned, "recover_now")
    wait = s.handle_crash()
    same_result(s.state, pinned, "handle_crash")
    st = s.state
    out, _ = s.get_paths(pairs)
    check_answers(st, pairs, out, "durable server get_paths")
    alive = set(st.vkey[st.valive].tolist())
    k, l = next(p for p in pairs if p[0] in alive)
    pr = s.get_path(k, l)
    check_answers(st, [(k, l)], [(bool(pr.found),
                                  pr.keys[:int(pr.length)].tolist())],
                  "durable server get_path")
    s.index_tick()
    res = s.get_reach(pairs)
    check_reach(st, pairs, res.found, "durable server get_reach")
    if (s.submit([(OP_ADD_V, n + 3)]) != R_TRUE).any():
        raise AssertionError("writes not accepted after recovery")
    log(f"durable GraphCoServer: Graph500 SCALE {SERVER_SCALE} loaded with "
        f"the WAL in {load_s:.1f} s ({len(edges)} edges), {saves} cadence "
        f"checkpoints (every {DURABLE_SERVER_CKPT_EVERY} rounds); planned "
        f"post-publish-pre-ack crash at epoch {pinned_e}; degraded reads "
        f"pinned, writes R_RECOVERING; recover_now {recover_s * 1e3:.1f} ms "
        f"and handle_crash (backoff {wait} s) keep all six fields; "
        f"get_paths, get_path, get_reach (from_index {res.from_index}) "
        f"equal scipy; recoveries {s.recoveries}")
    s.pool.wal.close()


def sharded_server_run(s, rng):
    """The endpoint sequence phase 10 drives on a dense and a mesh-sharded
    ``GraphCoServer`` from the same ``rng`` stream: (answers, the state the
    sessions were answered on, the pairs)."""
    n = 1 << SERVER_SCALE
    deg = np.flatnonzero(s.state.ecnt.cpu().numpy()[:n] > 0)
    out = []
    for r in range(SERVER_ROUNDS):
        tickets = [s.submit_client(f"s{c}", client_ops(
            rng, n, SERVE_LANES, removes=c == 3 and r % 3 == 0))
            for c in range(SERVER_CLIENTS)]
        s.pump()
        out.append([(t.status, None if t.results is None
                     else t.results.tolist()) for t in tickets])
    s.flush()
    pairs = list(zip(rng.choice(deg, QUERIES).tolist(),
                     rng.integers(0, n, QUERIES).tolist()))
    st = s.state
    out.append(s.get_paths(pairs))
    alive = set(st.vkey[st.valive].tolist())
    k, l = next(p for p in pairs if p[0] in alive)
    pr = s.get_path(k, l)
    out.append((bool(pr.found), pr.keys[:int(pr.length)].tolist(),
                int(pr.rounds)))
    for tick in (False, True):
        if tick and not s.index_tick():
            raise AssertionError("index_tick did not refresh")
        res = s.get_reach(pairs)
        out.append((res.found, res.from_index, res.fellback, res.stale))
    out.append(s.get_reach_counts([p[0] for p in pairs[:16]]).tolist())
    lo, hi = s.epoch_window()
    out.append((lo, hi, s.get_reach_at(pairs, lo).found,
                s.epoch_diff(lo, hi).rows))
    return out, st, pairs


def same_metrics(a: dict, b: dict, what: str):
    """``get_metrics`` of two servers equal on the server, ring and pool
    counters (wall-clock values and the process-global registry apart)."""
    keys = [k for k in b if k.split(".")[0] in ("server", "ring", "ingest")
            and not k.endswith("_s") and not isinstance(b[k], dict)]
    bad = {k: (a.get(k), b[k]) for k in keys if a.get(k) != b[k]}
    if bad or sorted(a) != sorted(b):
        raise AssertionError(f"{what}: get_metrics differ: {bad}")
    return len(keys)


def phase_sharded(torch, st, deg_src, batches, rng, card):
    """Phase 10: the mesh-sharded graph on one card (module docstring).
    Returns the launches of the sharded engines (``sharded_launches``)."""
    from repro_torch.convert import op_batch_from_numpy
    from repro_torch.core import (OP_ADD_V, OP_CON_V, apply_ops,
                                  apply_ops_fast, bfs, find_slots,
                                  get_path_session, get_paths_session,
                                  multi_bfs)
    from repro_torch.core import distributed, partition
    from repro_torch.core.distributed import make_graph_mesh
    from repro_torch.index import build_index, reach_session
    from repro_torch.obs import trace
    from repro_torch.runtime.ingest import IngestPool
    from repro_torch.runtime.recovery import GraphCheckpointer, recover
    from repro_torch.runtime.wal import WriteAheadLog

    n = 1 << SCALE
    t_phase = time.perf_counter()
    sync(torch)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    launched = dict.fromkeys(counts(), 0)    # the sharded engines' launches

    def sharded(fn):
        return counted(launched, fn)

    def ints(xs):
        return torch.tensor(xs, dtype=torch.int32, device=DEVICE)

    mesh = make_graph_mesh(shards=SHARDS)
    if mesh.distinct_devices != (st.device,):
        raise AssertionError(f"{SHARDS} shards on one card: {mesh}")
    sh, shard_ms = ms_of(torch, lambda: partition.shard_state(mesh, st))
    log(f"sharded: Graph500 SCALE {SCALE} state in {SHARDS} row blocks of "
        f"{sh.rows_per_shard} rows x {sh.words} words on "
        f"{mesh.devices[0]} (2 x {SHARDS} blocks, "
        f"{2 * sum(b.numel() for b in sh.adj_packed) * 4 / 1e9:.3f} GB); "
        f"shard_state {shard_ms:.1f} ms")

    # (a) mutation beside the dense engine, phase 3's batches
    dense, apply_d, apply_s = st, [], []
    for r, b in enumerate(batches):
        (dense2, dres), d_ms = ms_of(torch, lambda: apply_ops_fast(dense, b))
        (sh2, sres), s_ms = ms_of(torch, lambda: sharded(
            lambda: partition.apply_ops_fast(sh, b)))
        if not torch.equal(sres, dres):
            raise AssertionError(f"sharded batch {r}: result codes differ")
        same_result(partition.unshard(sh2), dense2, f"sharded batch {r}")
        dense, sh = dense2, sh2
        apply_d.append(d_ms)
        apply_s.append(s_ms)
    del dense2, sh2
    med = statistics.median
    log(f"(a) partition.apply_ops_fast == apply_ops_fast on {len(batches)} "
        f"batches of {LANES} lanes (codes + six arrays after unshard)")

    # (b) sessions on "hybrid_cuda": a mutator commits on the first fetches
    pairs = list(zip(rng.choice(deg_src, QUERIES).tolist(),
                     rng.integers(0, n, QUERIES).tolist()))
    left = [equal_mix_batch(rng, n, DEVICE) for _ in range(2)]
    cur, seen = {"s": sh}, []

    def fetch():
        if left:
            cur["s"], _ = partition.apply_ops_fast(cur["s"], left.pop(0))
        seen.append(cur["s"])
        return cur["s"]

    out, nr = sharded(lambda: get_paths_session(fetch, pairs,
                                                backend="hybrid_cuda"))
    if nr <= 2:
        raise AssertionError(f"the sharded session did not retry ({nr})")
    sh = seen[-1]
    dense = partition.unshard(sh)
    check_answers(dense, pairs, out, "sharded get_paths_session")
    sk = find_slots(dense, ints([k for k, _ in pairs]))
    sl = find_slots(dense, ints([l for _, l in pairs]))
    want = multi_bfs(dense, sk, sl, backend="hybrid_cuda")
    c0 = dict(launched)
    with trace.capture() as rec:
        got = sharded(lambda: partition.multi_bfs(sh, sk, sl,
                                                  backend="hybrid_cuda"))
    same_result(got, want, "sharded multi_bfs hybrid_cuda")
    span = [e for e in rec.events() if e["name"] == "bfs.session.sharded"]
    xargs = span[0]["args"]
    steps = int(got.supersteps)
    per_step = {k: (launched[k] - c0[k]) / steps for k in ("B1", "B2")}
    alive = set(dense.vkey[dense.valive].tolist())
    k, l = next(p for p in pairs if p[0] in alive)
    pr = sharded(lambda: get_path_session(lambda: sh, k, l,
                                          backend="hybrid_cuda"))
    check_answers(dense, [(k, l)], [(bool(pr.found),
                                     pr.keys[:int(pr.length)].tolist())],
                  "sharded get_path_session")
    one = sharded(lambda: partition.traverse(sh, sk[:1], sl[:1],
                                             backend="hybrid_cuda"))
    ref = bfs(dense, sk[:1], sl[:1], backend="hybrid_cuda")
    for f, x, y in zip(ref._fields, one, ref):
        if not torch.equal(x[0], y):
            raise AssertionError(f"sharded Q = 1 traversal: {f} differs")
    sess_s, sess_d, single_s, single_d = [], [], [], []
    for _ in range(SHARD_REPS):
        sess_s.append(ms_of(torch, lambda: sharded(lambda: get_paths_session(
            lambda: sh, pairs, backend="hybrid_cuda")))[1])
        sess_d.append(ms_of(torch, lambda: get_paths_session(
            lambda: dense, pairs, backend="hybrid_cuda"))[1])
        single_s.append(ms_of(torch, lambda: sharded(lambda: get_path_session(
            lambda: sh, k, l, backend="hybrid_cuda")))[1])
        single_d.append(ms_of(torch, lambda: get_path_session(
            lambda: dense, k, l, backend="hybrid_cuda"))[1])
    log(f"(b) sharded get_paths_session (Q={QUERIES}, hybrid_cuda) retried "
        f"to {nr} collects under a mutator; multi_bfs == dense hybrid_cuda "
        f"on every field; get_path_session and the Q = 1 traversal == the "
        f"dense single bfs (B3); answers equal scipy")

    # (c) the other kernel backends on the shards
    for be in ("dense_cuda", "packed_cuda"):
        got, be_ms = ms_of(torch, lambda: sharded(
            lambda: partition.multi_bfs(sh, sk, sl, backend=be)))
        same_result(got, want, f"sharded multi_bfs {be}")
        log(f"(c) sharded multi_bfs {be} == dense hybrid_cuda on every "
            f"field ({be_ms:.1f} ms, Q={QUERIES})")
        del got

    # (d) the index: a gathered build, and a stale session's sharded fallback
    hubs = hub_slots(dense, INDEX_LANDMARKS)
    si, build_ms = ms_of(torch, lambda: sharded(
        lambda: build_index(sh, landmark_slots=hubs)))
    same_index(si, build_index(dense, landmark_slots=hubs),
               "sharded build_index")
    stale, _ = partition.apply_ops_fast(sh, equal_mix_batch(rng, n, DEVICE))
    c0 = dict(launched)
    res = sharded(lambda: reach_session(lambda: stale, si, pairs))
    fb = {x: launched[x] - c0[x] for x in launched}
    if not res.stale or res.fellback != len(pairs):
        raise AssertionError("the stale index served on the sharded state")
    require_launched(fb, ("B1", "B2"), "in the sharded reach_session "
                     "fallback")
    check_reach(partition.unshard(stale), pairs, res.found,
                "sharded reach_session fallback")
    del si, stale
    log(f"(d) build_index over the {INDEX_LANDMARKS} hubs on the sharded "
        f"state ({build_ms:.1f} ms, gathered) == the dense build; a stale "
        f"reach_session fell back to the sharded BFS (launches {fb}) and "
        f"answers as scipy")

    # (e) the pool with its ring, the server, and recovery on the mesh
    # both pools write a WAL; the sharded one also checkpoints epoch 0,
    # the base its recover(mesh=) replays every round onto
    sdir = DURABLE_DIR / "sharded"
    wals = [WriteAheadLog(str(DURABLE_DIR / "dense_wal.log")),
            WriteAheadLog(str(sdir / "wal.log"))]
    dpool = IngestPool(dense, retain_epochs=SERVE_RETAIN,
                       max_coalesce_lanes=SERVE_COALESCE, wal=wals[0])
    spool = IngestPool(partition.shard_state(mesh, dense), mesh=mesh,
                       retain_epochs=SERVE_RETAIN,
                       max_coalesce_lanes=SERVE_COALESCE, wal=wals[1],
                       ckpt=GraphCheckpointer(str(sdir / "ckpt"), keep=1))
    spool.checkpoint_now()
    round_d, round_s = [], []
    for r in range(SHARD_SERVE_ROUNDS):
        progs = [(f"c{c}", client_ops(rng, n, SERVE_LANES, removes=False))
                 for c in range(SERVE_CLIENTS)]
        if r % 4 == 0:
            progs.append(("x", client_ops(rng, n, SERVE_EXCL_LANES,
                                          removes=True)))
        tickets = []
        for pool, walls in ((dpool, round_d), (spool, round_s)):
            tickets.append([pool.submit(c, ops) for c, ops in progs])
            rounds, ms = ms_of(torch, lambda: sharded(pool.flush)
                               if pool is spool else pool.flush())
            walls.append(ms / max(1, rounds))
        for a, b in zip(*tickets):
            if (a.status, a.epoch, a.results.tolist()) != (
                    b.status, b.epoch, b.results.tolist()):
                raise AssertionError(f"sharded pool round {r}: ticket "
                                     f"{a.batch_id} differs")
    lo, hi = spool.epoch_window()
    if (lo, hi) != dpool.epoch_window():
        raise AssertionError("the pools' windows differ")
    for e in (lo, (lo + hi) // 2, hi):
        got = spool.state_at(e)      # the newest epoch: the published shards
        if isinstance(got, partition.ShardedGraphState):
            got = partition.unshard(got)
        same_result(got, dpool.state_at(e), f"sharded pool state_at({e})")
    for w in wals:
        w.close()
    rec_w, wal_ms = ms_of(torch, lambda: sharded(lambda: recover(
        str(sdir / "ckpt"), str(sdir / "wal.log"), mesh=mesh)))
    if (rec_w.epoch, rec_w.replayed_rounds) != (hi, hi) \
            or rec_w.linearization != spool.linearization:
        raise AssertionError("recover(mesh=) of the sharded pool's WAL "
                             "stopped short")
    same_result(partition.unshard(rec_w.state),
                partition.unshard(spool.snapshot()),
                "recover(mesh=) of the sharded pool")
    del dpool, spool, rec_w
    log(f"(e) IngestPool(mesh=) over {SHARD_SERVE_ROUNDS} rounds of phase "
        f"8's client mix: every ticket and state_at of epochs {lo}, "
        f"{(lo + hi) // 2}, {hi} == the dense pool's; a round (with a WAL "
        f"append) {med(round_s):.3f} ms sharded, {med(round_d):.3f} ms "
        f"dense; recover(mesh=) of its checkpoint at epoch 0 and WAL "
        f"replayed {hi} records onto the shards == its head in "
        f"{wal_ms:.1f} ms")
    seed = int(rng.integers(1 << 30))
    servers = []
    for kw in ({}, {"mesh": make_graph_mesh(shards=SHARDS)}):
        s, _, load_s = loaded_server(np.random.default_rng(seed), **kw)
        answers, sst, spairs = sharded_server_run(
            s, np.random.default_rng(seed + 1))
        servers.append((s, answers, sst, spairs, load_s))
    (ds, da, dst, _, dload), (ss, sa, sst, spairs, sload) = servers
    if not isinstance(ss.state, partition.ShardedGraphState) or sa != da:
        raise AssertionError("GraphCoServer(mesh=) answers differ from the "
                             "dense server's")
    check_answers(partition.unshard(sst), spairs, sa[SERVER_ROUNDS][0],
                  "GraphCoServer(mesh=) get_paths")
    nm = same_metrics(ss.get_metrics(), ds.get_metrics(),
                      "GraphCoServer(mesh=)")
    del servers, ds, ss, dst, sst
    log(f"(e) GraphCoServer(mesh=) on Graph500 SCALE {SERVER_SCALE} "
        f"(loaded in {sload:.1f} s; dense {dload:.1f} s): every endpoint "
        f"answer and {nm} get_metrics counters == the dense server's")
    wdir = DURABLE_DIR / "child"
    rec_d = recover(str(wdir / "ckpt"), str(wdir / "wal.log"), device=DEVICE)
    rec_s, rec_ms = ms_of(torch, lambda: sharded(lambda: recover(
        str(wdir / "ckpt"), str(wdir / "wal.log"), mesh=mesh)))
    if (rec_s.epoch, rec_s.linearization) != (rec_d.epoch,
                                              rec_d.linearization):
        raise AssertionError("recover(mesh=) reached another epoch")
    same_result(partition.unshard(rec_s.state), rec_d.state,
                "recover(mesh=)")
    log(f"(e) recover(mesh=) of phase 9's durable_serve directory: epoch "
        f"{rec_s.epoch}, {rec_s.replayed_rounds} records replayed on the "
        f"shards, six arrays == the dense recover; {rec_ms:.1f} ms")
    del rec_d, rec_s

    # (f) the legacy fully row-sharded engines at the cell's width
    opc, k1, k2 = equal_mix(rng, n, LANES)
    opc[opc == OP_ADD_V] = OP_CON_V          # owner blocks are full
    lb = op_batch_from_numpy(opc, k1, k2, np.full(LANES, -1), DEVICE)
    rs = distributed.shard_graph(mesh, dense)
    (rs2, lres), dapply_ms = ms_of(torch, lambda: distributed.dapply_ops(
        mesh, rs, lb))
    spec, sres = apply_ops(dense, lb)
    got = rs2.gather()
    if not torch.equal(lres, sres):
        raise AssertionError("dapply_ops codes differ from apply_ops")
    for f in ("vkey", "valive", "vver", "adj_packed", "adj_in_packed"):
        if not torch.equal(getattr(got, f), getattr(spec, f)):
            raise AssertionError(f"dapply_ops: {f} differs from apply_ops")
    if not torch.equal(got.ecnt[got.valive], spec.ecnt[spec.valive]):
        raise AssertionError("dapply_ops: ecnt of a live slot differs")
    del rs
    dbfs_ms = []
    for src in sk[:2].tolist():
        got_b, b_ms = ms_of(torch, lambda: distributed.dbfs(mesh, rs2, src,
                                                            -1))
        dbfs_ms.append(b_ms)
        ref = bfs(spec, src, -1, backend="hybrid_cuda")
        for f, x, y in zip(ref._fields, got_b, ref):
            if not torch.equal(x, y):
                raise AssertionError(f"dbfs from {src}: {f} differs")
    # a path to the vertex farthest from the last dbfs source
    kk, ll = (int(spec.vkey[x]) for x in (src, int(got_b[2].argmax())))
    (ok, plen, pkeys, prounds), dpath_ms = ms_of(
        torch, lambda: distributed.dget_path_session(mesh, lambda: rs2,
                                                     kk, ll))
    check_answers(spec, [(kk, ll)], [(ok, pkeys)], "dget_path_session")
    del rs2, got, spec
    log(f"(f) legacy engines at V = {CAPACITY}: dapply_ops ({LANES} lanes, "
        f"AddVertex lanes as HasVertex: the owner blocks are full) == "
        f"apply_ops (codes, five arrays, live ecnt) in {dapply_ms:.1f} ms; "
        f"dbfs from 2 sources == bfs in "
        + ", ".join(f"{x:.1f}" for x in dbfs_ms)
        + f" ms; dget_path_session {dpath_ms:.1f} ms, {prounds} collects, "
        f"found {ok} ({plen} vertices), equal scipy")

    # (g) the default mesh: every visible card once
    m1 = make_graph_mesh()
    if m1.size != torch.cuda.device_count() or m1.size != 1:
        raise AssertionError(f"make_graph_mesh() on one card: {m1}")
    s1 = partition.shard_state(m1, dense)
    o1, _ = sharded(lambda: get_paths_session(lambda: s1, pairs))
    od, _ = get_paths_session(lambda: dense, pairs)
    if o1 != od:
        raise AssertionError("the one-shard session differs from the dense")
    del s1
    log(f"(g) make_graph_mesh() = {m1}: its session == the dense one")

    require_launched(launched, SHARD_KERNELS, "on the sharded path")
    peak = torch.cuda.max_memory_allocated()
    log(f"sharded vs dense ({card}): apply_ops_fast {med(apply_s):.3f} vs "
        f"{med(apply_d):.3f} ms/batch (B={LANES}); get_paths_session "
        f"{med(sess_s):.3f} vs {med(sess_d):.3f} ms (Q={QUERIES}); "
        f"get_path_session {med(single_s):.3f} vs {med(single_d):.3f} ms")
    log(f"sharded session (Q={QUERIES}): {xargs['supersteps']} supersteps, "
        f"exchange {xargs['exchange_bytes']} bytes (supersteps x Q x "
        f"{sh.words} words x 4 B x {SHARDS} shards)")
    log(f"sharded launches a superstep: B1 {per_step['B1']:.2f}, B2 "
        f"{per_step['B2']:.2f} (one a shard on the direction taken)")
    log(f"sharded peak memory: {peak / 1e9:.3f} GB ({base_mem / 1e9:.3f} "
        f"GB held at the start)")
    log(f"phase 10 launches {launched}; phase 10 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    batch = batches[0]
    work = {   # for the phase-5 profiles, on the sharded state
        "sharded_apply_ops_fast": lambda: partition.apply_ops_fast(sh, batch),
        "sharded_get_paths_session": lambda: get_paths_session(
            lambda: sh, pairs, backend="hybrid_cuda"),
        "sharded_get_path_session": lambda: get_path_session(
            lambda: sh, k, l, backend="hybrid_cuda"),
    }
    return launched, work


# ----------------------------------------------------------------------------
# Phase 11: the LM co-serving path at qwen2-1.5b's full width
# ----------------------------------------------------------------------------
def greedy(torch, model, params, toks, new: int):
    """Greedy decode of ``new`` tokens after a prefill of ``toks``, timed
    step by step on the card: (tokens [B, new] as numpy, prefill ms, the
    decode steps' ms)."""
    b, p = toks.shape
    out = np.zeros((b, new), np.int32)
    with torch.inference_mode():
        sync(torch)
        t0 = time.perf_counter()
        last, caches = model.prefill(params, {"tokens": toks})
        caches = model.cache_from_prefill(caches, LM_CACHE)
        tok = torch.argmax(last, dim=-1).to(torch.int32)
        sync(torch)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        step_ms = []
        for i in range(new):
            out[:, i] = tok.cpu().numpy()
            t0 = time.perf_counter()
            logits, caches = model.decode_step(params, caches, tok, p + i)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            sync(torch)
            step_ms.append((time.perf_counter() - t0) * 1e3)
    return out, prefill_ms, step_ms


def decode_errors(torch, model, params, full, last, caches, toks, p: int,
                  tol: float = LM_TOL, rtol: float = 0.0, what: str = "bf16"):
    """Teacher-forced decode of ``toks`` [B, S] from position ``p`` on the
    decode-ready ``caches``, held against the full forward's logits
    ``full`` [B, S, V] (and the prefill's ``last`` against position p - 1):
    |diff| within ``tol`` + ``rtol`` |forward| at every position, the
    argmax equal wherever the forward's top-2 margin exceeds 2 ``tol``,
    every logit finite. Returns (the max |diff| per position, the clear
    positions, the largest |logit|)."""
    errs = [float((last - full[:, p - 1]).abs().max())]
    over = float(((last - full[:, p - 1]).abs()
                  - rtol * full[:, p - 1].abs()).max())
    finite = bool(torch.isfinite(full).all() and torch.isfinite(last).all())
    agree = clear = 0
    for t in range(p, full.shape[1]):
        lg, caches = model.decode_step(params, caches, toks[:, t], t)
        want = full[:, t]
        errs.append(float((lg - want).abs().max()))
        over = max(over, float(((lg - want).abs() - rtol * want.abs()).max()))
        finite &= bool(torch.isfinite(lg).all())
        top2 = want.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * tol
        clear += int(sure.sum())
        agree += int((lg.argmax(-1) == want.argmax(-1))[sure].sum())
    if not finite:
        raise AssertionError(f"a logit of the full-width model ({what}) is "
                             f"not finite")
    if over > tol or agree != clear:
        raise AssertionError(
            f"decode differs from the full forward ({what}): max |diff| "
            f"{max(errs):.4f} (tolerance {tol} + {rtol} |logit|); argmax "
            f"equal on {agree} of {clear} positions with a clear top-2 "
            f"margin")
    return errs, clear, float(full.abs().max())


def lm_serve_traffic(rng, n: int, deg, issued: list):
    """``serve()``'s ``clients=`` (LM_TENANTS equal-mix batches a step) and
    ``query_stream`` (LM_QUERY_BATCH pairs every 4th step, a lone pair on
    the others; every pair issued is appended to ``issued``)."""
    def clients(i):
        return [(f"lm{c}", client_ops(rng, n, SERVE_LANES, removes=False))
                for c in range(LM_TENANTS)]

    def queries(i):
        k = LM_QUERY_BATCH if i % 4 == 0 else 1
        pairs = list(zip(rng.choice(deg, k).tolist(),
                         rng.integers(0, n, k).tolist()))
        issued.extend(pairs)
        return pairs if k > 1 else pairs[0]

    return clients, queries


def check_launcher(proc, tokens: int, what: str):
    """``python -m repro_torch.launch.serve ... --ingest`` exited 0 with its
    decode line for ``tokens`` tokens, its ingest, ring tour and
    stale-index lines."""
    lines = proc.stdout.splitlines()
    heads = ("decoded ", "ingest: ", "time-travel: reach", "time-travel: "
             "epoch", "epoch-diff ", "ring endpoints: ", "stale-index reach")
    missing = [h for h in heads if not any(x.startswith(h) for x in lines)]
    if proc.returncode != 0 or missing or not lines[0].startswith(
            f"decoded {tokens} tokens"):
        raise AssertionError(f"repro_torch.launch.serve {what}: rc "
                             f"{proc.returncode}, missing {missing}; "
                             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")


def phase_lm(torch, rng, card, seed: int):
    """Phase 11: the LM co-serving path at qwen2-1.5b's full width (module
    docstring). Returns the launches counted inside ``serve()``
    (``lm_serve_launches``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.runtime.serve_loop import serve

    t_phase = time.perf_counter()
    sync(torch)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    cfg = get_config(LM_ARCH)
    shape = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
             cfg.d_ff, cfg.vocab, cfg.dtype, cfg.tie_embeddings)
    if LM_SMOKE:                      # a rehearsal on the CPU
        cfg = cfg.smoke()
    elif shape != (28, 1536, 12, 2, 128, 8960, 151936, "bfloat16", True):
        raise AssertionError(f"{LM_ARCH} is not at its published width: "
                             f"{shape}")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(DEVICE).manual_seed(seed))
    sync(torch)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"LM {LM_ARCH}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv} KV heads of {cfg.hd}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}, tied embeddings; "
        f"{n_params:,} params (param_count() {cfg.param_count():,}, the "
        f"difference the q/k/v biases), {w_bytes / 1e9:.3f} GB, drawn on the "
        f"card from a seeded torch.Generator in {init_s:.2f} s")

    # (a) decode against the full forward, bit-stable greedy tokens
    b, p = LM_BATCH, LM_PROMPT
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (b, p + LM_CHECK_STEPS)).astype(np.int32)).to(DEVICE)
    with torch.inference_mode():
        full, _, _ = model.forward(params, {"tokens": toks})
        last, caches = model.prefill(params, {"tokens": toks[:, :p]})
        caches = model.cache_from_prefill(caches, LM_CACHE)
        errs, clear, scale = decode_errors(torch, model, params, full, last,
                                           caches, toks, p)
        del full, caches
    log(f"LM (a): prefill of {b} x {p} tokens + {LM_CHECK_STEPS} teacher-"
        f"forced decode steps against one forward of {p + LM_CHECK_STEPS}: "
        f"max |diff| {max(errs):.5f} (prefill {errs[0]:.5f}; tolerance "
        f"{LM_TOL}, logits up to {scale:.3f}); argmax equal on all {clear} "
        f"positions whose top-2 margin exceeds {2 * LM_TOL}; every logit "
        f"finite")
    prompts = rng.integers(0, cfg.vocab, (b, p)).astype(np.int32)
    ptoks = torch.from_numpy(prompts).to(DEVICE)
    runs = [greedy(torch, model, params, ptoks, LM_NEW) for _ in range(2)]
    if not np.array_equal(runs[0][0], runs[1][0]):
        raise AssertionError("greedy tokens differ between two runs")
    steps = runs[0][2][1:] + runs[1][2][1:]       # the first step warms up
    med = statistics.median(steps)
    p90 = float(np.percentile(steps, 90))
    kv_bytes = 2 * cfg.n_layers * b * LM_CACHE * cfg.n_kv * cfg.hd * 2  # bf16
    bound_ms = (w_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"LM (d): prefill {runs[0][1]:.2f} / {runs[1][1]:.2f} ms "
        f"({b} x {p}, cache {LM_CACHE}); decode step median {med:.3f} ms, "
        f"p90 {p90:.3f} ms over {len(steps)} steps (B = {b}), "
        f"{b / med * 1e3:.1f} tokens/s; bound {bound_ms:.3f} ms (weights "
        f"{w_bytes / 1e9:.3f} GB + KV cache {kv_bytes / 1e9:.3f} GB read "
        f"once at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), measured / bound "
        f"{med / bound_ms:.1f}x; greedy tokens equal in both runs; {card}")

    # (b) serve() co-serving the SCALE-12 graph
    n = 1 << SERVER_SCALE
    s, _, load_s = loaded_server(rng)
    deg = np.flatnonzero(s.state.ecnt.cpu().numpy()[:n] > 0)
    issued: list = []
    clients, queries = lm_serve_traffic(rng, n, deg, issued)
    reset_counts()
    out, stats = serve(model, params, prompts, max_new_tokens=LM_NEW,
                       cache_len=LM_CACHE, graph=s, clients=clients,
                       query_stream=queries)
    sync(torch)
    launches = counts()
    lanes = LM_NEW * LM_TENANTS * SERVE_LANES
    want = {"decode_steps": LM_NEW, "decode_tokens": b * LM_NEW,
            "getpath_calls": len(issued), "graph_ops": lanes,
            "ingest_batches": LM_NEW * LM_TENANTS, "recoveries": 0}
    got = {k: getattr(stats, k) for k in want}
    if got != want or stats.index_hits == 0:
        raise AssertionError(f"ServeStats: {got} != {want} "
                             f"(index_hits {stats.index_hits})")
    if not np.array_equal(out, runs[0][0]):
        raise AssertionError("serve() decoded other tokens than the bare "
                             "greedy loop on the same prompts")
    require_launched(launches, ("B1", "B2", "B4"), "inside serve()")
    st = s.state
    pairs = list(zip(rng.choice(deg, QUERIES).tolist(),
                     rng.integers(0, n, QUERIES).tolist()))
    res = s.get_reach(pairs)
    reach = check_reach(st, pairs, res.found, "get_reach after serve()")
    log(f"LM (b): serve() of {b} x {p} prompts, {LM_NEW} new tokens, cache "
        f"{LM_CACHE}, beside GraphCoServer(ingest, index) on Graph500 "
        f"SCALE {SERVER_SCALE} (loaded in {load_s:.1f} s): "
        f"{stats.wall_s:.2f} s, {stats.decode_tokens / stats.wall_s:.1f} "
        f"tokens/s; {stats.graph_ops} lanes from {LM_TENANTS} tenants in "
        f"{stats.ingest_fused_calls} fused applies ({stats.ingest_retries} "
        f"retries), {stats.getpath_calls} pairs queried ({stats.index_hits} "
        f"from the index, {stats.index_misses} fell back, "
        f"{stats.getpath_rounds} rounds), {stats.index_refreshes} index "
        f"refreshes; tokens equal the bare loop's; get_reach of {QUERIES} "
        f"pairs after it equals scipy ({reach} reachable, from_index "
        f"{res.from_index}); launches inside serve() {launches}")

    # (d) device idle share of one decode step and of one serve() step
    issued.clear()
    with torch.inference_mode():
        _, caches = model.prefill(params, {"tokens": ptoks})
        caches = model.cache_from_prefill(caches, LM_CACHE)
    tok = ptoks[:, -1]

    def decode():
        with torch.inference_mode():
            model.decode_step(params, caches, tok, p)

    def serve_step():
        """One step of serve()'s loop body, a batch query step."""
        for cid, ops in clients(0):
            s.submit_client(cid, ops)
        s.pump()
        s.worker_tick("ingest")
        s.check_health()
        s.index_tick()
        s.get_reach(queries(0))
        decode()

    for name, fn in (("lm_decode_step", decode),
                     ("lm_serve_step", serve_step)):
        wall, trace_file = profiled(torch, fn, f"chip_smoke_{name}")
        busy, per_name = _busy_ms(trace_file)
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:4]
        log(f"profile {name}: wall {wall:.3f} ms under the profiler, device "
            + (f"busy {busy:.3f} ms (idle {100 * (1 - busy / wall):.1f}%); "
               + "; ".join(f"{k} {v:.3f} ms" for k, v in top)
               if per_name else "busy not measured (no device events)"))
    del caches, params
    peak = torch.cuda.max_memory_allocated() - base_mem

    # (c) the entry point as a subprocess
    cmd = [sys.executable, "-m", "repro_torch.launch.serve",
           "--smoke" if LM_SMOKE else "--no-smoke",
           "--ingest", "--batch", str(b), "--prompt-len", str(p), "--new",
           str(LM_NEW), "--cache-len", str(LM_CACHE), "--device", DEVICE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=LM_CHILD_TIMEOUT_S,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    child_s = time.perf_counter() - t0
    check_launcher(proc, b * LM_NEW, "")
    lines = proc.stdout.splitlines()
    log(f"LM (c): python -m repro_torch.launch.serve --no-smoke --ingest "
        f"--batch {b} --prompt-len {p} --new {LM_NEW} --cache-len "
        f"{LM_CACHE}: rc 0 in {child_s:.1f} s; " + " | ".join(lines))
    log(f"LM: peak device memory {peak / 1e9:.3f} GB above the phase's "
        f"start; phase 11 {time.perf_counter() - t_phase:.1f} s; {card}")
    return launches


# ----------------------------------------------------------------------------
# Phase 12: the MoE, SSM, RG-LRU and encoder-decoder families at full width
# ----------------------------------------------------------------------------
def cache_bytes(model, b: int, cache_len: int) -> int:
    """Bytes one decode step reads of the decoder caches (allocated on the
    meta device): each attention layer's whole K/V cache, as the step
    reads it, and each SSM / RG-LRU state and conv tail twice (read and
    written)."""
    from repro_torch.models import transformer as T

    total = 0
    caches = model.init_cache(b, cache_len, device="meta")
    for (pat, _), group in zip(T._pattern(model.cfg), caches):
        for li, kind in enumerate(pat):
            n = sum(t.numel() * t.element_size() for t in group[str(li)])
            total += n if kind in T.ATTN_KINDS else 2 * n
    return total


def routed_per_step(torch, model, params, ptoks, out):
    """Replays greedy's steps (prefill of ``ptoks``, then its tokens
    ``out``) with ``moe.route`` counting: for each step, the distinct
    experts routed to, summed over the MoE layers."""
    from repro_torch.models import moe

    route, seen, steps = moe.route, [], []

    def counting(cfg, router, x, cap):
        r = route(cfg, router, x, cap)
        seen.append(int(torch.unique(r["se"][r["keep"]]).numel()))
        return r

    moe.route = counting
    try:
        with torch.inference_mode():
            _, caches = model.prefill(params, {"tokens": ptoks})
            caches = model.cache_from_prefill(caches, LM_CACHE)
            p = ptoks.shape[1]
            for i in range(out.shape[1]):
                seen.clear()
                tok = torch.from_numpy(out[:, i]).to(DEVICE)
                model.decode_step(params, caches, tok, p + i)
                steps.append(sum(seen))
    finally:
        moe.route = route
    return steps


def decode_profile(torch, model, params, ptoks, name: str):
    """Phase 5's ``profiled`` trace of one decode step after a prefill of
    ``ptoks``: (busy ms, wall ms)."""
    with torch.inference_mode():
        _, caches = model.prefill(params, {"tokens": ptoks})
        caches = model.cache_from_prefill(caches, LM_CACHE)
    tok, p = ptoks[:, -1], ptoks.shape[1]

    def decode():
        with torch.inference_mode():
            model.decode_step(params, caches, tok, p)

    wall, trace_file = profiled(torch, decode, f"chip_smoke_{name}")
    busy, per_name = _busy_ms(trace_file)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:4]
    log(f"profile {name}: wall {wall:.3f} ms under the profiler, device "
        + (f"busy {busy:.3f} ms (idle {100 * (1 - busy / wall):.1f}%); "
           + "; ".join(f"{k} {v:.3f} ms" for k, v in top)
           if per_name else "busy not measured (no device events)"))
    return busy, wall


def family_check(torch, model, params, cfg, p: int, seed: int, tol, rtol=0.0,
                 what="bf16"):
    """(a): a prefill of LM_BATCH x ``p`` tokens and LM_CHECK_STEPS
    teacher-forced decode steps against one full forward (whisper: the
    decoder over ``encode`` of seeded random frames, its self caches
    padded to LM_CACHE), held by ``decode_errors`` at ``tol`` (None: only
    measured). The tokens and frames depend on ``seed`` alone, so the bf16
    and f32 runs see the same. Returns (max |diff| per position, clear
    positions, largest |logit|, the forward's f32 logits at positions p - 1
    on, the (token, layer) routing decisions that differ between the
    forward and the decode and their count, or None without experts)."""
    from repro_torch.models import encdec as ed
    from repro_torch.models import moe
    from repro_torch.models.layers import dtype_of

    b = LM_BATCH
    rng = np.random.default_rng([seed, 12])
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (b, p + LM_CHECK_STEPS)).astype(np.int32)).to(DEVICE)
    route, picks = moe.route, []

    def recording(cfg_, router, x, cap):
        r = route(cfg_, router, x, cap)
        if x.shape[1] != p:            # the forward's and the decode's
            picks.append(r["top_e"].sort(-1).values)
        return r

    moe.route = recording
    try:
        with torch.inference_mode():
            if cfg.family != "encdec":
                full, _, _ = model.forward(params, {"tokens": toks})
                last, caches = model.prefill(params, {"tokens": toks[:, :p]})
                caches = model.cache_from_prefill(caches, LM_CACHE)
            else:
                frames = torch.from_numpy(rng.standard_normal(
                    (b, cfg.enc_frames, cfg.d_model)).astype(np.float32)).to(
                        DEVICE, dtype_of(cfg))
                enc = ed.encode(cfg, params, frames)
                full, _ = ed.decode_fwd(cfg, params, toks, enc,
                                        want_cache=False)
                last, ((sk, sv), cross) = model.prefill(
                    params, {"tokens": toks[:, :p], "frames": frames})
                pad = [torch.zeros(sk.shape[:2] + (LM_CACHE,) + sk.shape[3:],
                                   dtype=sk.dtype, device=DEVICE)
                       for _ in range(2)]
                pad[0][:, :, :p], pad[1][:, :, :p] = sk, sv
                caches = (tuple(pad), cross)
            ref = full[:, p - 1:].float().clone()
            errs, clear, scale = decode_errors(
                torch, model, params, full, last, caches, toks, p,
                float("inf") if tol is None else tol, rtol, what)
    finally:
        moe.route = route
    flips = None
    if picks:
        nl = cfg.n_layers
        fwd, dec = picks[:nl], picks[nl:]
        flips = [0, 0]
        for i, step in enumerate(dec):
            want = fwd[i % nl][:, p + i // nl]
            flips[0] += int((step[:, 0] != want).any(-1).sum())
            flips[1] += want.shape[0]
    return errs, clear, scale, ref, flips


def ssm_layer_check(torch, params, cfg, p: int, seed: int):
    """mamba2's first SSD layer in the model's dtype: ``apply_ssm`` over
    the prompt, then LM_CHECK_STEPS ``apply_ssm_decode`` steps, against
    ``apply_ssm`` over the whole sequence on the same inputs (the embedded,
    normed tokens of ``family_check``), within LM_TOL + SSM_LAYER_RTOL
    |output| (a few bf16 roundings of outputs that reach ~20): (max |diff|
    per step, largest |output|)."""
    from repro_torch.models import layers as L
    from repro_torch.models import ssm

    rng = np.random.default_rng([seed, 12])
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (LM_BATCH, p + LM_CHECK_STEPS)).astype(np.int32)).to(
            DEVICE)
    lp = params["trunk"]["layers"][0]
    with torch.inference_mode():
        h = L.apply_norm(cfg, lp["norm1"],
                         L.embed_tokens(cfg, params["embed"], toks))
        y, _, _ = ssm.apply_ssm(cfg, lp["ssm"], h)
        _, state, conv = ssm.apply_ssm(cfg, lp["ssm"], h[:, :p])
        errs = []
        for t in range(p, p + LM_CHECK_STEPS):
            yt, state, conv = ssm.apply_ssm_decode(cfg, lp["ssm"],
                                                   h[:, t:t + 1], state, conv)
            want = y[:, t:t + 1]
            errs.append(float((yt - want).abs().max()))
            over = ((yt - want).abs() - SSM_LAYER_RTOL * want.abs()).max()
            if float(over) > LM_TOL:
                raise AssertionError(
                    f"mamba2's first SSD layer: decode differs from its "
                    f"chunked forward by {errs[-1]:.4f} at {t} (tolerance "
                    f"{LM_TOL} + {SSM_LAYER_RTOL} |output|)")
    return errs, float(y.abs().max())


def phase_lm_families(torch, rng, card, seed: int):
    """Phase 12: the MoE, SSM, RG-LRU and encoder-decoder families at their
    published widths (module docstring). Returns the launches counted
    inside their ``serve()`` calls, summed (``lm_family_launches``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.model import build_model
    from repro_torch.runtime.serve_loop import serve

    t_phase = time.perf_counter()
    total = {k: 0 for k in KERNEL_META}
    n = 1 << SERVER_SCALE
    s, _, load_s = loaded_server(rng)
    deg = np.flatnonzero(s.state.ecnt.cpu().numpy()[:n] > 0)
    log(f"LM families: one GraphCoServer(ingest, index) on Graph500 SCALE "
        f"{SERVER_SCALE} (loaded in {load_s:.1f} s) beside each serve()")
    b = LM_BATCH
    for arch, widths in FAMILY_WIDTHS.items():
        t_arch = time.perf_counter()
        sync(torch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        cfg = get_config(arch)
        got = {k: getattr(cfg, k) for k in widths}
        if got != widths:
            raise AssertionError(f"{arch} is not at its published width: "
                                 f"{got}")
        if LM_SMOKE:                      # a rehearsal on the CPU
            cfg = cfg.smoke()
        model = build_model(cfg)
        params = model.init(torch.Generator(DEVICE).manual_seed(seed))
        sync(torch)
        named = dict(params.named_parameters())
        w_bytes = sum(t.numel() * t.element_size() for t in named.values())
        x_bytes = sum(t.numel() * t.element_size() for k, t in named.items()
                      if k.rsplit(".", 2)[-2:-1] == ["moe"]
                      and not k.endswith("router"))
        log(f"LM {arch}: {', '.join(f'{k} {v}' for k, v in widths.items())}"
            f"; {sum(t.numel() for t in named.values()):,} params "
            f"(param_count() {cfg.param_count():,}), {w_bytes / 1e9:.3f} GB "
            f"({x_bytes / 1e9:.3f} GB of it experts), drawn on the card from "
            f"a seeded torch.Generator")

        # (a) decode against the full forward
        p = FAMILY_PROMPT[arch]
        tol = FAMILY_TOL.get(arch, LM_TOL)
        errs, clear, scale, ref, flips = family_check(
            torch, model, params, cfg, p, seed, tol)
        full = (f"decode_fwd of {p + LM_CHECK_STEPS} tokens over encode "
                f"of {cfg.enc_frames} random frames"
                if cfg.family == "encdec"
                else f"forward of {p + LM_CHECK_STEPS} tokens")
        log(f"LM {arch} (a): prefill of {b} x {p} tokens + {LM_CHECK_STEPS} "
            f"teacher-forced decode steps against one {full}: max |diff| "
            f"{max(errs):.5f} (prefill {errs[0]:.5f}; "
            + (f"tolerance {tol}" if tol is not None else
               "measured, not held: see FAMILY_TOL")
            + f", logits up to {scale:.3f}); argmax equal on all {clear} "
            f"positions whose top-2 margin exceeds {2 * (tol or 0)}; every "
            f"logit finite"
            + (f"; the router picked other experts in decode than in the "
               f"forward on {flips[0]} of {flips[1]} (token, layer) "
               f"decisions" if flips else ""))
        if cfg.family == "ssm":
            lerrs, lscale = ssm_layer_check(torch, params, cfg, p, seed)
            log(f"LM {arch} (a): the first SSD layer's decode against its "
                f"chunked forward on the same inputs: max |diff| "
                f"{max(lerrs):.5f} (tolerance {LM_TOL} + {SSM_LAYER_RTOL:.4f}"
                f" |output|, outputs up to "
                f"{lscale:.3f})")

        if arch in FAMILY_SERVED:
            # (b) greedy twice, the decode step beside its bound, serve()
            prompts = rng.integers(0, cfg.vocab, (b, p)).astype(np.int32)
            ptoks = torch.from_numpy(prompts).to(DEVICE)
            runs = [greedy(torch, model, params, ptoks, FAMILY_NEW)
                    for _ in range(2)]
            if not np.array_equal(runs[0][0], runs[1][0]):
                raise AssertionError(f"{arch}: greedy tokens differ between "
                                     f"two runs")
            steps = runs[0][2][1:] + runs[1][2][1:]   # the first warms up
            med = statistics.median(steps)
            p90 = float(np.percentile(steps, 90))
            c_bytes = cache_bytes(model, b, LM_CACHE)
            read = w_bytes + c_bytes
            routed = ""
            if x_bytes:
                per = routed_per_step(torch, model, params, ptoks,
                                      runs[0][0])
                e_bytes = x_bytes / (cfg.n_layers * cfg.n_experts)
                read = w_bytes - x_bytes + statistics.median(per) * e_bytes \
                    + c_bytes
                routed = (f", experts routed {statistics.median(per) / cfg.n_layers:.1f}"
                          f" a layer (median step; {min(per)}-{max(per)} in "
                          f"all) of {cfg.n_experts} at {e_bytes / 1e6:.2f} "
                          f"MB each")
            bound_ms = read / HBM_BYTES_PER_S * 1e3
            log(f"LM {arch} (b): prefill {runs[0][1]:.2f} / "
                f"{runs[1][1]:.2f} ms ({b} x {p}, cache {LM_CACHE}); decode "
                f"step median {med:.3f} ms, p90 {p90:.3f} ms over "
                f"{len(steps)} steps (B = {b}), {b / med * 1e3:.1f} "
                f"tokens/s; bound {bound_ms:.3f} ms ({read / 1e9:.3f} GB "
                f"read once at {HBM_BYTES_PER_S / 1e12:.2f} TB/s: weights "
                f"outside the experts {(w_bytes - x_bytes) / 1e9:.3f} GB"
                f"{routed}, caches / states {c_bytes / 1e9:.3f} GB), "
                f"measured / bound {med / bound_ms:.1f}x; greedy tokens "
                f"equal in both runs; {card}")

            issued: list = []
            clients, queries = lm_serve_traffic(rng, n, deg, issued)
            reset_counts()
            out, stats = serve(model, params, prompts,
                               max_new_tokens=FAMILY_NEW, cache_len=LM_CACHE,
                               graph=s, clients=clients, query_stream=queries)
            sync(torch)
            launches = counts()
            want = {"decode_steps": FAMILY_NEW,
                    "decode_tokens": b * FAMILY_NEW,
                    "getpath_calls": len(issued),
                    "graph_ops": FAMILY_NEW * LM_TENANTS * SERVE_LANES,
                    "ingest_batches": FAMILY_NEW * LM_TENANTS,
                    "recoveries": 0}
            got = {k: getattr(stats, k) for k in want}
            if got != want or stats.index_hits == 0:
                raise AssertionError(f"{arch} ServeStats: {got} != {want} "
                                     f"(index_hits {stats.index_hits})")
            if not np.array_equal(out, runs[0][0]):
                raise AssertionError(f"{arch}: serve() decoded other tokens "
                                     f"than the bare greedy loop")
            require_launched(launches, ("B1", "B2", "B4"),
                             f"inside {arch}'s serve()")
            for k, v in launches.items():
                total[k] += v
            pairs = list(zip(rng.choice(deg, QUERIES).tolist(),
                             rng.integers(0, n, QUERIES).tolist()))
            res = s.get_reach(pairs)
            reach = check_reach(s.state, pairs, res.found,
                                f"get_reach after {arch}'s serve()")
            log(f"LM {arch} (b): serve() of {b} x {p} prompts, {FAMILY_NEW} "
                f"new tokens, cache {LM_CACHE}: {stats.wall_s:.2f} s, "
                f"{stats.decode_tokens / stats.wall_s:.1f} tokens/s; "
                f"{stats.graph_ops} lanes from {LM_TENANTS} tenants in "
                f"{stats.ingest_fused_calls} fused applies "
                f"({stats.ingest_retries} retries), {stats.getpath_calls} "
                f"pairs queried ({stats.index_hits} from the index), "
                f"{stats.index_refreshes} index refreshes; tokens equal the "
                f"bare loop's; get_reach of {QUERIES} pairs after it equals "
                f"scipy ({reach} reachable); launches inside serve() "
                f"{launches}")
            # (d) the device's busy share of one decode step
            decode_profile(torch, model, params, ptoks,
                           f"lm_decode_step_{arch}")
        del params, model, named
        sync(torch)
        peak = torch.cuda.max_memory_allocated() - base_mem

        # (a) in f32: the same draws unrounded, the same tokens
        torch.cuda.empty_cache()
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        model = build_model(cfg32)
        params = model.init(torch.Generator(DEVICE).manual_seed(seed))
        ftol, frtol = FAMILY_F32_TOL.get(arch, (F32_TOL, F32_TOL))
        ferrs, fclear, _, fref, fflips = family_check(
            torch, model, params, cfg32, p, seed, ftol, frtol, "f32")
        own = float((ref - fref).abs().max())
        del params, model, ref, fref
        log(f"LM {arch} (a) in f32: max |diff| {max(ferrs):.6f} (tolerance "
            f"{ftol} + {frtol} |logit|; argmax equal on all {fclear} clear "
            f"positions)"
            + (f"; routing differs on {fflips[0]} of {fflips[1]} decisions"
               if fflips else "")
            + f"; the bf16 forward's own distance from the f32 forward at "
            f"the checked positions: max |diff| {own:.5f}")
        log(f"LM {arch}: peak device memory {peak / 1e9:.3f} GB above its "
            f"start (bf16), {(torch.cuda.max_memory_allocated() - base_mem) / 1e9:.3f}"
            f" GB with the f32 check; {time.perf_counter() - t_arch:.1f} s; "
            f"{card}")
    del s

    # (c) the entry point as a subprocess, at full width
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           FAMILY_CHILD, "--smoke" if LM_SMOKE else "--no-smoke", "--ingest",
           "--batch", str(b), "--prompt-len", str(LM_PROMPT), "--new",
           str(FAMILY_NEW), "--cache-len", str(LM_CACHE), "--device", DEVICE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=LM_CHILD_TIMEOUT_S,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    child_s = time.perf_counter() - t0
    check_launcher(proc, b * FAMILY_NEW, f"--arch {FAMILY_CHILD}")
    log(f"LM families (c): python -m repro_torch.launch.serve --arch "
        f"{FAMILY_CHILD} --no-smoke --ingest --batch {b} --prompt-len "
        f"{LM_PROMPT} --new {FAMILY_NEW} --cache-len {LM_CACHE}: rc 0 in "
        f"{child_s:.1f} s; " + " | ".join(proc.stdout.splitlines()))
    log(f"LM families: launches inside the three serve() calls {total}; "
        f"phase 12 {time.perf_counter() - t_phase:.1f} s; {card}")
    return total


# ----------------------------------------------------------------------------
# Phase 13: the LM training path at qwen2-1.5b's full width
# ----------------------------------------------------------------------------
def same_bits(torch, a, b) -> bool:
    return torch.equal(a.detach().contiguous().view(torch.uint8),
                       b.detach().contiguous().view(torch.uint8))


def train_bound(cfg, n_params: int, b: int, s: int):
    """(bound ms, flops, bytes) of one train step: the matmul work of a
    forward and a backward (6 N T over the params N and tokens T, plus the
    causal attention products, 6 B H S^2 hd a layer), at the bf16 peak,
    against the optimizer's traffic (params and grads in bf16 and the f32
    moments read, params and moments written) at HBM_BYTES_PER_S."""
    t = b * s
    flops = 6 * n_params * t + 6 * cfg.n_layers * b * cfg.n_heads * s * s \
        * cfg.hd
    nbytes = n_params * (2 + 2 + 8 + 2 + 8)
    ms = max(flops / BF16_PEAK_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    return ms, flops, nbytes


def resume_check(torch, cfg):
    """(c): a crash at step RESUME_CRASH and a resumed ``train()`` against
    an uninterrupted run, on the card at smoke width. Returns (max |param
    diff|, |loss diff|, bitwise)."""
    from repro_torch.checkpoint import checkpointer as ckpt_mod
    from repro_torch.data.pipeline import GraphPathData
    from repro_torch.models.model import build_model
    from repro_torch.runtime.train_loop import (SimulatedFailure,
                                                TrainLoopConfig, train)

    model = build_model(cfg)

    def run(name, **kw):
        params = model.init(torch.Generator(DEVICE).manual_seed(0))
        tl = TrainLoopConfig(total_steps=RESUME_STEPS,
                             checkpoint_every=RESUME_EVERY, log_every=1,
                             checkpoint_dir=str(TRAIN_DIR / name),
                             lr=RESUME_LR, **kw)
        return train(model, GraphPathData(n_vertices=8, seed=0,
                                          device=DEVICE),
                     batch_size=2, seq_len=96, cfg=tl, params=params,
                     log=lambda *_: None)

    whole, _, h0 = run(f"whole_{cfg.dtype}")
    try:
        run(f"crash_{cfg.dtype}", simulate_failure_at=RESUME_CRASH)
        raise AssertionError("simulate_failure_at did not raise")
    except SimulatedFailure:
        pass
    # the crashed run's last checkpoint writer is still running in this
    # process (a kill -9 would have ended it): let it publish, so that the
    # resume starts from its step and not, by a race, from scratch
    t0 = time.monotonic()
    while ckpt_mod._live_tmp and time.monotonic() - t0 < 60:
        time.sleep(0.01)
    resumed, _, h1 = run(f"crash_{cfg.dtype}")
    if [s for s, _, _ in h1] != list(range(RESUME_CRASH, RESUME_STEPS + 1)):
        raise AssertionError(f"resumed at the wrong step: {h1}")
    dp = max(float((a.detach().float() - b.detach().float()).abs().max())
             for a, b in zip(whole.parameters(), resumed.parameters(),
                             strict=True))
    dl = abs(h0[-1][1] - h1[-1][1])
    bitwise = all(same_bits(torch, a, b) for a, b in
                  zip(whole.parameters(), resumed.parameters(), strict=True))
    ptol, ltol = RESUME_TOL[cfg.dtype]
    if not (np.isfinite([l for _, l, _ in h0 + h1]).all() and dp <= ptol
            and dl <= ltol):
        raise AssertionError(f"{cfg.dtype} resume: params {dp} (tol {ptol}), "
                             f"loss {dl} (tol {ltol})")
    return dp, dl, bitwise


def kind_step_check(torch, arch, rng, seed: int):
    """(d): one ``make_train_step`` step of ``arch``'s smoke config (f32) on
    the card against the same step on the CPU, from the same params and
    tokens. Returns (loss rel diff, worst first-moment error / leaf max,
    params off by more than 1e-5, params checked)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
    from repro_torch.launch import steps
    from repro_torch.models.model import build_model

    cfg = get_config(arch).smoke()
    model = build_model(cfg)
    host = model.init(torch.Generator("cpu").manual_seed(seed))
    card = lm_params_from_numpy(cfg, lm_params_to_numpy(cfg, host),
                                device=DEVICE)
    toks = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    out = {}
    for where, params in (("cpu", host), (DEVICE, card)):
        step = steps.make_train_step(model, lr=RESUME_LR, remat=True)
        p, st, m = step(params, steps.init_opt_state(params),
                        {"tokens": torch.from_numpy(toks).to(where)})
        out[where] = (float(m["loss"]), dict(p.named_parameters()), st.mu)
    (lh, ph, mh), (lc, pc, mc) = out["cpu"], out[DEVICE]
    dl = abs(lc - lh) / abs(lh)
    gerr, off, total = 0.0, 0, 0
    for name, m in mh.items():
        scale = max(float(m.abs().max()), 1e-30)
        gerr = max(gerr, float((mc[name].cpu() - m).abs().max()) / scale)
        d = (pc[name].detach().cpu().float() - ph[name].detach().float()).abs()
        loose = m.abs() <= TRAIN_KIND_GTOL * scale
        bad = d > torch.where(loose, 2.2 * RESUME_LR, 1e-5)
        if bad.any():
            raise AssertionError(f"{arch} step: {int(bad.sum())} params of "
                                 f"{name} off by up to {float(d.max())}")
        off += int((d > 1e-5).sum())
        total += d.numel()
    if dl > TRAIN_KIND_RTOL or gerr > TRAIN_KIND_GTOL:
        raise AssertionError(f"{arch} step on the card against the CPU: "
                             f"loss {dl}, gradients {gerr}")
    return dl, gerr, off, total


def phase_train(torch, rng, card, seed: int):
    """Phase 13: the LM training path at qwen2-1.5b's full width (module
    docstring). Returns the launches counted inside ``train()``
    (``lm_train_launches``)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.convert import from_jax_tree
    from repro_torch.data.pipeline import GraphPathData
    from repro_torch.launch import steps
    from repro_torch.models.model import build_model
    from repro_torch.runtime.train_loop import (TrainLoopConfig, meta_stack,
                                                train, train_tree)

    t_phase = time.perf_counter()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    TRAIN_DIR.mkdir(parents=True)
    free = shutil.disk_usage(TRAIN_DIR).free
    if free < TRAIN_NEED_BYTES:
        raise AssertionError(
            f"phase 13 needs {TRAIN_NEED_BYTES / 1e9:.1f} GB free under "
            f"{TRAIN_DIR}, the disk has {free / 1e9:.1f} GB")
    fs = fs_of(TRAIN_DIR)
    sync(torch)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    cfg = get_config(LM_ARCH)
    shape = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
             cfg.d_ff, cfg.vocab, cfg.dtype, cfg.tie_embeddings)
    if LM_SMOKE:                      # a rehearsal on the CPU
        cfg = cfg.smoke()
    elif shape != (28, 1536, 12, 2, 128, 8960, 151936, "bfloat16", True):
        raise AssertionError(f"{LM_ARCH} is not at its published width: "
                             f"{shape}")
    model = build_model(cfg)
    params = model.init(torch.Generator(DEVICE).manual_seed(seed))
    n_params = sum(p.numel() for p in params.parameters())
    b, s = TRAIN_BATCH, TRAIN_SEQ

    # (a) train() on GraphPathData, a checkpoint at the last step only
    data = GraphPathData(seed=0, device=DEVICE)
    data_ms = []

    class TimedData:
        def batch(self, step, bs, sl):
            sync(torch)
            t0 = time.perf_counter()
            out = data.batch(step, bs, sl)
            sync(torch)
            data_ms.append((time.perf_counter() - t0) * 1e3)
            return out

    marks = []

    def mark(line):
        marks.append((time.perf_counter(), line))

    ckpt_dir = TRAIN_DIR / "full"
    tl = TrainLoopConfig(total_steps=TRAIN_STEPS,
                         checkpoint_every=TRAIN_STEPS, log_every=1,
                         checkpoint_dir=str(ckpt_dir), lr=TRAIN_LR)
    reset_counts()
    t0 = time.perf_counter()
    params, opt_state, hist = train(model, TimedData(), batch_size=b,
                                    seq_len=s, cfg=tl, params=params,
                                    log=mark)
    sync(torch)
    t_end = time.perf_counter()
    launches = counts()
    losses = [l for _, l, _ in hist]
    if len(hist) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"train(): {hist}")
    walls = [(marks[i][0] - marks[i - 1][0]) * 1e3
             for i in range(1, len(marks))]
    first_ms = (marks[0][0] - t0) * 1e3
    med, p90 = statistics.median(walls), float(np.percentile(walls, 90))
    save_s = t_end - marks[-1][0]
    ck_bytes = dir_bytes(ckpt_dir)
    bound_ms, flops, opt_bytes = train_bound(cfg, n_params, b, s)
    peak = torch.cuda.max_memory_allocated() - base_mem
    log(f"LM train (a): {LM_ARCH} ({n_params:,} params, {cfg.dtype}) through "
        f"train() on GraphPathData(seed=0) on the card, B {b} x S {s}, "
        f"{TRAIN_STEPS} steps, remat, lr {TRAIN_LR}: losses "
        + ", ".join(f"{l:.4f}" for l in losses)
        + f"; first step {first_ms:.1f} ms; step wall median {med:.3f} ms, "
        f"p90 {p90:.3f} ms over steps 2-{TRAIN_STEPS} ("
        + ", ".join(f"{w:.1f}" for w in walls) + "); "
        f"{b * s / med * 1e3:.1f} tokens/s; bound {bound_ms:.3f} ms ("
        f"{flops / 1e12:.2f} TFLOP at {BF16_PEAK_OPS_PER_S / 1e12:.0f} "
        f"TFLOP/s, {opt_bytes / 1e9:.2f} GB of optimizer traffic at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s), measured / bound "
        f"{med / bound_ms:.1f}x; batch generation "
        + ", ".join(f"{x:.1f}" for x in data_ms) + " ms; launches inside "
        f"train() {launches}; peak device memory {peak / 1e9:.3f} GB above "
        f"the phase's start; {card}")
    log(f"LM train (a): checkpoint at step {TRAIN_STEPS}: {ck_bytes / 1e9:.3f} "
        f"GB in {save_s:.2f} s ({ck_bytes / 1e6 / save_s:.0f} MB/s: stack, "
        f"copy to the host, write and fsync every leaf); {fs}")
    # the corpus's graphs hold 24 live vertices in 64 slots: the direction
    # test picks pull (B2) at a GetPath's first superstep (1 x alpha = 32
    # >= the unvisited) and keeps it while the frontier holds 64 / beta =
    # 1 vertex, as JAX's does, so B3 (push) is not on this path
    require_launched(launches, ("B2",), "inside train()")

    # (b) the full-width checkpoint restores bit for bit
    sync(torch)
    t0 = time.perf_counter()
    (tp, ts), manifest = Checkpointer(str(ckpt_dir)).restore(
        train_tree(cfg, params, opt_state, stack=meta_stack),
        device=DEVICE)
    sync(torch)
    restore_s = time.perf_counter() - t0
    named = dict(params.named_parameters())
    n_leaves = 0
    for dst, tree in ((named, tp), (opt_state.mu, ts.mu),
                      (opt_state.nu, ts.nu)):
        for name, t in from_jax_tree(cfg, params, tree).items():
            n_leaves += 1
            if not same_bits(torch, t, dst[name]):
                raise AssertionError(f"restored {name} differs")
    if int(ts.step) != TRAIN_STEPS or manifest["step"] != TRAIN_STEPS:
        raise AssertionError(f"restored step {int(ts.step)}")
    del tp, ts
    log(f"LM train (b): Checkpointer.restore of the step-{TRAIN_STEPS} "
        f"directory ({manifest['n_leaves']} leaves in JAX's layout, "
        f"{ck_bytes / 1e9:.3f} GB) in {restore_s:.2f} s "
        f"({ck_bytes / 1e6 / restore_s:.0f} MB/s, read and copied to the "
        f"card): all {n_leaves} of the port's leaves and the step equal the "
        f"state in memory bit for bit; {fs}")

    # the device idle share of one train step (batch, step, loss read)
    step_fn = steps.make_train_step(model, lr=TRAIN_LR, remat=True)
    state = [opt_state]

    def one_step():
        toks = data.batch(TRAIN_STEPS, b, s)
        _, state[0], m = step_fn(params, state[0],
                                 {"tokens": torch.from_numpy(toks).to(
                                     DEVICE)})
        float(m["loss"])

    wall, trace_file = profiled(torch, one_step, "chip_smoke_lm_train_step")
    busy, per_name = _busy_ms(trace_file)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"profile lm_train_step: wall {wall:.3f} ms under the profiler, "
        "device " + (f"busy {busy:.3f} ms (idle "
                     f"{100 * (1 - busy / wall):.1f}%); "
                     + "; ".join(f"{k} {v:.3f} ms" for k, v in top)
                     if per_name else "busy not measured (no device "
                     "events)"))
    del params, opt_state, state, named
    torch.cuda.empty_cache()      # the checkpoint stays for phase 14

    # (c) crash and resume at smoke width, f32 and bf16
    for dtype in ("float32", "bfloat16"):
        scfg = dataclasses.replace(get_config(LM_ARCH).smoke(), dtype=dtype)
        dp, dl, bitwise = resume_check(torch, scfg)
        ptol, ltol = RESUME_TOL[dtype]
        log(f"LM train (c): {LM_ARCH} smoke {dtype}: a SimulatedFailure at "
            f"step {RESUME_CRASH} of {RESUME_STEPS} (checkpoints every "
            f"{RESUME_EVERY}), a second train() resumed from step "
            f"{RESUME_CRASH - 1}: final params within {dp:.3g} (tol {ptol}) "
            f"and loss within {dl:.3g} (tol {ltol}) of an uninterrupted run; "
            f"bit for bit: {bitwise}")

    # (d) a train step of each other trainable trunk kind, card against CPU
    for kind, arch in TRAIN_KINDS.items():
        dl, gerr, off, total = kind_step_check(torch, arch, rng, seed)
        log(f"LM train (d): {kind} ({arch} smoke, f32) make_train_step on the "
            f"card against the CPU: loss rel diff {dl:.3g} (tol "
            f"{TRAIN_KIND_RTOL}), first moments within {gerr:.3g} of each "
            f"leaf's max (tol {TRAIN_KIND_GTOL}); {off} of {total} params "
            f"off by more than 1e-5, each where the gradient is within "
            f"{TRAIN_KIND_GTOL} of 0")

    # (e) the entry point as a subprocess
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           LM_ARCH, "--smoke", "--data", "graph", "--steps",
           str(TRAIN_CHILD_STEPS), "--device", DEVICE, "--ckpt-dir",
           str(TRAIN_DIR / "child")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=LM_CHILD_TIMEOUT_S,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    child_s = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or not lines or not lines[-1].startswith(
            "done; final loss "):
        raise AssertionError(f"repro_torch.launch.train: rc "
                             f"{proc.returncode}; {proc.stdout[-2000:]} "
                             f"{proc.stderr[-2000:]}")
    log(f"LM train (e): python -m repro_torch.launch.train --arch {LM_ARCH} "
        f"--smoke --data graph --steps {TRAIN_CHILD_STEPS}: rc 0 in "
        f"{child_s:.1f} s; {lines[-1]}")
    shutil.rmtree(TRAIN_DIR / "child")
    log(f"LM train: phase 13 {time.perf_counter() - t_phase:.1f} s; {card}")
    return launches


def restored_bits(torch, tree, step_dir: Path) -> int:
    """Every restored leaf's local tensor against its file, bit for bit
    (bf16 through its raw bits). Returns the leaf count."""
    from torch.utils import _pytree as pytree

    leaves = pytree.tree_leaves(tree)
    for i, t in enumerate(leaves):
        arr = np.load(step_dir / f"leaf_{i:06d}.npy")
        local = t.to_local() if hasattr(t, "to_local") else t
        raw = local.detach().reshape(-1).view(torch.uint8).cpu().numpy()
        if raw.tobytes() != np.ascontiguousarray(arr).tobytes():
            raise AssertionError(f"restored leaf {i} differs from its file")
    return len(leaves)


EXAMPLE_WRAP = """
import json, runpy, sys
path, args = sys.argv[1], sys.argv[2:]
sys.argv = [path] + args
runpy.run_path(path, run_name="__main__")
from repro_torch.kernels.bfs_multi_step import ops as b1
from repro_torch.kernels.bfs_pull_step import ops as b2
from repro_torch.kernels.bfs_step import ops as b3
from repro_torch.kernels.label_join import ops as lj
print("LAUNCHES " + json.dumps({"B1": b1.launches, "B2": b2.launches,
      "B3": b3.launches, "B4": lj.slot_launches}), file=sys.stderr)
"""


def example_answers(out: str) -> list:
    """An example's answer lines: timings and the device count dropped,
    the decode line cut to its token count."""
    lines = []
    for line in out.splitlines():
        if line.startswith("devices:"):
            continue
        lines.append(line.split(" in ")[0] if line.startswith("decoded ")
                     else line)
    return lines


def mesh_run(torch, model, mesh, root: Path, steps_n: int, seed: int):
    """One ``train()`` resumed from the step in ``root`` to ``steps_n``,
    on ``mesh`` or (None) without one; its own last step is removed after
    it. Returns (params, opt_state, losses, step walls, launches, peak
    memory above what was held before its params were made, wall s)."""
    from repro_torch.data.pipeline import GraphPathData
    from repro_torch.runtime.train_loop import (TrainLoopConfig, train,
                                                train_shardings)

    sync(torch)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    params = model.init(torch.Generator(DEVICE).manual_seed(seed))
    kw = ({} if mesh is None else
          {"mesh": mesh, "shardings": train_shardings(model.cfg, params,
                                                      mesh)})
    tl = TrainLoopConfig(total_steps=steps_n, checkpoint_every=steps_n,
                         log_every=1, checkpoint_dir=str(root), lr=TRAIN_LR)
    marks = []
    sync(torch)
    reset_counts()
    t0 = time.perf_counter()
    p, o, hist = train(model, GraphPathData(seed=0, device=DEVICE),
                       batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, cfg=tl,
                       params=params, log=lambda line: marks.append(
                           (time.perf_counter(), line)), **kw)
    sync(torch)
    wall = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated() - base_mem
    shutil.rmtree(root / f"step_{steps_n:09d}")
    at = [t for t, line in marks if line.startswith("[train] step")]
    walls = [(b - a) * 1e3 for a, b in zip(at, at[1:])]
    return p, o, [l for _, l, _ in hist], walls, launches, peak, wall


def mesh_train(torch, card, seed: int, total: dict):
    """Phase 14 (a): ``restore(shardings=)`` onto the (1, 1) mesh, then
    ``train(mesh=)`` against ``train()`` from phase 13's checkpoint."""
    import torch.distributed as dist

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import GraphPathData
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import build_model
    from repro_torch.parallel import sharding as sh
    from repro_torch.runtime.train_loop import (distribute_params,
                                                meta_stack, train_shardings,
                                                train_tree,
                                                train_tree_shardings)

    src = sorted((TRAIN_DIR / "full").glob("step_*"))[-1]
    start = int(src.name.split("_")[1])
    free = shutil.disk_usage(TRAIN_DIR).free
    ck_bytes = dir_bytes(src)
    if free < ck_bytes * 1.05:
        raise AssertionError(
            f"phase 14 writes {ck_bytes / 1e9:.1f} GB checkpoints one at a "
            f"time under {TRAIN_DIR}; the disk has {free / 1e9:.1f} GB free")
    cfg = get_config(LM_ARCH)
    if LM_SMOKE:
        cfg = cfg.smoke()
    model = build_model(cfg)
    mesh = make_host_mesh(device_type=DEVICE)
    steps_n = start + MESH_STEPS
    try:
        # restore(shardings=) alone: every leaf's local tensor is the file
        params = model.init(torch.Generator(DEVICE).manual_seed(seed))
        n_params = sum(p.numel() for p in params.parameters())
        shardings = train_shardings(cfg, params, mesh)
        distribute_params(params, shardings[0])
        opt = steps_mod.init_opt_state(params)
        t0 = time.perf_counter()
        tree, _ = Checkpointer(str(src.parent)).restore(
            train_tree(cfg, params, opt, stack=meta_stack),
            shardings=train_tree_shardings(cfg, params, shardings),
            device=DEVICE)
        sync(torch)
        restore_s = time.perf_counter() - t0
        n_dt = sum(1 for t in torch.utils._pytree.tree_leaves(tree)
                   if hasattr(t, "device_mesh"))
        n_leaves = restored_bits(torch, tree, src)
        del tree, opt, params
        log(f"LM mesh (a): Checkpointer.restore(shardings=) of phase 13's "
            f"step-{start} directory ({ck_bytes / 1e9:.3f} GB) onto the "
            f"(1, 1) mesh {tuple(mesh.mesh_dim_names)} in {restore_s:.2f} "
            f"s: {n_dt} of {n_leaves} leaves DTensors on their placements, "
            f"every local tensor equal to its file bit for bit")

        pm, om, lm, wm, nm, km, sm = mesh_run(torch, model, mesh, src.parent,
                                              steps_n, seed)
        require_launched(nm, ("B2",), "inside train(mesh=)")
        for k in total:
            total[k] += nm[k]
        if not all(hasattr(q, "device_mesh") for q in pm.parameters()):
            raise AssertionError("train(mesh=) left a plain param")
        placed = sorted({tuple(str(x) for x in q.placements)
                         for q in pm.parameters()})
        pp, op, lp, wp, npl, kp, sp = mesh_run(torch, model, None,
                                               src.parent, steps_n, seed)
        del op
        diffs = [(n, float((a.to_local().float() - b.float()).abs().max()))
                 for (n, a), b in zip(pm.named_parameters(), pp.parameters(),
                                      strict=True)
                 if not same_bits(torch, a.to_local(), b)]
        del pp
        rel = max(abs(x - y) / abs(y) for x, y in zip(lm, lp))
        if len(lm) != MESH_STEPS or not np.isfinite(lm).all():
            raise AssertionError(f"train(mesh=): {lm}")
        if lm != lp or diffs:
            log(f"LM mesh (a): meshed and plain differ: losses {lm} vs {lp} "
                f"(max rel {rel:.3g}); params {diffs[:8]}")
            if rel > MESH_LOSS_RTOL:
                raise AssertionError(f"meshed loss off by {rel:.3g}")

        # the device idle share of one more meshed step (its batch, the
        # step with pinned gradients, the loss read), after the check
        step_fn = steps_mod.make_train_step(
            model, lr=TRAIN_LR, remat=True,
            grad_specs=train_shardings(cfg, pm, mesh)[0])
        state = [om]
        bspec = sh.to_named(sh.batch_spec(
            mesh, "tokens", (TRAIN_BATCH, TRAIN_SEQ)), mesh)
        data = GraphPathData(seed=0, device=DEVICE)

        def one_step():
            toks = torch.from_numpy(data.batch(steps_n, TRAIN_BATCH,
                                               TRAIN_SEQ))
            sh.set_activation_mesh(mesh)
            try:
                _, state[0], m = step_fn(pm, state[0], {
                    "tokens": sh.distribute(toks, bspec)})
            finally:
                sh.set_activation_mesh(None)
            float(m["loss"].full_tensor())

        pwall, trace_file = profiled(torch, one_step,
                                     "chip_smoke_mesh_train_step")
        busy, per_name = _busy_ms(trace_file)
        del state, om, pm
        torch.cuda.empty_cache()
    finally:
        sh.set_activation_mesh(None)
        dist.destroy_process_group()
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    med_m, med_p = statistics.median(wm), statistics.median(wp)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    same = "equal bit for bit" if (lm == lp and not diffs) else (
        f"losses max rel {rel:.3g}, {len(diffs)} param leaves differ")
    log(f"LM mesh (a): {LM_ARCH} ({n_params:,} params, {cfg.dtype}) "
        f"train(mesh=make_host_mesh(), shardings=train_shardings(...)) "
        f"resumed at step {start} from phase 13's checkpoint, {MESH_STEPS} "
        f"steps on GraphPathData(seed=0) on the card, B {TRAIN_BATCH} x S "
        f"{TRAIN_SEQ}, make_train_step(grad_specs=): losses "
        + ", ".join(f"{x:.6f}" for x in lm) + "; without a mesh "
        + ", ".join(f"{x:.6f}" for x in lp) + f"; losses and params {same}; "
        f"param placements {placed}; step wall median {med_m:.3f} ms "
        f"meshed (" + ", ".join(f"{w:.1f}" for w in wm) + f") against "
        f"{med_p:.3f} ms plain (" + ", ".join(f"{w:.1f}" for w in wp)
        + f"); {tokens / med_m * 1e3:.1f} / {tokens / med_p * 1e3:.1f} "
        f"tokens/s; train() wall (restore, steps, save) {sm:.1f} / "
        f"{sp:.1f} s; peak device memory {km / 1e9:.3f} / {kp / 1e9:.3f} GB "
        f"above each run's start; launches inside train(mesh=) {nm}, "
        f"without {npl}; {card}")
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:4]
    log(f"profile mesh_train_step: wall {pwall:.3f} ms under the profiler, "
        "device " + (f"busy {busy:.3f} ms (idle "
                     f"{100 * (1 - busy / pwall):.1f}%); "
                     + "; ".join(f"{k} {v:.3f} ms" for k, v in top)
                     if per_name else "busy not measured (no device "
                     "events)"))


def mesh_examples(env: dict, children: list, total: dict):
    """Phase 14 (b): the three examples as children on the card and with
    ``--device cpu``; the same answers, B2 in the card children."""
    procs = {}
    t0 = time.perf_counter()
    for name in MESH_EXAMPLES:
        for dev in (DEVICE, "cpu"):
            procs[name, dev] = subprocess.Popen(
                [sys.executable, "-c", EXAMPLE_WRAP,
                 str(ROOT / "examples" / f"{name}_torch.py"), "--device",
                 dev], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, start_new_session=True)
            children.append(procs[name, dev])
    outs, launches = {}, {k: 0 for k in total}
    for key, proc in procs.items():
        out, err = proc.communicate(timeout=MESH_CHILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise AssertionError(f"example {key}: rc {proc.returncode}; "
                                 f"{out[-1500:]} {err[-2500:]}")
        outs[key] = out
        if key[1] != "cpu":
            got = json.loads(err.split("LAUNCHES ")[-1].splitlines()[0])
            for k, v in got.items():
                launches[k] += v
    wall = time.perf_counter() - t0
    for name in MESH_EXAMPLES:
        a, b = (example_answers(outs[name, d]) for d in (DEVICE, "cpu"))
        if a != b:
            raise AssertionError(f"example {name}: card {a} != cpu {b}")
        log(f"LM mesh (b): examples/{name}_torch.py on the card and with "
            f"--device cpu: rc 0, the same {len(a)} answer lines: "
            + " | ".join(a))
    require_launched(launches, ("B2",), "in the examples on the card")
    for k, v in launches.items():
        total[k] += v
    log(f"LM mesh (b): six children in {wall:.1f} s; launches in the card "
        f"children {launches}")


def mesh_harness(seed: int, total: dict):
    """Phase 14 (c): ``run_and_check`` of drawn schedules on a pool on the
    card, and ``shrink_schedule`` on a deliberately broken check."""
    import random

    from repro_torch.testing import proptest, schedules

    t0 = time.perf_counter()
    draw_rng = random.Random(seed ^ 0xC0FFEE)
    strat = schedules.batch_lists_strategy(proptest.strategies)
    reset_counts()
    n_reads = n_ops = 0
    for _ in range(MESH_SCHEDULES):
        op_lists = strat.draw(draw_rng)
        trace = schedules.run_and_check(
            schedules.schedule_from_batches(op_lists),
            capacity=MESH_POOL_CAPACITY, device=DEVICE)
        n_reads += len(trace.reads)
        n_ops += sum(len(b) for b in op_lists)
    launches = counts()
    for k, v in launches.items():
        total[k] += v
    wall = time.perf_counter() - t0

    def fails(schedule):      # broken on purpose: fails while key 2 lives
        head = schedules.run_schedule(schedule, capacity=MESH_POOL_CAPACITY,
                                      device=DEVICE).pool._head
        return bool(((head.vkey == 2) & head.valive).any())

    big = None
    while big is None:
        cand = schedules.schedule_from_batches(strat.draw(draw_rng))
        if len(cand.steps) >= 6 and fails(cand):
            big = cand
    small = schedules.shrink_schedule(big, fails)
    if not (len(small.steps) < len(big.steps) and fails(small)):
        raise AssertionError(f"shrink_schedule: {big.pretty()} -> "
                             f"{small.pretty()}")
    log(f"LM mesh (c): run_and_check on {MESH_SCHEDULES} schedules drawn by "
        f"batch_lists_strategy (seed {seed} ^ 0xC0FFEE; {n_ops} ops, "
        f"{n_reads} reads) on an IngestPool of capacity "
        f"{MESH_POOL_CAPACITY} on the card (hybrid_cuda): every trace "
        f"linearizable, in {wall:.1f} s; launches {launches}; a check that "
        f"fails while key 2 lives shrinks {len(big.steps)} steps to "
        f"{len(small.steps)}: " + " / ".join(
            line.strip() for line in small.pretty().splitlines()))


def mesh_dry_run(dry, dry_out: Path, t_dry: float):
    """Phase 14 (d): the dry run's records, every one ok."""
    _, err = dry.communicate(timeout=max(
        1.0, MESH_DRY_TIMEOUT_S - (time.perf_counter() - t_dry)))
    if dry.returncode != 0:
        raise AssertionError(f"dry run: rc {dry.returncode}; {err[-2000:]}")
    recs = [json.loads(line) for line in dry_out.read_text().splitlines()]
    if len(recs) != len(MESH_DRY_CELLS):
        raise AssertionError(f"dry run: {len(recs)} records")
    for rec in recs:
        if not rec["ok"]:
            raise AssertionError(f"dry run {rec['arch']} {rec['shape']}: "
                                 f"{rec.get('error')}")
        m, c, co = rec["memory"], rec["cost"], rec["collectives"]
        log(f"LM mesh (d): dry run {rec['arch']} {rec['shape']} on the "
            f"{rec['mesh']} mesh ({rec['devices']} fake ranks, no device): "
            f"per device argument {m['argument_bytes'] / 1e9:.3f} GB, temp "
            f"{m['temp_bytes'] / 1e9:.3f} GB, output "
            f"{m['output_bytes'] / 1e9:.3f} GB; {c['flops'] / 1e12:.3f} "
            f"TFLOP (matmul class); collectives "
            + ", ".join(f"{k} {co[k] / 1e9:.3f} GB" for k in
                        ("all-gather", "all-reduce", "reduce-scatter",
                         "all-to-all"))
            + f" in {co['count']} ops; traced in {rec['trace_s']} s")
    log(f"LM mesh (d): {len(recs)} cells in "
        f"{time.perf_counter() - t_dry:.1f} s (children, beside (a)-(c))")


def phase_mesh(torch, card, seed: int):
    """Phase 14: the LM mesh on DTensor (module docstring). Returns the
    launches counted on its path (``mesh_launches``): inside the meshed
    ``train()``, the harness's pool and the examples run on the card."""
    t_phase = time.perf_counter()
    total = {k: 0 for k in KERNEL_META}
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    # (d) first, in the background: the dry run needs no card (its child
    # sees none) and runs on the host while (a)-(c) use the card
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    dry_out = MESH_DIR / "dryrun.jsonl"
    t_dry = time.perf_counter()
    dry = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--cells",
         ",".join(MESH_DRY_CELLS), "--mesh", "single", "--subprocess",
         "--out", str(dry_out)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True,
        env={**env, "CUDA_VISIBLE_DEVICES": ""})
    children = [dry]
    try:
        mesh_train(torch, card, seed, total)
        mesh_examples(env, children, total)
        mesh_harness(seed, total)
        mesh_dry_run(dry, dry_out, t_dry)
    finally:
        for proc in children:      # none outlives the phase
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    log(f"LM mesh: phase 14 {time.perf_counter() - t_phase:.1f} s; {card}")
    return total


PROFILE_MARK = "measured"
PROFILE_SETTLE_S = 0.005


def profiled(torch, fn, name: str, prep=None):
    """Trace one call of ``fn`` under torch.profiler, after a warm-up call:
    (wall ms of the traced call, the Chrome trace written to
    build/chip_smoke_traces/``name``.json). A trace can lose the kernel
    records of its first milliseconds, so it opens with ``fn`` called
    until PROFILE_SETTLE_S have passed, and the traced call runs inside a
    ``record_function`` span that ``device_events`` reads from. ``prep``,
    where given, runs before every call of ``fn``, outside that span."""
    from torch.profiler import ProfilerActivity, profile, record_function

    prep = prep or (lambda: None)
    prep()
    fn()
    sync(torch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < PROFILE_SETTLE_S:
            prep()
            fn()
            sync(torch)
        prep()
        sync(torch)
        with record_function(PROFILE_MARK):
            t0 = time.perf_counter()
            fn()
            sync(torch)
            wall = (time.perf_counter() - t0) * 1e3
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / f"{name}.json"
    prof.export_chrome_trace(str(path))
    return wall, path


def device_events(trace_file: Path) -> list:
    """The kernel / memcpy / memset events of a ``profiled`` trace that
    start after its traced span opens on the device's timeline (its host
    span can start hundreds of microseconds later), in time order; [] when
    the trace holds no device side of the span."""
    trace = json.loads(trace_file.read_text())["traceEvents"]
    marks = [e["ts"] for e in trace if e.get("name") == PROFILE_MARK
             and e.get("cat") == "gpu_user_annotation"]
    if not marks:
        return []
    return sorted((e for e in trace if e.get("ph") == "X" and e.get("cat")
                   in ("kernel", "gpu_memcpy", "gpu_memset")
                   and e["ts"] >= min(marks)), key=lambda e: e["ts"])


def _busy_ms(trace_file: Path):
    """(device busy ms, {kernel name: ms}) of a ``profiled`` trace's traced
    call: the union of its kernel / memcpy / memset intervals."""
    spans, per_name = [], {}
    for e in device_events(trace_file):
        spans.append((e["ts"], e["ts"] + e["dur"]))
        name = re.sub(r"^void |\(anonymous namespace\)::", "", e["name"])
        name = re.split(r"[(<]", name)[0][:40].strip()
        per_name[name] = per_name.get(name, 0.0) + e["dur"] / 1e3
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, per_name


def main_path_work(st, pairs, batch):
    """One batch, one session and one single session on ``st``, and one
    session on the dense engine."""
    from repro_torch.core import (apply_ops_fast, get_path_session,
                                  get_paths_session)

    return {
        "apply_ops_fast": lambda: apply_ops_fast(st, batch),
        "get_paths_session": lambda: get_paths_session(lambda: st, pairs),
        "get_path_session": lambda: get_path_session(lambda: st, *pairs[0]),
        "get_paths_session_dense": lambda: get_paths_session(
            lambda: st, pairs, backend="dense_cuda"),
    }


def index_work(index, st, pairs):
    """One index build and one fresh index-served session on ``st``."""
    from repro_torch.index import build_index, reach_session

    return {
        "build_index": lambda: build_index(st,
                                           landmark_slots=index.landmarks),
        "reach_session": lambda: reach_session(lambda: st, index, pairs),
    }


def phase_profile(torch, work):
    """Device busy share of one call of each function in ``work`` (name ->
    function), traced by ``profiled``."""
    for name, fn in work.items():
        wall, trace_file = profiled(torch, fn, f"chip_smoke_{name}")
        busy, per_name = _busy_ms(trace_file)
        if not per_name:
            log(f"profile {name}: wall {wall:.3f} ms; device busy not "
                f"measured (no device events in the trace)")
            continue
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:4]
        log(f"profile {name}: wall {wall:.3f} ms under the profiler, device "
            f"busy {busy:.3f} ms (idle {100 * (1 - busy / wall):.1f}%); "
            + "; ".join(f"{k} {v:.3f} ms" for k, v in top))


NO_PARENT_CALL = "no one PyTorch call computes reach + min parent"
KERNEL_META = {  # name, package, wrapper that launches, plain version,
    #               TPU kernel, why no one PyTorch call is timed beside it
    "B1": ("multi_bfs_step_packed", "bfs_multi_step",
           "multi_bfs_step_packed_kernel", "multi_bfs_step_packed_ref",
           "src/repro/kernels/bfs_multi_step/kernel.py:232", NO_PARENT_CALL),
    "B2": ("bfs_pull_step", "bfs_pull_step", "bfs_pull_step_rows",
           "bfs_pull_step_ref",
           "src/repro/kernels/bfs_pull_step/kernel.py:139", NO_PARENT_CALL),
    "B3": ("bfs_step_packed", "bfs_step", "bfs_step_packed_kernel",
           "bfs_step_packed_ref", "src/repro/kernels/bfs_step/kernel.py:165",
           NO_PARENT_CALL),
    "B4": ("label_join_packed", "label_join", "label_join_slots",
           "label_join_slots_ref",
           "src/repro/kernels/label_join/kernel.py:150",
           "no one PyTorch call gives hits and hub together, and torch has "
           "no popcount"),
    "B5": ("edge_update_packed", "edge_update", "_launch_packed",
           "edge_update_packed_ref",
           "src/repro/kernels/edge_update/kernel.py:137",
           "index_put_ leaves the order of duplicate targets undefined (the "
           "last lane must win), and torch has no bit set/clear"),
    "B6": ("multi_bfs_step", "bfs_multi_step", "multi_bfs_step",
           "multi_bfs_step_ref",
           "src/repro/kernels/bfs_multi_step/kernel.py:130",
           "_int_mm / matmul give the reach but no parent"),
    "B7": ("bfs_step", "bfs_step", "bfs_step", "bfs_step_ref",
           "src/repro/kernels/bfs_step/kernel.py:84",
           "a matrix-vector product gives the reach but no parent"),
    "B8": ("label_join", "label_join", "label_join", "label_join_ref",
           "src/repro/kernels/label_join/kernel.py:80",
           "no one PyTorch call gives hits and hub together"),
    "B9": ("edge_update", "edge_update", "_launch_dense", "edge_update_ref",
           "src/repro/kernels/edge_update/kernel.py:66",
           "index_put_ leaves the order of duplicate targets undefined (the "
           "last lane must win)"),
}
ADJ_ARG_KERNELS = BFS_KERNELS + DENSE_KERNELS   # argument 1: the adjacency


def edge_batch_lanes(torch, st, rng, lanes: int = LANES):
    """rows, cols, vals, mask int32[lanes] of one equal-mix batch on
    ``st``: its AddE (vals 1) and RemE (vals 0) lanes fire where both keys
    are alive; every other lane is masked (and may carry slot -1)."""
    from repro_torch.core import OP_ADD_E, OP_REM_E, find_slots

    b = equal_mix_batch(rng, 1 << SCALE, DEVICE, lanes)
    r, c = find_slots(st, b.key1), find_slots(st, b.key2)
    edge = (b.opcode == OP_ADD_E) | (b.opcode == OP_REM_E)
    mask = (edge & (r >= 0) & (c >= 0)).to(torch.int32)
    return r, c, (b.opcode == OP_ADD_E).to(torch.int32), mask


def phase_kernel_times(torch, st, pairs, dpairs, index, ist, ipairs,
                       launches, q1_path, timer, rng):
    """Time each kernel on inputs captured from one Q=64 traversal of
    ``st`` on "hybrid_cuda" over ``pairs`` (B1-B3), the traversal of the
    last dense-engine session's ``dpairs`` on "dense_cuda" (B6), one
    single-query traversal on each (B3 and B2, B7), and one Q=64 probe of
    ``index`` on ``ist`` (B4); B8, which no path launches,
    on that probe's label words unpacked and on ``b8_wide_slabs``; B5 and
    B9, which no path
    launches either, on ``st``'s words and dense view with one equal-mix
    batch's edge lanes (timed in place on copies). B2's single-query
    launches are timed apart (``q1_*`` keys; ``q1_path`` of them ran on
    the main path), every row carries the launch floor (``floor_*``) and
    B4's the CUDA kernels one ``query_reach`` on the probe launches."""
    import importlib

    from repro_torch.core import bfs, find_slots, multi_bfs
    from repro_torch.index import build_index, query_reach
    from repro_torch.kernels.edge_update.ops import one_block_lanes

    mods, plain = {}, {}
    for key, (_, pkg, _, ref_fn, _, _) in KERNEL_META.items():
        mods[key] = importlib.import_module(f"repro_torch.kernels.{pkg}.ops")
        ref = importlib.import_module(f"repro_torch.kernels.{pkg}.ref")
        plain[key] = getattr(ref, ref_fn)
    captured = {k: [] for k in mods}
    wide = {"B1": [], "B2": []}          # (args, kwargs) of build_index
    sink = {"to": captured}
    originals = {k: getattr(m, KERNEL_META[k][2]) for k, m in mods.items()}
    traced = [k for k in mods if k not in EDGE_KERNELS]

    def recorder(key):
        def rec(*args, **kw):
            # a BFS kernel's adjacency (argument 1) is the state's or its
            # dense view and stays unchanged
            args_c = tuple(a if i == 1 and key in ADJ_ARG_KERNELS
                           else a.clone() for i, a in enumerate(args))
            if sink["to"] is wide and key in wide:
                wide[key].append((args_c, kw))
            else:
                captured[key].append(args_c)
            return originals[key](*args, **kw)
        return rec

    def slots(state, keys):
        return find_slots(state, torch.tensor(keys, dtype=torch.int32,
                                              device=state.device))

    for k in traced:
        setattr(mods[k], KERNEL_META[k][2], recorder(k))
    try:
        for be, ps in (("hybrid_cuda", pairs), ("dense_cuda", dpairs)):
            sk = slots(st, [p[0] for p in ps])
            dk = slots(st, [p[1] for p in ps])
            multi_bfs(st, sk, dk, backend=be)
            # one single-query traversal to the end (B3 pushes, then B2
            # pulls; B7 pushes throughout)
            bfs(st, sk[:1], -1, backend=be)
        isrc = slots(ist, [p[0] for p in ipairs])
        idst = slots(ist, [p[1] for p in ipairs])
        query_reach(index, isrc, idst)
        # the closures of phase 7's build: B1 and B2 at Q = 1,024
        sink["to"] = wide
        build_index(st, landmark_slots=index.landmarks)
    finally:
        for k in traced:
            setattr(mods[k], KERNEL_META[k][2], originals[k])
    # B8 on the rows the probe joined, and wide
    captured["B8"] = [b8_rows(torch, index, c[3], c[4])
                      for c in captured["B4"]]
    lanes = edge_batch_lanes(torch, st, rng)
    view = captured["B6"][0][1]
    captured["B5"] = [(st.adj_packed, st.ecnt) + lanes]
    captured["B9"] = [(view, st.ecnt) + lanes]
    # the edge writes past the one-block cap at full size
    for n in (one_block_lanes() + 1, 65536):
        edge_check(st.adj_packed, view, st.ecnt,
                   edge_lanes(rng, view.shape[0], n, DEVICE),
                   f"at full size, b={n}")
    lanes = edge_batch_lanes(torch, st, rng, WIDE_EDGE_LANES)
    edge_wide = {"B5": (st.adj_packed, st.ecnt) + lanes,
                 "B9": (view, st.ecnt) + lanes}
    b8_wide = b8_wide_slabs(torch, index, rng)
    sync(torch)
    qr_kernels = query_reach_kernels(torch, index, isrc, idst)
    floor = launch_floor(torch)

    out = []
    for key, calls in captured.items():
        name, pkg, _, _, replaces, no_library = KERNEL_META[key]
        if not calls:
            raise AssertionError(f"{name} ({key}): no launch captured")
        kern = originals[key]
        # the edge writes are checked through their copying wrappers and
        # timed in place
        check = getattr(mods[key], name) if key in EDGE_KERNELS else kern
        q1 = []
        if key == "B2":   # the single-query launches (Q = 1) apart
            q1 = [c for c in calls if c[0].shape[0] == 1]
            calls = [c for c in calls if c[0].shape[0] > 1]
            if not q1 or not calls:
                raise AssertionError(f"{name}: captured {len(calls)} Q > 1 "
                                     f"and {len(q1)} Q = 1 launches")
        t = time_calls(torch, key, calls, check, kern, plain[key], timer)
        ms, dms, subs, pms, bms, bys, err, bare = t
        if key == "B1":
            rows = [c[0].sum(1).float() for c in calls]
            big = max(rows, key=lambda r: float(r.sum()))
            log(f"  B1 frontier skew: the largest captured launch holds "
                f"{int(big.sum())} query rows, {float(big.mean()):.0f} a "
                f"query on average and {int(big.max())} in its largest "
                f"query")
        if key == "B2":
            log(f"  B2 stages every row some query still has to visit in "
                f"full: {statistics.mean(pull_staged_mb(a) for a in calls):.1f}"
                f" MB a launch (the bound reads each row up to its last "
                f"needed word)")
        shapes = sorted({tuple(tuple(a.shape) for a in c[:2]) for c in calls})
        # a trace may come back without device events: average the others
        traced_ms = [d for d in dms if d is not None]
        dev_ms = statistics.mean(traced_ms) if traced_ms else None
        dev = (f"{dev_ms:.4f} ms over {len(traced_ms)} of {len(dms)} "
               f"launches" if traced_ms else "not measured")
        log(f"{name} ({key}): {len(calls)} captured launches at shapes "
            f"{shapes}: kernel {statistics.mean(ms):.4f} ms/launch (CUDA "
            f"events; its kernels' device time {dev} [{sub_line(subs)}]), "
            f"plain {statistics.mean(pms):.3f} ms, bound "
            f"{statistics.mean(bms):.6f} ms ({max(set(bys), key=bys.count)})"
            f"; library_ms null: {no_library}")
        if bare["ms"]:
            log(f"  {name} ({key}) without parents on the same launches: "
                f"kernel {statistics.mean(bare['ms']):.4f} ms/launch, device "
                + (f"{statistics.mean(bare['dms']):.4f}" if bare["dms"]
                   else "not measured")
                + f" ms [{sub_line(bare['subs'])}]")
        out.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{pkg}/kernel.cu",
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": err, "ms": statistics.mean(ms),
            "device_ms": dev_ms,
            "plain_ms": statistics.mean(pms),
            "bound_ms": statistics.mean(bms),
            "bound_by": max(set(bys), key=bys.count), "library_ms": None,
            "device_sub_ms": sub_means(subs), **floor,
        })
        if q1:
            out[-1].update(single_times(torch, key, q1, check, kern,
                                        plain[key], timer, q1_path))
        if key == "B4":
            out[-1]["query_reach_kernels"] = qr_kernels["kernels"]
            out[-1].update(b4_paired(torch, captured["B4"], timer))
        if bare["ms"]:
            out[-1].update({
                "no_parents_ms": statistics.mean(bare["ms"]),
                "no_parents_device_ms": (statistics.mean(bare["dms"])
                                         if bare["dms"] else None),
                "no_parents_device_sub_ms": sub_means(bare["subs"])})
        if key in wide:
            out[-1].update(wide_times(torch, key, wide[key], kern,
                                      plain[key], timer))
        if key in edge_wide:
            # the public wrapper copies adj and ecnt first, as JAX returns
            # new arrays: its wall beside the in-place kernel's
            out[-1]["wrapper_ms"] = timer.ms(lambda: check(*calls[0]), 5)
            log(f"  {name} ({key}) through its public wrapper (a copy of "
                f"{calls[0][0].numel() * calls[0][0].element_size() / 1e6:.0f}"
                f" MB first): {out[-1]['wrapper_ms']:.4f} ms/call (CUDA "
                f"events)")
            out[-1].update(edge_wide_times(torch, key, edge_wide[key], check,
                                           kern, plain[key], timer))
        if key == "B8":
            for prefix, args in b8_wide.items():
                out[-1].update(b8_wide_times(torch, prefix, args, kern,
                                             plain[key], timer))
    return out


def update_mix_batch(rng, n: int, device, lanes: int = LANES):
    """One batch of the update-intensive mix on a graph of ``n`` loaded
    keys: vertex lanes on the SP_CHURN keys around ``n`` (the top half of
    the loaded keys is removed, the new half takes free slots), edge lanes
    on uniform keys of the loaded and the new ones."""
    from repro_torch.convert import op_batch_from_numpy
    from repro_torch.core import (OP_ADD_E, OP_ADD_V, OP_CON_E, OP_CON_V,
                                  OP_REM_E, OP_REM_V)

    ops = np.array([OP_ADD_V, OP_REM_V, OP_CON_V, OP_ADD_E, OP_REM_E,
                    OP_CON_E], np.int32)
    opc = rng.choice(ops, size=lanes, p=np.array(UPDATE_MIX) / 100)
    top = n + SP_CHURN // 2
    vert = (opc == OP_ADD_V) | (opc == OP_REM_V) | (opc == OP_CON_V)
    k1 = np.where(vert, rng.integers(n - SP_CHURN // 2, top, lanes),
                  rng.integers(0, top, lanes))
    return op_batch_from_numpy(opc, k1, rng.integers(0, top, lanes),
                               np.full(lanes, -1), device)


def sp_bound(torch, ops, codes, mask, v: int, w: int):
    """(bound ms, bytes) of one serial pass launch from what its lanes did:
    the slot table read once (5 bytes a slot), the in-row of every vertex
    removed (4 W bytes), row and column of both mirrors for every slot
    allocated (2 x 4 (W + V) bytes), two words for every edge written. The
    lanes depend on each other, so latency rules long before this."""
    from repro_torch.core import (OP_ADD_V, OP_REM_V, R_EDGE_ADDED,
                                  R_EDGE_REMOVED, R_TRUE)

    def n(sel):
        return int((sel & mask).sum())

    ok = codes == R_TRUE
    nbytes = (5 * v + n(ok & (ops.opcode == OP_REM_V)) * 4 * w
              + n(ok & (ops.opcode == OP_ADD_V)) * 8 * (w + v)
              + n((codes == R_EDGE_ADDED) | (codes == R_EDGE_REMOVED)) * 8)
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def phase_serial_pass(torch, rng, main_launches: int) -> dict:
    """Phase 6b (module docstring): the kernels line's SP entry."""
    from repro_torch.convert import state_from_numpy
    from repro_torch.core import OP_NOP, apply_ops, apply_ops_fast
    from repro_torch.core.ops import (_alloc_schedule, _apply_clean_vectorized,
                                      _copy, _lane_conflicts)
    from repro_torch.kernels.serial_pass import ops as sp_ops
    from repro_torch.kernels.serial_pass.ref import serial_pass_ref
    from repro_torch.obs import trace

    t0 = time.perf_counter()
    n = 1 << SP_SCALE
    arrays, _ = graph500_state_arrays(SP_SCALE, SP_CAPACITY, rng)
    st = state_from_numpy(*arrays, device=DEVICE)
    del arrays
    v, w = st.adj_packed.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per = -(-v // sms)
    if per <= SP_THREADS:
        raise AssertionError(f"V = {v} on {sms} SMs: {per} slots a block, "
                             f"no thread owns two")
    batch = update_mix_batch(rng, n, DEVICE, LANES)
    sync(torch)
    log(f"serial pass at the benchmark's size: Graph500 SCALE {SP_SCALE}, "
        f"capacity {v} ({per} slots a block on {sms} SMs, the free slots "
        f"from offset {n - (n // per) * per} of block {n // per}), built in "
        f"{time.perf_counter() - t0:.1f} s")

    before = sp_ops.launches
    with trace.capture() as rec:
        fast_st, fast_res = apply_ops_fast(st, batch)
    sync(torch)
    (app,) = [e["args"] for e in rec.events() if e["name"] == "ops.apply"]
    ser_st, ser_res = apply_ops(st, batch)
    for f, x, y in zip(("codes",) + st._fields, (fast_res,) + fast_st,
                       (ser_res,) + ser_st):
        if not torch.equal(x, y):
            raise AssertionError(f"apply_ops_fast != apply_ops at capacity "
                                 f"{v}: {f}")
    if sp_ops.launches - before != 1 or app["replay"]:
        raise AssertionError(f"{sp_ops.launches - before} serial pass "
                             f"launches at capacity {v}: {app}")
    del fast_st, ser_st
    log(f"apply_ops_fast == apply_ops at capacity {v} on one update-mix "
        f"batch (codes + 6 arrays, B={LANES}, {app['serial_lanes']} serial "
        f"lanes, one launch)")

    # the launch's input: the batch's copy after the clean pass
    conflict = _lane_conflicts(batch)
    wants, slot, _ = _alloc_schedule(st, batch)
    base = _copy(st)
    base_res = _apply_clean_vectorized(
        base, batch, ~conflict & (batch.opcode != OP_NOP), wants, slot)
    del st
    work = [t.clone() for t in base]
    res = base_res.clone()

    def restore():
        for a, b in zip(work, base):
            a.copy_(b)
        res.copy_(base_res)

    def launch():
        sp_ops._launch(*work, *batch, conflict, res)

    ms = []
    for _ in range(SP_REPS):
        restore()
        sync(torch)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    if not torch.equal(res, fast_res):
        raise AssertionError("the timed launch's codes != apply_ops_fast's")
    _, path = profiled(torch, lambda: (restore(), launch()), "serial_pass")
    _, per_name = _busy_ms(path)
    dev = [t for k, t in per_name.items() if "serial_lanes" in k]
    plain = []
    for _ in range(2):
        restore()
        sync(torch)
        t1 = time.perf_counter()
        serial_pass_ref(*work, *batch, conflict, res)
        sync(torch)
        plain.append((time.perf_counter() - t1) * 1e3)
    if not torch.equal(res, fast_res):
        raise AssertionError("the host pass's codes != apply_ops_fast's")
    bound_ms, nbytes = sp_bound(torch, batch, fast_res, conflict, v, w)
    lanes = int(conflict.sum())
    out = {"name": "serial_pass", "route": "cuda",
           "source": "src/repro_torch/kernels/serial_pass/kernel.cu",
           "replaces": None, "launches": main_launches, "max_abs_err": 0,
           "ms": statistics.median(ms), "ms_all": ms,
           "device_ms": sum(dev) if dev else None,
           "plain_ms": statistics.median(plain), "bound_ms": bound_ms,
           "bound_by": "bytes", "library_ms": None, "lanes": lanes,
           "shape": [v, w, LANES]}
    log(f"serial_pass (SP): V = {v}, W = {w}, B = {LANES}, {lanes} serial "
        f"lanes: kernel {out['ms']:.4f} ms/launch median of {SP_REPS} (CUDA "
        f"events; {min(ms):.4f}-{max(ms):.4f}; "
        f"{out['ms'] / lanes * 1e3:.2f} us a lane), device "
        + (f"{out['device_ms']:.4f} ms" if dev else "not measured")
        + f", host pass {out['plain_ms']:.1f} ms, bound {bound_ms:.6f} ms "
        f"({nbytes / 1e6:.1f} MB); library_ms null: no PyTorch call applies "
        f"dependent lanes")
    del work, base, res, base_res, fast_res, ser_res
    torch.cuda.empty_cache()
    return out


def pw_bound(block, q: int):
    """(bound ms, bytes) of one path walk launch from the paths it found:
    a row's flag, endpoint slots and header (17 bytes), and for each slot
    on a path its parent, its key and the key's store (12 bytes). A hop's
    address is the previous hop's value, so latency rules long before
    this."""
    nbytes = 17 * q + 12 * int(block[:, 1].sum())
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def parent_walk(cur, vkey):
    """GetPath's materialization as the port made it before the walk moved
    to the card: ``parent``, the flags, the endpoint slots and ``vkey`` to
    the host, then ``extract_path`` and a key gather over V a pair."""
    from repro_torch.core.bfs import extract_path

    parent, found, src, dst, keys = (t.cpu().numpy() for t in (
        cur.parent, cur.found, cur.src_slot, cur.dst_slot, vkey))
    v = parent.shape[1]
    out = []
    for qi in range(parent.shape[0]):
        if not found[qi]:
            out.append((False, []))
            continue
        n, slots = extract_path(parent[qi], int(src[qi]), int(dst[qi]))
        got = np.where(slots >= 0, keys[np.clip(slots, 0, v - 1)], -1)
        out.append((True, [int(x) for x in got[:n]]))
    return out


def phase_path_walk(torch, rng, main_launches: int) -> dict:
    """Phase 6c (module docstring): the kernels line's PW entry."""
    from repro_torch.convert import state_from_numpy
    from repro_torch.core.snapshot import _materialize_batch, collect_batch
    from repro_torch.kernels.path_walk import ops as pw_ops
    from repro_torch.kernels.path_walk.ref import CAP, path_walk_ref

    t0 = time.perf_counter()
    n = 1 << SP_SCALE
    arrays, _ = graph500_state_arrays(SP_SCALE, SP_CAPACITY, rng)
    st = state_from_numpy(*arrays, device=DEVICE)
    deg_src = np.flatnonzero(arrays[3][:n] > 0)
    del arrays
    v = st.capacity
    pairs = list(zip(rng.choice(deg_src, QUERIES).tolist(),
                     rng.integers(0, n, QUERIES).tolist()))
    cur = collect_batch(st, [a for a, _ in pairs], [b for _, b in pairs])
    sync(torch)
    log(f"path walk at the benchmark's size: Graph500 SCALE {SP_SCALE}, "
        f"capacity {v}, Q = {QUERIES}, forest built in "
        f"{time.perf_counter() - t0:.1f} s")
    args = (cur.parent, cur.found, cur.src_slot, cur.dst_slot, st.vkey)
    host_args = [t.cpu() for t in args]

    before = pw_ops.launches
    got = pw_ops.path_walk(*args)
    sync(torch)
    if pw_ops.launches - before != 1:
        raise AssertionError(f"{pw_ops.launches - before} path walk "
                             f"launches for one walk")
    block = got.cpu().numpy()
    want = path_walk_ref(*host_args).numpy()
    if not np.array_equal(block, want):
        raise AssertionError("the path walk kernel != its plain version at "
                             f"V = {v}, Q = {QUERIES}")
    walked = _materialize_batch(st, cur, pairs)
    old = parent_walk(cur, st.vkey)
    if walked != old:
        raise AssertionError("the session's paths != the host walk's")
    found = int(block[:, 0].sum())
    hops = int(block[:, 1].max())
    log(f"path walk == its plain version == the host walk at V = {v}: "
        f"{found} of {QUERIES} pairs found, longest {hops} slots")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    ms = []
    for _ in range(SP_REPS):
        flush.zero_()
        sync(torch)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        pw_ops.path_walk(*args)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    _, path = profiled(torch, lambda: pw_ops.path_walk(*args), "path_walk")
    _, per_name = _busy_ms(path)
    dev = [t for k, t in per_name.items() if "walk_paths" in k]

    def wall(fn, reps):
        out = []
        for _ in range(reps):
            sync(torch)
            t1 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t1) * 1e3)
        return out

    session = wall(lambda: _materialize_batch(st, cur, pairs), SP_REPS)
    host = wall(lambda: parent_walk(cur, st.vkey), 2)
    plain = wall(lambda: path_walk_ref(*host_args), 2)
    bound_ms, nbytes = pw_bound(block, QUERIES)
    out = {"name": "path_walk", "route": "cuda",
           "source": "src/repro_torch/kernels/path_walk/kernel.cu",
           "replaces": None, "launches": main_launches, "max_abs_err": 0,
           "ms": statistics.median(ms), "ms_all": ms,
           "device_ms": sum(dev) if dev else None,
           "session_ms": statistics.median(session),
           "session_ms_all": session,
           "host_walk_ms": statistics.median(host),
           "plain_ms": statistics.median(plain), "bound_ms": bound_ms,
           "bound_by": "bytes", "library_ms": None, "found": found,
           "hops": hops, "shape": [QUERIES, v, CAP]}
    log(f"path_walk (PW): Q = {QUERIES}, V = {v}, cap {CAP}, {found} paths, "
        f"longest {hops}: kernel {out['ms']:.4f} ms/launch median of "
        f"{SP_REPS} (CUDA events, L2 flushed; {min(ms):.4f}-{max(ms):.4f}), "
        "device " + (f"{out['device_ms']:.4f} ms" if dev else "not measured")
        + f"; the session's materialization {out['session_ms']:.3f} ms "
        f"(launch, copy home, lists; host clock), the host walk it replaced "
        f"{out['host_walk_ms']:.1f} ms, the plain version on host tensors "
        f"{out['plain_ms']:.3f} ms, bound {bound_ms:.6f} ms ({nbytes} B); "
        f"library_ms null: no PyTorch call follows a chain of parents")
    del st, cur, args, got, flush
    torch.cuda.empty_cache()
    return out


def events_ms(torch, fn):
    """(CUDA-event ms, host ms) of one call of ``fn``, from a synchronized
    start to the end of the device work it queued."""
    sync(torch)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t1 = time.perf_counter()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), (time.perf_counter() - t1) * 1e3


def phase_inplace_apply(torch, rng) -> dict:
    """Phase 6d (module docstring): the ``inplace_apply`` line."""
    from repro_torch.convert import state_from_numpy
    from repro_torch.core import apply_ops_fast
    from repro_torch.core.ops import apply_ops_fast_
    from repro_torch.obs import trace

    t0 = time.perf_counter()
    n = 1 << SP_SCALE
    arrays, _ = graph500_state_arrays(SP_SCALE, SP_CAPACITY, rng)
    base = state_from_numpy(*arrays, device=DEVICE)
    del arrays
    v, w = base.adj_packed.shape
    mirror = base.adj_packed.numel() * base.adj_packed.element_size()
    batch = update_mix_batch(rng, n, DEVICE, LANES)
    work = type(base)(*(t.clone() for t in base))
    sync(torch)
    log(f"in-place apply at the benchmark's size: Graph500 SCALE {SP_SCALE}"
        f", capacity {v}, a mirror {mirror / 1e9:.2f} GB, built in "
        f"{time.perf_counter() - t0:.1f} s")

    def restore():
        for a, b in zip(work, base):
            a.copy_(b)

    copied, want = apply_ops_fast(base, batch)
    with trace.capture() as rec:
        got, res = apply_ops_fast_(work, batch)
    sync(torch)
    ev = rec.events()
    (app,) = [e["args"] for e in ev if e["name"] == "ops.apply"]
    copies = [e for e in ev if e["name"] == "ops.copy"]
    if got is not work or not app["in_place"] or copies:
        raise AssertionError(f"the update-mix batch was not applied in "
                             f"place: {app}, {len(copies)} copies")
    for f, x, y in zip(("codes",) + base._fields, (res,) + tuple(got),
                       (want,) + tuple(copied)):
        if not torch.equal(x, y):
            raise AssertionError(f"apply_ops_fast_ != apply_ops_fast at "
                                 f"capacity {v}: {f}")
    del copied, got, want, res
    log(f"apply_ops_fast_ == apply_ops_fast at capacity {v} on one "
        f"update-mix batch (codes + 6 arrays, B={LANES}, "
        f"{app['serial_lanes']} serial lanes), in place, no copy")

    def in_place():
        apply_ops_fast_(work, batch)

    def to_copy():
        apply_ops_fast(base, batch)

    def rise(fn):
        sync(torch)
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        fn()
        sync(torch)
        return torch.cuda.max_memory_allocated() - held

    restore()
    rises = {"in_place": rise(in_place), "copy": rise(to_copy)}
    ms = {"in_place": [], "copy": []}
    wall = {"in_place": [], "copy": []}
    for _ in range(SP_REPS):
        for key, fn in (("in_place", in_place), ("copy", to_copy)):
            if key == "in_place":
                restore()
            e, h = events_ms(torch, fn)
            ms[key].append(e)
            wall[key].append(h)
    traces = {"in_place": profiled(torch, in_place, "inplace_apply",
                                   prep=restore)[1],
              "copy": profiled(torch, to_copy, "copy_apply")[1]}
    out = {"name": "inplace_apply", "shape": [v, w, LANES],
           "serial_lanes": app["serial_lanes"], "mirror_bytes": mirror}
    for key, path in traces.items():
        events = device_events(path)
        busy, per_name = _busy_ms(path)
        out[f"{key}_ms"] = statistics.median(ms[key])
        out[f"{key}_ms_all"] = ms[key]
        out[f"{key}_wall_ms"] = statistics.median(wall[key])
        out[f"{key}_device_ms"] = busy if events else None
        out[f"{key}_memcpy_ms"] = sum(t for k, t in per_name.items()
                                      if "Memcpy" in k)
        out[f"{key}_launches"] = len(events)
        out[f"{key}_peak_rise_bytes"] = rises[key]
    log(f"in place: {out['in_place_ms']:.3f} ms (CUDA events, median of "
        f"{SP_REPS}; host {out['in_place_wall_ms']:.3f}), device "
        f"{out['in_place_device_ms']} ms, {out['in_place_launches']} "
        f"launches, +{rises['in_place'] / 1e9:.3f} GB; to a copy: "
        f"{out['copy_ms']:.3f} ms (host {out['copy_wall_ms']:.3f}), device "
        f"{out['copy_device_ms']} ms ({out['copy_memcpy_ms']:.3f} ms "
        f"copies), {out['copy_launches']} launches, "
        f"+{rises['copy'] / 1e9:.3f} GB")
    log(json.dumps({"inplace_apply": out}))
    del work, base, batch
    torch.cuda.empty_cache()
    return out


# the ingest cell's round (graphbench/traffic/ingest.json): 7 clients of
# 64 lanes, {AddV 12.5, ConV 25, AddE 25, RemE 12.5, ConE 25} % of each
INGEST_CLIENTS = 7
INGEST_CLIENT_LANES = {"AddV": 8, "ConV": 16, "AddE": 16, "RemE": 8,
                       "ConE": 16}
INGEST_PAD = 512              # the pool's power-of-two bucket of 448 lanes


def ingest_round_ops(rng, n: int, out_words) -> list:
    """One fused apply of the ingest cell's clients on a graph of ``n``
    loaded keys, as (opcode, k1, k2) tuples in client order: AddV on the
    SP_CHURN keys above ``n``, ConV / ConE uniform over loaded and churn
    keys, AddE uniform loaded pairs, RemE arcs of ``out_words`` (the
    packed out mirror as uint32 on the host), as the cell's RemE lanes
    remove arcs added rounds before."""
    from repro_torch.core import (OP_ADD_E, OP_ADD_V, OP_CON_E, OP_CON_V,
                                  OP_REM_E)

    code = {"AddV": OP_ADD_V, "ConV": OP_CON_V, "AddE": OP_ADD_E,
            "RemE": OP_REM_E, "ConE": OP_CON_E}
    keys = n + SP_CHURN

    def arc():
        while True:
            r = int(rng.integers(0, n))
            cols = np.flatnonzero(np.unpackbits(
                out_words[r].view(np.uint8), bitorder="little"))
            if cols.size:
                return r, int(rng.choice(cols))

    ops = []
    for _ in range(INGEST_CLIENTS):
        lanes = []
        for op, count in INGEST_CLIENT_LANES.items():
            for _ in range(count):
                if op == "AddV":
                    lanes.append((code[op], n + int(rng.integers(SP_CHURN))))
                elif op == "ConV":
                    lanes.append((code[op], int(rng.integers(keys))))
                elif op == "AddE":
                    lanes.append((code[op], *map(int, rng.integers(0, n, 2))))
                elif op == "RemE":
                    lanes.append((code[op], *arc()))
                else:
                    lanes.append((code[op], *map(int,
                                                 rng.integers(0, keys, 2))))
        ops += [lanes[i] for i in rng.permutation(len(lanes))]
    return ops


def whole_mirror_record(torch, a, b) -> dict:
    """The record of a -> b as a whole-mirror compare finds it: the rows of
    ``changed_rows`` (the whole mirrors compared on the device), with the
    XOR of each field on those rows, on the host."""
    rows = changed_rows(a, b)
    at = torch.from_numpy(rows).to(a.vkey.device).long()
    out = {"rows": rows}
    for f in ("vkey", "valive", "vver", "ecnt", "adj_packed"):
        out[f] = (getattr(a, f)[at] ^ getattr(b, f)[at]).cpu().numpy()
    return out


def phase_ring_push(torch, rng) -> dict:
    """Phase 6e (module docstring): the ``ring_push`` line."""
    from repro_torch.convert import state_from_numpy
    from repro_torch.core import EpochRing, apply_ops_fast, make_op_batch
    from repro_torch.obs import trace

    t0 = time.perf_counter()
    n = 1 << SP_SCALE
    arrays, _ = graph500_state_arrays(SP_SCALE, SP_CAPACITY, rng)
    ops = ingest_round_ops(rng, n, arrays[4])
    base = state_from_numpy(*arrays, device=DEVICE)
    del arrays
    v, w = base.adj_packed.shape
    batch = make_op_batch(ops, lanes=INGEST_PAD, device=DEVICE)
    nxt, _ = apply_ops_fast(base, batch)
    sync(torch)
    log(f"ring push at the benchmark's size: Graph500 SCALE {SP_SCALE}, "
        f"capacity {v}, one fused apply of {len(ops)} ingest lanes padded "
        f"to {INGEST_PAD}, built in {time.perf_counter() - t0:.1f} s")

    want = whole_mirror_record(torch, base, nxt)
    ring = EpochRing(2)

    def reset():
        ring.reset(0, base)

    def push():
        ring.push(1, nxt)

    reset()
    with trace.capture() as rec:
        push()
    (span,) = [e["args"] for e in rec.events() if e["name"] == "ring.push"]
    got = ring._records[-1]
    pairs = (("rows", got.rows), ("vkey", got.vkey_xor),
             ("valive", got.valive_xor), ("vver", got.vver_xor),
             ("ecnt", got.ecnt_xor), ("adj_packed", got.adj_xor))
    for f, x in pairs:
        y = want[f]
        if x.shape != y.shape or x.tobytes() != y.tobytes():
            raise AssertionError(f"ring.push's record != the whole-mirror "
                                 f"diff at capacity {v}: {f}")
    versions = torch.stack([nxt.ecnt, nxt.vver], -1).cpu().numpy()
    if got.versions.tobytes() != versions.tobytes():
        raise AssertionError("ring.push's version vector != (ecnt, vver)")
    k = int(got.rows.size)
    allocated = int(((base.vkey == -1) & (base.vver != nxt.vver)).sum())
    log(f"ring.push == the whole-mirror diff at capacity {v}: {k} rows, "
        f"{allocated} slots allocated, {span['bytes']} bytes home")

    # what the push must move on the device: the four scalars of both
    # states (13 bytes a slot), the allocated slots' in-rows, both states'
    # rows of the record, the version vector read and written, the patch
    nbytes = (2 * 13 * v + 4 * w * allocated + 2 * 4 * w * k + 2 * 8 * v
              + 4 * k * (5 + w))

    def whole_diff():
        whole_mirror_record(torch, base, nxt)

    ms = {"push": [], "whole_diff": []}
    wall = {"push": [], "whole_diff": []}
    for _ in range(SP_REPS):
        for key, fn in (("push", push), ("whole_diff", whole_diff)):
            if key == "push":
                reset()
            e, h = events_ms(torch, fn)
            ms[key].append(e)
            wall[key].append(h)
    path = profiled(torch, push, "ring_push", prep=reset)[1]
    events = device_events(path)
    busy, per_name = _busy_ms(path)
    out = {"name": "ring_push", "shape": [v, w, INGEST_PAD], "rows": k,
           "allocated": allocated, "host_bytes": int(span["bytes"]),
           "bytes": nbytes,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "push_ms": statistics.median(ms["push"]),
           "push_ms_all": ms["push"],
           "push_wall_ms": statistics.median(wall["push"]),
           "push_device_ms": busy if events else None,
           "push_memcpy_ms": sum(t for key, t in per_name.items()
                                 if "Memcpy" in key),
           "push_launches": len(events),
           "whole_diff_ms": statistics.median(ms["whole_diff"]),
           "whole_diff_wall_ms": statistics.median(wall["whole_diff"])}
    log(f"ring.push: {out['push_ms']:.3f} ms (CUDA events, median of "
        f"{SP_REPS}; host {out['push_wall_ms']:.3f}), device "
        f"{out['push_device_ms']} ms ({out['push_memcpy_ms']:.3f} ms "
        f"copies), {out['push_launches']} launches; bound "
        f"{out['bound_ms']:.4f} ms ({nbytes / 1e6:.2f} MB); the whole-mirror "
        f"diff of the same states: {out['whole_diff_ms']:.3f} ms (host "
        f"{out['whole_diff_wall_ms']:.3f})")
    log(json.dumps({"ring_push": out}))
    del ring, base, nxt, batch
    torch.cuda.empty_cache()
    return out


B8_WIDE_Q = 16384     # B8's wide shape: pairs of the index's live slots


def b8_rows(torch, index, src, dst):
    """(out_rows, in_rows) int32[Q, L]: the 0/1 labels B4 by slot joins for
    slots ``src`` / ``dst`` of ``index``, gathered and unpacked."""
    from repro_torch.core.graph import unpack_bits

    args = (index.out_label, index.in_label, index.alive, src, dst)
    return tuple(unpack_bits(a, index.num_landmarks).to(torch.int32)
                 for a in gathered_rows(args))


def live_pairs(torch, index, n: int, rng):
    """(src, dst) int32[n] slots drawn from ``rng`` among ``index``'s live
    slots."""
    live = index.alive.nonzero().flatten().cpu().numpy()
    return tuple(torch.from_numpy(rng.choice(live, n).astype(np.int32))
                 .to(index.alive.device) for _ in range(2))


def b8_wide_slabs(torch, index, rng):
    """B8's wide inputs: ``"wide"``, the labels of ``B8_WIDE_Q`` pairs of
    the index's live slots (pruned: nearly every OUT entry is 0), and
    ``"wide_dense"``, a 0/1 slab of the same shape at density 0.3."""
    gen = torch.Generator(device=DEVICE).manual_seed(int(rng.integers(2**31)))
    shape = (B8_WIDE_Q, index.num_landmarks)
    dense = tuple((torch.rand(shape, generator=gen, device=DEVICE) < 0.3)
                  .to(torch.int32) for _ in range(2))
    return {"wide": b8_rows(torch, index,
                            *live_pairs(torch, index, B8_WIDE_Q, rng)),
            "wide_dense": dense}


def b8_wide_times(torch, prefix, args, kern, plain, timer):
    """B8 on one wide slab pair: ``<prefix>_*`` keys of the kernels line."""
    ms, dms, subs, pms, bms, _, err, _ = time_calls(torch, "B8", [args], kern,
                                                    kern, plain, timer)
    q, l = args[0].shape
    res = {f"{prefix}_q": q, f"{prefix}_l": l,
           f"{prefix}_out_labels": int((args[0] > 0).sum()),
           f"{prefix}_max_abs_err": err, f"{prefix}_ms": ms[0],
           f"{prefix}_device_ms": dms[0], f"{prefix}_plain_ms": pms[0],
           f"{prefix}_bound_ms": bms[0]}
    log(f"label_join (B8) {prefix} at Q = {q}, L = {l} "
        f"({res[prefix + '_out_labels']} OUT entries > 0): max_abs_err "
        f"{err}, kernel {ms[0]:.4f} ms/launch (CUDA events), device "
        + (f"{dms[0]:.4f}" if dms[0] is not None else "not measured")
        + f" ms [{sub_line(subs)}], plain {pms[0]:.3f} ms, bound "
        f"{bms[0]:.6f} ms")
    return res


def edge_wide_times(torch, key, args, check, kern, plain, timer):
    """B5/B9 on the lanes of one ``WIDE_EDGE_LANES`` equal-mix batch (the
    global-scratch path): ``wide_*`` keys of the kernels line."""
    ms, dms, subs, pms, bms, _, err, _ = time_calls(torch, key, [args], check,
                                                    kern, plain, timer)
    res = {"wide_lanes": int(args[2].numel()),
           "wide_firing": int((args[5] > 0).sum()), "wide_max_abs_err": err,
           "wide_ms": ms[0], "wide_device_ms": dms[0],
           "wide_device_sub_ms": sub_means(subs), "wide_plain_ms": pms[0],
           "wide_bound_ms": bms[0]}
    log(f"{KERNEL_META[key][0]} ({key}) at B = {res['wide_lanes']} "
        f"({res['wide_firing']} firing): max_abs_err {err}, kernel "
        f"{ms[0]:.4f} ms/launch (CUDA events), device "
        + (f"{dms[0]:.4f}" if dms[0] is not None else "not measured")
        + f" ms [{sub_line(subs)}], plain {pms[0]:.3f} ms, bound "
        f"{bms[0]:.6f} ms")
    return res


def time_calls(torch, key, calls, check, kern, plain, timer):
    """Each launch in ``calls`` against its plain version, then timed:
    (events ms, device ms, sub-kernel ms, plain ms, bound ms, bound_by,
    max_abs_err) per launch, and for B6 the same launches without parents
    ({"ms", "dms", "subs"}, empty for the other kernels)."""
    name = KERNEL_META[key][0]
    ms, dms, subs, pms, bms, bys, err = [], [], [], [], [], [], 0
    bare = {"ms": [], "dms": [], "subs": []}   # B6 without parents
    for args in calls:
        got, want = check(*args), plain(*args)
        same(got, want, f"{name}: kernel != plain at full size")
        err = max(err, max_abs_err(torch, got, want))
        nbytes, nops, peak = _work(torch, key, args, want)
        del got, want
        if key in EDGE_KERNELS:
            args = (args[0].clone(), args[1].clone()) + tuple(args[2:])
        ms.append(timer.ms(lambda: kern(*args), 20))
        d, sub = timer.device_ms(lambda: kern(*args), 20)
        dms.append(d)
        subs.append(sub)
        if key == "B6":
            same(kern(*args, parents=False), plain(*args, parents=False),
                 f"{name} without parents at full size")
            bare["ms"].append(timer.ms(lambda: kern(*args, parents=False),
                                       20))
            d, sub = timer.device_ms(lambda: kern(*args, parents=False), 20)
            if d is not None:
                bare["dms"].append(d)
            bare["subs"].append(sub)
        pms.append(timer.ms(lambda: plain(*args), 2))
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / peak
        bms.append(max(t_bytes, t_ops) * 1e3)
        bys.append("bytes" if t_bytes >= t_ops else "operations")
        del args
    return ms, dms, subs, pms, bms, bys, err, bare


def gathered_rows(args):
    """(out_rows, in_rows) int32[Q, W]: the rows B4 by slot joins, gathered
    (zero where an endpoint is not ok)."""
    from repro_torch.kernels.label_join.ref import endpoint_ok, slot_rows

    out_label, in_label, alive, src, dst = args
    return (slot_rows(out_label, src, endpoint_ok(alive, src)),
            slot_rows(in_label, dst, endpoint_ok(alive, dst)))


def b4_paired(torch, calls, timer, rounds=3):
    """B4 by slot against the step it replaced on the probe's launches:
    ``query_reach``'s gather (``endpoint_ok`` and ``slot_rows`` in torch)
    and the gathered-rows entry ``label_join_packed``, and that entry
    alone, timed by CUDA events in turns rows, step, slots, slots, step,
    rows, ``rounds`` times: ``paired_*_ms`` keys (one mean per turn)."""
    from repro_torch.kernels.label_join.ops import (label_join_packed,
                                                    label_join_slots)

    t = {"slots": [], "step": [], "rows": []}
    for args in calls:
        rows = gathered_rows(args)
        fns = {"slots": lambda: label_join_slots(*args),
               "step": lambda: label_join_packed(*gathered_rows(args)),
               "rows": lambda: label_join_packed(*rows)}
        for _ in range(rounds):
            for k in ("rows", "step", "slots", "slots", "step", "rows"):
                t[k].append(timer.ms(fns[k], 20))
    res = {f"paired_{k}_ms": v for k, v in t.items()}
    log("  B4 in turns on the same probe (CUDA events, ms/launch): by slot "
        + ", ".join(f"{x:.4f}" for x in t["slots"]) + "; gather + "
        "gathered-rows entry " + ", ".join(f"{x:.4f}" for x in t["step"])
        + "; gathered-rows entry alone "
        + ", ".join(f"{x:.4f}" for x in t["rows"]))
    return res


def single_times(torch, key, calls, check, kern, plain, timer, path):
    """The kernel's single-query (Q = 1) launches apart: ``q1_*`` keys of
    the kernels line (``q1_path_launches``: its Q = 1 launches on the main
    path, those of the single sessions)."""
    ms, dms, subs, pms, bms, _, err, _ = time_calls(torch, key, calls, check,
                                                    kern, plain, timer)
    traced = [d for d in dms if d is not None]
    res = {"q1_launches": len(calls), "q1_path_launches": path,
           "q1_max_abs_err": err, "q1_ms": statistics.mean(ms),
           "q1_device_ms": statistics.mean(traced) if traced else None,
           "q1_plain_ms": statistics.mean(pms),
           "q1_bound_ms": statistics.mean(bms)}
    log(f"{KERNEL_META[key][0]} ({key}) at Q = 1: {len(calls)} captured "
        f"launches ({path} on the main path's single sessions), max_abs_err "
        f"{err}: kernel {res['q1_ms']:.4f} ms/launch (CUDA events), device "
        + (f"{res['q1_device_ms']:.4f}" if traced else "not measured")
        + f" ms [{sub_line(subs)}], plain {res['q1_plain_ms']:.3f} ms, "
        f"bound {res['q1_bound_ms']:.6f} ms")
    return res


def launch_floor(torch, reps=200):
    """What one launch costs at the least: ``reps`` one-element
    ``torch.zeros(1, device="cuda")`` fills back to back, timed by CUDA
    events (the host's enqueue of one PyTorch launch; behind an L2 flush
    the enqueue hides and the fill reads 0) and by the fill kernel's own
    device time in a profiler trace."""
    def fills():
        for _ in range(reps):
            torch.zeros(1, device="cuda")

    fills()
    sync(torch)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fills()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    _, path = profiled(torch, fills, "launch_floor")
    _, per_name = _busy_ms(path)
    dms = sum(per_name.values()) / reps if per_name else None
    log(f"launch floor (torch.zeros(1) fill): {ms:.4f} ms/launch back to "
        f"back (CUDA events), device "
        + (f"{dms:.4f} ms" if dms is not None else "not measured"))
    return {"floor_ms": ms, "floor_device_ms": dms}


def query_reach_kernels(torch, index, src, dst):
    """The CUDA kernels (and copies and fills) one ``query_reach`` on these
    slot tensors launches, from a ``profiled`` trace: {"kernels": n,
    "copies": n, "fills": n} (the names are logged); n["kernels"] is None
    when the trace holds no B4 launch."""
    from repro_torch.index import query_reach

    _, path = profiled(torch, lambda: query_reach(index, src, dst),
                       "query_reach")
    events = device_events(path)
    joined = any("label_join_slots" in e["name"] for e in events)
    n = {k: sum(e["cat"] == c for e in events) for k, c in
         (("kernels", "kernel"), ("copies", "gpu_memcpy"),
          ("fills", "gpu_memset"))}
    if not joined:
        n["kernels"] = None
    names = [re.split(r"[(<]", re.sub(r"^void |\(anonymous namespace\)::",
                                      "", e["name"]))[0][:48]
             for e in events if e["cat"] == "kernel"]
    log(f"query_reach on the phase-7 probe (Q = {src.numel()}): "
        + (f"{n['kernels']} CUDA kernels, {n['copies']} copies, "
           f"{n['fills']} fills (torch.profiler): {names}"
           if joined else
           "kernels not measured (the trace holds no B4 launch)"))
    return n


def pull_staged_mb(args):
    """MB of in-rows B2 reads on these inputs: every alive row some query
    with a non-empty frontier has not visited, in full."""
    fw, adj_in, alive, vis = args
    pending = ~vis & (fw != 0).any(1)[:, None]
    rows = int((alive & pending.any(0)).sum())
    return rows * adj_in.shape[1] * 4 / 1e6


def sub_means(subs):
    """{sub-kernel: mean device ms} over launches' {sub-kernel: ms}."""
    names = sorted({k for s in subs for k in s})
    return {k: statistics.mean(s.get(k, 0.0) for s in subs) for k in names}


def sub_line(subs):
    """'name ms, ...' of the mean per-sub-kernel device times."""
    return ", ".join(f"{k} {v:.4f}" for k, v in sub_means(subs).items())


def wide_times(torch, key, calls, kern, plain, timer):
    """B1/B2 on the Q = 1,024 launches of one index build: every launch
    against its plain version (as the build ran it, without parents), the
    ``WIDE_TIMED`` largest timed beside their bound."""
    if not calls:
        raise AssertionError(f"{key}: no launch of the index build captured")
    err = 0
    for args, kw in calls:
        got, want = kern(*args, **kw), plain(*args, **kw, budget=WIDE_BUDGET)
        same(got, want, f"{key}: kernel != plain at Q = 1,024")
        err = max(err, max_abs_err(torch, got, want))
        del got, want

    def size(c):
        fr, _, _, vis = c[0]
        return int(fr.sum()) if key == "B1" else int((~vis).sum())
    ms, dms, subs, bms = [], [], [], []
    for args, kw in sorted(calls, key=size, reverse=True)[:WIDE_TIMED]:
        want = plain(*args, **kw, budget=WIDE_BUDGET)
        nbytes, nops, peak = _work(torch, key, args, want)
        del want
        ms.append(timer.ms(lambda: kern(*args, **kw), 20))
        d, sub = timer.device_ms(lambda: kern(*args, **kw), 20)
        if d is not None:
            dms.append(d)
        subs.append(sub)
        bms.append(max(nbytes / HBM_BYTES_PER_S, nops / peak) * 1e3)
    res = {"q1024_launches": len(calls), "q1024_max_abs_err": err,
           "q1024_ms": statistics.mean(ms),
           "q1024_device_ms": statistics.mean(dms) if dms else None,
           "q1024_bound_ms": statistics.mean(bms)}
    log(f"{KERNEL_META[key][0]} ({key}) at Q = 1,024: {len(calls)} launches "
        f"of one build_index ({calls[0][1] or 'with parents'}), max_abs_err "
        f"{err}; the {len(ms)} largest: kernel {res['q1024_ms']:.4f} "
        f"ms/launch (CUDA events), device "
        + (f"{res['q1024_device_ms']:.4f}" if dms else "not measured")
        + f" ms [{sub_line(subs)}], bound {res['q1024_bound_ms']:.6f} ms")
    return res


def max_abs_err(torch, got, want, chunk=1 << 26):
    """Largest |got - want| over the outputs, in int64 over chunks of
    ``chunk`` elements (B9's outputs are the 4.85 GB dense view)."""
    err = 0
    for x, y in zip(got, want, strict=True):
        if x is None and y is None:   # no parents asked for
            continue
        x, y = x.flatten(), y.flatten()
        for i in range(0, x.numel(), chunk):
            d = x[i:i + chunk].to(torch.int64) - y[i:i + chunk].to(torch.int64)
            err = max(err, int(d.abs().max()))
    return err


def _work(torch, key, args, want):
    """(bytes, operations, peak operations/s) one call needs on these
    inputs: each input byte read once, each output written once; for the
    adjacency only the rows or words the data requires, for the IN labels
    only the words whose OUT word is nonzero (B8: whose OUT entry is > 0,
    its label test), and for the edge writes only
    the touched cells or words and ecnt rows."""
    if key == "B4":    # by slot: the slots, their alive bytes, the OUT
        # rows of the pairs with both endpoints ok, the IN words under a
        # nonzero OUT word
        out_label, _, alive, src, dst = args
        _, _, sok, dok = want
        ok = sok & dok
        out_rows = out_label[src[ok].long()]
        need_in = int((out_rows != 0).sum())
        outs = sum(t.numel() * t.element_size() for t in want)
        nbytes = (2 * (4 + alive.element_size()) * src.numel()
                  + out_rows.numel() * 4 + need_in * 4 + outs)
        return nbytes, 2 * need_in, ALU_OPS_PER_S
    if key == "B8":
        out_rows, _ = args
        need_in = int((out_rows > 0).sum())
        outs = sum(t.numel() * t.element_size() for t in want)
        nbytes = out_rows.numel() * 4 + need_in * 4 + outs
        return nbytes, need_in, ALU_OPS_PER_S
    if key in EDGE_KERNELS:
        adj, _, rows, cols, _, mask = args
        fire = mask > 0
        r, c = rows[fire].long(), cols[fire].long()
        n_cols = adj.shape[1]
        cells = (r * n_cols + c // 32 if key == "B5" else r * n_cols + c)
        touched = int(torch.unique(cells).numel())
        nbytes = (4 * 4 * rows.numel() + 2 * adj.element_size() * touched
                  + 2 * 4 * int(torch.unique(r).numel()))
        return nbytes, 2 * int(fire.sum()), ALU_OPS_PER_S
    outs = sum(t.numel() * t.element_size() for t in want if t is not None)
    if key in ADJ_ARG_KERNELS and key != "B2":
        fr, adj, alive, vis = args
        fr2 = fr.reshape(-1, fr.shape[-1])
        rows = int(fr2.any(0).sum())
        row_bytes = adj.shape[1] * adj.element_size()
        nbytes = (fr.numel() + rows * row_bytes + alive.numel() + vis.numel()
                  + outs)
        if key in DENSE_KERNELS:   # a MAC per (query, active row, column)
            return (nbytes, 2 * fr2.shape[0] * rows * adj.shape[1],
                    INT8_OPS_PER_S)
        return nbytes, 2 * int(fr2.sum()) * adj.shape[1], ALU_OPS_PER_S
    fw, adj_in, alive, vis = args
    new, parent = want
    if parent is None:     # without parents: where each query's scan stops
        from repro_torch.kernels.bfs_pull_step.ref import bfs_pull_step_ref
        parent = bfs_pull_step_ref(*args, budget=WIDE_BUDGET)[1]
    w = adj_in.shape[1]
    pending = alive[None, :] & ~vis & (fw != 0).any(1)[:, None]
    need = torch.where(pending, torch.where(new, parent // 32 + 1, w), 0)
    words = int(need.amax(0).sum()) if need.numel() else 0
    nbytes = fw.numel() * 4 + words * 4 + alive.numel() + vis.numel() + outs
    # an AND and a test per query and NONZERO in-word up to where its scan
    # stops (a zero word needs no work once read)
    nz_upto = (adj_in != 0).to(torch.int32).cumsum(1)           # [R, W]
    ops = 0
    for q0 in range(0, need.shape[0], 128):
        nd = need[q0:q0 + 128].T                                 # [R, q]
        got = nz_upto.gather(1, (nd - 1).clamp(min=0).long())
        ops += 2 * int(torch.where(nd > 0, got, 0).sum())
    return nbytes, ops, ALU_OPS_PER_S


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable: {e}", file=sys.stderr)
        return 2
    rng = np.random.default_rng(args.seed)
    # the index phases draw from a stream of their own, so the other
    # phases' graphs and batches do not depend on them
    index_rng = np.random.default_rng([args.seed, 1])
    # and so do the dense engine's and the edge writes' draws
    dense_rng = np.random.default_rng([args.seed, 2])
    t_all = time.perf_counter()
    card = phase_device(torch)
    phase_analysis(card)
    phase_kernels(torch, rng, dense_rng, np.random.default_rng([args.seed, 4]),
                  np.random.default_rng([args.seed, 13]))
    phase_index_kernels(torch, index_rng)
    phase_wide_kernels(torch, np.random.default_rng([args.seed, 3]))
    phase_single_push(torch, np.random.default_rng([args.seed, 5]))
    phase_hybrid(torch, rng)
    phase_closure(torch, index_rng)
    from repro_torch.kernels.path_walk import ops as pw_ops
    from repro_torch.kernels.serial_pass import ops as sp_ops
    sp_before, pw_before = sp_ops.launches, pw_ops.launches
    st, launches, single, pairs, rounds_batches, deg_src = phase_main(
        torch, rng, ROUNDS)
    sp_main = sp_ops.launches - sp_before
    pw_main = pw_ops.launches - pw_before
    batch = rounds_batches[0]
    dlaunches, dpairs = phase_dense(torch, st, deg_src, dense_rng)
    phase_profile(torch, main_path_work(st, pairs, batch))
    index, ist, ipairs, ilaunches = phase_index(torch, st, deg_src,
                                                index_rng)
    phase_profile(torch, index_work(index, ist, ipairs))
    serve_rng = np.random.default_rng([args.seed, 6])
    slaunches, pool, undurable = phase_serving(torch, st, deg_src,
                                               serve_rng)
    phase_profile(torch, serving_work(pool, serve_rng))
    del pool
    # each kernel's launches on the path that runs it: B1-B3 the main
    # path, B6/B7 the dense engine, B4/B8 the index; no path runs B5/B9
    launches.update({k: dlaunches[k] for k in DENSE_KERNELS + EDGE_KERNELS})
    launches.update({k: ilaunches[k] for k in ("B4", "B8")})
    timer = Timer(torch)
    kernels = phase_kernel_times(torch, st, pairs, dpairs, index, ist,
                                 ipairs, launches, single["B2"], timer,
                                 dense_rng)
    kernels.append(phase_serial_pass(
        torch, np.random.default_rng([args.seed, 14]), sp_main))
    kernels.append(phase_path_walk(
        torch, np.random.default_rng([args.seed, 15]), pw_main))
    phase_inplace_apply(torch, np.random.default_rng([args.seed, 16]))
    phase_ring_push(torch, np.random.default_rng([args.seed, 17]))
    dur_launches = phase_durable(torch, st, deg_src,
                                 np.random.default_rng([args.seed, 7]), card,
                                 undurable)
    sh_launches, sh_work = phase_sharded(
        torch, st, deg_src, rounds_batches,
        np.random.default_rng([args.seed, 8]), card)
    shutil.rmtree(DURABLE_DIR)
    phase_profile(torch, sh_work)
    del sh_work
    lm_launches = phase_lm(torch, np.random.default_rng([args.seed, 9]),
                           card, args.seed)
    fam_launches = phase_lm_families(
        torch, np.random.default_rng([args.seed, 10]), card, args.seed)
    train_launches = phase_train(
        torch, np.random.default_rng([args.seed, 11]), card, args.seed)
    mesh_launches = phase_mesh(torch, card, args.seed)
    for key, k in zip(KERNEL_META, kernels):
        k["serving_launches"] = slaunches[key]
        k["durable_launches"] = dur_launches[key]
        k["sharded_launches"] = sh_launches[key]
        k["lm_serve_launches"] = lm_launches[key]
        k["lm_family_launches"] = fam_launches[key]
        k["lm_train_launches"] = train_launches[key]
        k["mesh_launches"] = mesh_launches[key]
    # the serial pass's and the path walk's launches in every phase, the
    # main path's included
    kernels[-2]["script_launches"] = sp_ops.launches - sp_before
    kernels[-1]["script_launches"] = pw_ops.launches - pw_before
    log(f"card: {card}; total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
