"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S]

Drives the port's rollout paths, its one-step prediction, its two
train-step paths and its training loop of the default model (latent 128, 10
message-passing steps) at N = 65,536 particles, k = 16, bf16 operands: the
gather rollout, the hybrid cell-block rollout that is the JAX package's main
path, and the hybrid rollout's two other re-neighboring routes (the fused
dense-query search, and the plan from neighbor ids on a spec of another
grid), each re-neighboring every step with the exactness certificate; then
the gather and the hybrid train step (batch 1, noise 3e-4, Adam, the fused
tail); then ``Trainer.fit`` on the hybrid path (epochs, validation,
checkpoints, a resume) and activation checkpointing; then the rollout's
brute-force fallback (K9 gated on the device), its cell-sorted state, and
the evaluation entry points (``validate_one_step``, ``render_rollout``'s
body); the config-4 path; then the table codes layout of the plan build and
the index-sharded train step, rollout and Trainer on a one-rank NCCL mesh;
then one halo shard's open-slab plan at config 5 and the hybrid train step
with its noise keyed per particle; then the halo paths, run by 2, 4 and 8
ranks that share the card over a gloo group; then the last entry points:
the native (C++) loader's pinned feed, and the halo Trainer and halo render
through the CLIs' own bodies.
Before that it builds every CUDA kernel from ``csrc/`` and holds each
against its plain PyTorch version at the shapes the paths give it. Phases,
each timed on its own line:

  1. device and build: the card's name and power limit, one nvcc per source
     (all started together), each build's -Xptxas -v report;
  2. K1 (cell-list k-NN), its codes mode K1' and its dual mode K1'' (ids and
     codes) against their plain versions on a uniform frame, on a frame
     with cells past capacity (spill) and on the uniform frame snapped to
     the 2^-10 lattice (many exactly equal distances: the tie order): equal
     ids and codes (the dual mode's ids also equal to the ids mode's),
     bit-equal k-th distances; certificate and brute force as the
     yardstick of exactness on the first two; all three modes again at
     k = 48 on the uniform and lattice frames; the kernels take the box as
     a host number, and each mode is timed by events and from a CUDA graph
     ("graph_ms"), with each instantiation's -Xptxas -v registers and
     spills;
  3. K5 (fused step tail) and K6 (its recompute-backward) against their
     plain versions at [65536, 128], with bf16 and with float32 aggregates;
     K6 also against autograd through the plain forward; both timed, as
     every kernel is, by events around back-to-back wrapper calls, and also
     from a CUDA graph of those calls (the device time alone, reported as
     "graph_ms"), with each agg dtype's bound, and the three (K5) and nine
     (K6) bf16 products alone by torch.matmul;
  4. K2 (particle-order codes -> S offsets and the dropped count, the slot
     gather and normalization inside), K3 (int8 S rows, with and without
     its edge count), K7 (the reverse table and its edge total, from the
     sender packs), K4 (window matmul) and K4^T (its S^T mode) against their
     plain versions at the flagship cell-block spec (K2, K3, K7 on the
     uniform, spill and lattice frames, with the transpose certificate
     reverse_mismatch == 0 from the two counts, and K2, K3, K7 timed by
     events and from a CUDA graph); K7 also on the aux spec (timed the same
     way); K4 and K4^T also on the
     aux spec's plan (grid 14, with its reverse table), each mode's rate
     (its bound's bytes over its time), its registers and spills, and S's
     share of live (32-row, 64-deep) blocks; on both specs each mode's two
     CUDA kernels (the tiled and the persistent one; cellblock.window_kernel
     picks one by shape) each against the plain version and timed in turns; K8 (the dense-query
     search) against its plain version on the dense plan's inputs of the
     uniform frame, of a frame whose search windows truncate and of the
     lattice frame, at k = 16 and (but the truncating frame) 48, on the
     live rows of the plan's mask (padding rows the no-pick lane), and the
     dense train plan (with its reverse table, K7) on the card against the
     CPU plain path on the first two;
     K8 timed by events and from a CUDA graph;
 4b. the uncertified regime: two clustered frames (95 % of the particles
     in a sigma 0.01 ball, 30 % in a sigma 0.05 ball), where the spill block
     overflows and rows run short of candidates: K1's three modes, K8, K2,
     K3 and K7 against their plain versions, the card's k-NN and plan
     (S, S_rev, overflow, dropped edges, reverse_mismatch) against the CPU
     plain path, whose certificate must be false;
  5. the gather slice: launch counts zeroed, 8 rollout steps, counts read (K1
     once and K5 ten times per step), trajectory finite, certificate true
     every step, ms per step from CUDA events after a warm-up; a 2-step
     full-width rollout at N = 8,192 against the plain path on the CPU;
  6. the hybrid slice: the same for aggregation="cellblock_hybrid" (K1',
     K2, K3 once and K4, K5 ten times per step; the certificate includes no
     column overflow and no dropped edge), its peak device memory, and the
     N = 8,192 check against the CPU plain path and the card's gather path;
  7. the hybrid dense slice: the same for cellblock_search="dense" (K8, K3
     once and K4, K5 ten times per step; the certificate also requires no
     search-window truncation and every k-th neighbor within its margin);
  8. the hybrid aux slice: the same on choose_cellblock_spec(N) (grid 14,
     the k-NN grid 19): K1'' and K3 once, K4 and K5 ten times per step;
  9. one-step prediction on the gather, hybrid (codes) and hybrid aux
     routes against the first frame of a 1-step rollout of the same window;
 10. the gather train slice: launch counts zeroed, 1 warm-up and 4 timed
     train steps, counts read (K1 once, K5 and K6 ten times per step), loss
     finite every step, ms per step from CUDA events, peak device memory;
 11. the hybrid train slice: the same (K1', K2, K3, K7 once, K4, K4^T, K5,
     K6 ten times per step; cellblock_violations 0 every step); then at
     N = 8,192 one train step of each path on the card against the CPU
     plain path (loss and every gradient), and hybrid against gather;
 12a. the Trainer slice: Trainer.fit on aggregation="cellblock_hybrid"
     (bf16, noise 3e-4, augmentation, batch 1, Adam from lr 1e-4 to 1e-5),
     3 epochs over an in-memory dataset of the port's synthetic generator
     (a training simulation of 9 snapshots: 4 windows; a validation one of
     7: 2 windows), save_every 1: launch counts zeroed before fit and read
     after (per train step K1', K2, K3, K7 once and K4, K4^T, K5, K6 ten
     times; per eval step K1', K2, K3 once and K4, K5 ten times; the
     exactness check on the first window runs the plain cell list, no
     kernel), every epoch's losses finite, cellblock_violations 0 every
     step, model_best, model_epoch_{0,1,2}, model_final and
     training_history.json with the JAX Trainer's keys; each epoch's time,
     ms per train step inside fit (CUDA events around each step) against
     phase 11's bare step, ms per step of each epoch's loop, peak memory;
 12b. resume equals continuous: a second Trainer restores model_epoch_0
     (epoch, schedule position and learning rate, generator state checked)
     and fits epochs 1-2; its model_epoch_2 params and Adam state must be
     bit-equal to the first run's, and its history equal;
 12c. remat: one train step (noise 0, no augmentation, SGD with lr 1) at
     N = 65,536 with remat, with remat_chunk=5 and with neither, on the
     hybrid bf16 path with the fused tail and on gather in f32 without it:
     loss and every gradient bit-equal to the run without remat, launches
     as the recomputation implies (K4 and K5 M, 2M and 2M + (M/c)(c-1)
     times; the rest once a step), peak memory of each;
 13a. K9 (the brute-force k-NN gated on the device) against its plain
     version at N = 65,536, k = 16 and 48, on the uniform, clustered30 and
     lattice frames and 10,000 separate queries: ids equal, d2 bit-equal; a
     set gate leaves the output buffers bit for bit, a clear one gives the
     plain version's; timed active, gated (events and CUDA graph) and plain;
 13b. exactness_guard="fallback" on gather, 4 steps at N = 65,536 (bf16,
     fused tail): on a clustered window (certificate false every step) K1,
     K9 once and K5 ten times a step, the trajectory equal to the
     brute-force rollout's (K9 once, K1 never) and unlike the flag guard's;
     on the uniform window K9 gated every step and the trajectory bit-equal
     to the flag guard's; synchronizing calls per step under CUDA's sync
     debug mode, flag against fallback (the fallback adds none); a 2-step
     N = 8,192 clustered fallback rollout against the CPU plain path;
 13c. sorted_state="on": 8 gather steps at N = 65,536 bit-equal to "off",
     at reneighbor_every 1 and 2, ms per step of each;
 13d. evaluation at N = 65,536 on an in-memory synthetic simulation:
     validate_one_step on gather and hybrid (bf16, 4 windows, exact
     launches, each error bit-equal to the MSE of a direct
     one_step_prediction), then render_rollout's body (the CLI after its
     HDF5 read) for 6 steps with --exactness_guard fallback: K1 and K9
     each step, both .npy trajectories, the summary with the JAX CLI's
     lines, finite errors, the plot or the "plotting skipped" line;
 14a. K5 and K6 at width 256 (f32 and bf16 carry) and at width 128 with a
     bf16 carry (the width-general variants) against their plain versions
     at the config-4 slot count (606,368 rows, f32 agg), with phase 3's
     tolerances (a bf16 carry's output: one more bf16 rounding); events,
     graph_ms and bounds; K6's three stages (the chain, the weight
     gradients, the fixed-order reductions) timed alone by events, each
     beside its bound, and the three dW products by torch.matmul on the
     chain's bf16 operands as a yardstick; their -Xptxas -v lines are
     phase 1's (with a per-kernel summary of registers and spills);
 14b. the config-4 variable plan at N = 500,000, k = 32 (the chooser's
     variable spec, printed) on the seed frame: K1' codes and kth, K2's
     offsets and dropped count and K7's table and total bit-equal to their
     plain versions on the card, and the plan build's S, S_rev, overflow and
     reverse_mismatch equal to the plain plan's (every step of the build in
     its plain version); K4 and K4^T at H = 256 on that plan against their
     plain versions with phase 4's tolerances; K2, K7, K4 and K4^T timed
     (events and CUDA graph); each mode's rate and share of its bytes bound,
     its two kernels timed in turns, the share of live (128-row, 64-deep)
     chunks, and its torch.bmm yardstick (S or S_rev^T as bf16 against the
     gathered windows, in chunks of 256 tiles, their times summed);
 14c. the config-4 rollout (latent = hidden = 256, 15 message-passing
     steps, bf16, k = 32, aggregation="cellblock"), variable and uniform: 1
     warm-up and 4 timed steps, exact launches (per step K1', K2, K3 once,
     K4 and K5 15 times), the certificate true on the 2 steps the JAX
     benchmark asserts (every step's printed; on a step where it is false,
     that frame's K1' codes bit-equal to their plain version and its plan's
     overflow, dropped edges and window_overflow equal to the plain plan's),
     trajectory finite, ms per
     step and peak memory; at N = 65,536 (k = 16) a 2-step slots rollout
     within 2e-4 of the hybrid rollout on the same spec, variable and
     uniform;
 14d. the config-4 train step (slots, variable, fused tail, remat_chunk=5,
     carry_dtype="bfloat16", batch 1, noise 3e-4, Adam): 1 warm-up and 2
     timed steps, losses finite, exact launches (K4 and K5 42 times a step
     under the recomputation), cellblock_violations of a noise-free step
     equal to the plain plan's count on its frame, ms per step and peak
     memory; at N = 8,192 one step (noise 0, SGD lr 1) on the card against
     the CPU plain path: loss within 1e-3, each gradient leaf within 5e-2;
 15a. the table codes layout, on the flagship frame (N = 65,536, k = 16), on
     phase 4b's clustered30 frame (the spill block in use) and on the
     config-4 variable spec's seed frame (N = 500,000, k = 32): K1''s
     cell-table output bit-equal to knn_codes_reference on the same table,
     every used spill slot's picks equal to the particle layout's codes of
     its particle and every particle's table row to its particle-layout
     codes; K2 on table rows (and the spill picks) bit-equal to its plain
     version and to K2 on the particle-order codes (offsets and dropped
     edges); the table route's plan S equal to the particle route's and to
     the plain plan's, with exact launches; the device ms of each route's
     plan build (K1' with its wrapper, then K2) from a CUDA graph, and K2 on
     table rows timed with its bound;
 15b. the index-sharded paths at world size 1 over an NCCL process group
     (file rendezvous, make_mesh((1, 1)) on the card, every group NCCL): the
     data-parallel train step of the default model (bf16, fused tail, N =
     65,536, k = 16), noise 0 and no augmentation, equal to make_train_step
     on the same batch (loss and every parameter after one Adam step within
     1e-6); at the flagship training row (noise 3e-4, augmentation) 1
     warm-up and 4 timed steps of the sharded and the bare step, losses
     finite, exact launches (K1 once, K5 and K6 ten times a step) and
     collectives (11 all-gathers, 14 all-reduces a step); an 8-step
     make_sharded_rollout within 2e-4 of rollout(aggregation="gather")
     (K5 80 launches, 88 all-gathers), ms a step of each; Trainer(mesh=...)
     for 2 steps and a validation pass equal to Trainer()'s (noise 0);
 16a. one config-5 halo shard's plan (BASELINE config 5: N = 2,000,000
     over 8 shards, k = 16; choose_halo_config gives G = 56, 7 slab layers,
     one halo layer; choose_cellblock_spec_halo an open slab of gx = 9
     x-layers, 387,072 slots): a seeded frame made as bench_config4's, the
     port's partition_windows, and for shards 0 (its left halo wraps across
     x = 0) and 3 the candidate set [own; halo_left; halo_right] built on
     the host as the exchange builds it (parallel.halo.shard_candidates);
     the masked cell list (the owned rows querying the valid candidates);
     then build_cellblock(valid=..., with_reverse=True) in the slab's local
     x frame over a per-dimension box and the hybrid aggregation's forward
     and backward at H = 128 (bf16 carry), launch counts zeroed before and
     read after (K3, K7, K4, K4^T once each); overflow, dropped edges and
     reverse_mismatch 0; K3 and K7 bit-equal to their plain versions (S,
     S_rev, totals), K4 and K4^T within phase 4's tolerances, the
     aggregation at the owned rows (through the inverse order) within them
     of the gather-sum over the neighbor ids; on shard 0 each kernel timed
     by events and from a CUDA graph with its bound and its plain version's
     time, K4's and K4^T's two kernels timed in turns, and the plan
     build's time and peak memory;
 16b. phase 11's hybrid train step with partition_invariant_noise=True
     (the noise keyed by each particle's global id): 1 warm-up and 4 timed
     steps, exact launches, cellblock_violations 0, ms per step against
     phase 11's and against the stream keying timed in turns here (stream,
     gid, gid, stream); the sample with its particles and ids permuted gives the
     same loss and gradients within the N = 8,192 check's tolerances; the
     keying's hash bits on the card equal the CPU's and its normals within
     GID_NORMAL_ULPS;
 17. the halo paths: 4 ranks for 17a and 17b, then C5_SHARDS for 17c,
     spawned by parallel.local_ranks (torch.multiprocessing, a file store;
     the kernels built before the spawn, so no rank runs nvcc), every rank
     on cuda:0 over an explicitly requested gloo group (printed), the
     exchanges staged through pinned host buffers; 17a at P = 2 runs on
     the first 2 ranks while the others wait; a rank that raises, dies or
     times out (60 s a collective) fails the phase;
 17a. P = 2 (both ring neighbours one rank) and 4, the flagship window and
     the default model: 4 steps of the halo gather rollout (float32) within
     HALO_GATHER_TOL of the single-device gather rollout and of the halo x
     cell-block hybrid rollout (bf16, fused tail) within HALO_HYBRID_TOL of
     the single-device hybrid rollout; the certificate true every step,
     migration overflow and stranded 0, the particle count conserved, some
     of rank 0's particles moved to another slab; exact launches (gather:
     none; hybrid: K3 once, K4 and K5 ten times a step) and collectives
     (24 permutes and one gather a step) on every rank; host-staged bytes
     and ms a step per rank;
 17b. P = 4, the flagship training row (bf16, noise keyed per particle, no
     augmentation: the halo step augments on the host): the halo x
     cell-block train step with reverse plans, one SGD step (lr 1) with its
     loss and gradients within the N = 8,192 check's tolerances of the
     single-device hybrid step's and equal on every rank; exact launches
     (K3, K7 once, K4, K4^T, K5, K6 ten times) and collectives (42 permutes,
     3 all-reduces); ms of a second step and peak memory per rank; the halo
     eval step's per-sample metrics against the single-device eval step's;
 17c. config 5 (C5_N over C5_SHARDS ranks, k = 16, phase 16a's halo
     geometry, the slab spec at query block C5_HALO_QB; the data made and
     partitioned once in the parent while the ranks start): every rank's
     featurize_halo plan of the first frame (with its reverse table) with no
     overflow or dropped edge and its exchanged candidates bit-equal to the
     host mirror; S and S_rev of rank 0's plan bit-equal to K3's and K7's
     plain versions, K4 and K4^T on it within phase 16a's tolerances; 2 halo
     x cell-block rollout steps (bf16, fused tail: every certificate
     component 0 every step, so the certificate holds; outputs finite,
     count conserved); one train step (the training row, remat_chunk 5,
     loss finite); the parent's memory on the card before the spawn; per
     rank ms a rollout and train step (the rollout's featurize_halo and
     model spans per step, CUDA events), permutes and host-staged bytes,
     the permutes' device span and peak memory;
 18a. the native loader (``data/native_loader.py``) on the card's host: the
     repository's ``csrc/window_loader.cpp`` built by g++ (its time
     printed), ``.cgnn`` caches written by ``write_cache`` from phase 12's
     two simulations (no h5py), ``NativeSequenceLoader(pin_memory=True)``
     batches bit-equal to the in-memory dataset's with shuffle off, on (the
     same seed) and with the extras and a tail batch, every buffer pinned;
     phase 12's first epoch fitted again from the native feed, its
     model_epoch_0 params and Adam state bit-equal to phase 12's; ms per
     batch on the host for each feed, ms per train step inside fit for each
     feed, and the synchronizing calls of one train step (CUDA's sync debug
     mode) from the pinned feed and from the pageable one, counted;
 18b. ENTRY_WORLD ranks (as phase 17's: spawned, an explicitly requested
     gloo group on cuda:0, the kernels and the loader built before the
     spawn) each call cli.train's body (``train``) on 18a's native feed
     with ``--spatial_shards 4 --dist_backend gloo --device cuda:0``: the
     default model, k = 16, bf16, noise TRAIN_NOISE (keyed per particle,
     as every halo step keys it), no augmentation, 2 epochs of batch 1,
     every epoch saved. Losses finite; the params after the last step and
     the history equal on every rank; rank 0 alone writes model_best,
     model_epoch_{0,1}, model_final and training_history.json (the JAX
     Trainer's keys); every train step's launches (K5 and K6 ten times
     each) and collectives (42 permutes, 3 all-reduces) exact on every
     rank; a second call with ``--resume`` of model_epoch_0 fits epoch 1,
     its model_epoch_1 params, Adam state and generator bit-equal to the
     continuous run's; epoch 0's per-step losses against a single-device
     Trainer(partition_invariant_noise=True) on the same feed (made while
     the ranks start): the first within ENTRY_FIRST_LOSS_RTOL, the epoch's
     within ENTRY_EPOCH_LOSS_RTOL; per rank ms per train step inside fit,
     host-staged bytes a step, peak memory;
 18c. the same ranks call cli.render_rollout's body (``render``) with
     ``--spatial_shards 2`` (mesh (2, 2)) and 4 (mesh (1, 4)) on the
     flagship seed window, 4 steps: positions and errors within
     HALO_GATHER_TOL of the single-device render, the certificate held and
     no migration overflow or stranded particle (no warning printed), rank
     0 alone writes the JAX CLI's artifacts; ms a step per rank;
 12. one JSON line of every ported kernel: launches on its path, time, bound,
     plain version's time, library yardstick's time.

The last line is the contract line ``{"ok": true, "device": {...}}``. Any
failed check raises before it, so the exit code is then not 0. Without a
CUDA device the script exits non-zero at once and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import datetime
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense), for the bounds.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_TENSOR_FLOP_PER_S = 989e12

N, K, WINDOW, STEPS = 65536, 16, 5, 8
# One-step prediction against a 1-step rollout: the same operations.
ONE_STEP_TOL = 1e-6
K5_MAX_ABS_TOL, K5_MEAN_ABS_TOL = 5e-2, 2e-3
# K4: exact products (int8 counts x bf16), float32 sums in another order.
K4_MAX_ABS_TOL, K4_MEAN_ABS_TOL = 1e-3, 1e-5
SMALL_N, SMALL_STEPS, SMALL_COORD_TOL = 8192, 2, 2e-4
K1_WIDE_K = 48
# K6: the plain version rounds operands to bf16 where the kernel does; sums
# run in another order, and a last-bit difference can flip a ReLU mask at a
# pre-activation within rounding of 0, which moves that entry of dagg by
# O(1). Per output: at most 1e-5 of its entries off by more than REL of its
# largest magnitude, mean error within MEAN of its mean magnitude. Against
# autograd through the plain forward (bf16 roundings of the gradients at
# other places) the looser pair.
K6_REL, K6_MEAN = 1e-2, 1e-3
K6_AUTOGRAD_REL, K6_AUTOGRAD_MEAN = 3e-2, 1e-2
TRAIN_STEPS, TRAIN_NOISE = 4, 3e-4
# The N = 8,192 train-step check: each gradient leaf within TOL of its
# largest magnitude (bf16 operands through 10 message-passing steps; on the
# CPU the hybrid and gather gradients differ by at most 2.0e-2, the gather
# path rounding each aggregate to bf16), the loss within 1e-3 relative.
TRAIN_GRAD_TOL, TRAIN_LOSS_RTOL = 5e-2, 1e-3
# The Trainer slice: a training simulation of 9 snapshots (4 windows) and a
# validation one of 7 (2 windows), 3 epochs, the learning rate 1e-4 -> 1e-5.
FIT_TRAIN_SNAPSHOTS, FIT_VAL_SNAPSHOTS, FIT_EPOCHS = 9, 7, 3
# The keys of the JAX Trainer's training_history.json.
HISTORY_KEYS = ["best_epoch", "best_val_loss", "component_losses", "learning_rates",
                "train_loss", "val_loss"]
COMPONENT_KEYS = ["acc_train", "acc_val", "momentum_train", "momentum_val",
                  "temp_rate_train", "temp_rate_val"]
# Remat: the recomputed forward runs the same kernels on the same inputs, so
# the loss and every gradient leaf must be bit-equal to the run without it.
REMAT_GRAD_TOL = 0.0
# K9's separate-query frame; the fallback's steps at N; the fallback's
# trajectory against the brute-force rollout's: both run K9's ids through
# the same operations, so 0 is expected, and the JAX test's 1e-6 allowed.
BRUTE_QUERIES, FALLBACK_STEPS, FALLBACK_TOL = 10000, 4, 1e-6
# Evaluation: an in-memory synthetic simulation of 12 snapshots (6 start
# indices), 4 one-step windows, a 6-step render.
EVAL_SNAPSHOTS, EVAL_WINDOWS, RENDER_STEPS = 12, 4, 6
# Config 4 (the JAX package's BASELINE config 4, benchmarks/bench_config4.py):
# N = 500,000, k = 32, latent = hidden = 256, 15 message-passing steps.
C4_N, C4_K, C4_WIDTH, C4_MP = 500000, 32, 256, 15
C4_ROLLOUT_STEPS, C4_TRAIN_STEPS, C4_REMAT_CHUNK = 4, 2, 5
C4_BMM_TILES = 256  # tiles a chunk of the config-4 bmm yardstick (~0.85 GB of operands)
# The steps from the seed window whose certificate the JAX benchmark asserts
# (bench_config4.py:97-100: a 2-step rollout). Later steps of the random-
# weight dynamics can drop an edge in the variable spec, whose windows (W 384
# at QB 224, the TPU-tuned chooser's) are tighter than the uniform spec's (QB
# 192): the certificate flags it, and the script prints each step's.
C4_CERTIFIED_STEPS = 2
# A bf16 carry's output is rounded to bf16 on both sides from f32 values
# that differ in the last bits: one bf16 ulp at |v| in [4, 8) is 2^-5.
K5_BF16_MAX_ABS_TOL, K5_BF16_MEAN_ABS_TOL = 1e-1, 4e-3
# At width 256 twice the terms meet each ReLU and more masks flip than at
# 128 (1.2e-5 of dagg's entries at 65,536 rows in the cuda tests): the
# share of K6's entries allowed off.
K6_WIDE_OFF_SHARE = 5e-5
C4_SLOTS_TOL = 2e-4  # slots against hybrid (JAX tests/test_cellblock_rollout.py)
# The sharded paths at world size 1: the step, Trainer(mesh) and their
# single-device counterparts (the same search, the same sorted-edge backward;
# the collectives of one rank copy) within 1e-6.
SHARDED_TOL = 1e-6
# Config 5 (BASELINE.md: N = 2,000,000 over 8 halo shards, k = 16): one
# shard's slab plan, shard 0 (its left halo wraps across x = 0) and shard 3;
# the aggregation at latent 128 (the default model's).
C5_N, C5_K, C5_SHARDS, C5_CHECK_SHARDS, C5_H = 2_000_000, 16, 8, (0, 3), 128
# The gid-keyed noise's normals on the card against the CPU's: Box-Muller
# through log, sqrt and cos, each within 1-2 ulps on either side.
GID_NORMAL_ULPS = 16
# Phase 17, the halo paths: P ranks share the card over a gloo group. 17a's
# rollouts (4 steps at N, both rings) against the single-device rollouts:
# gather in float32 within the JAX halo test's 2e-5 (the neighbor sets are
# equal, their order and so the sums' differ), the hybrid in bf16 within the
# flagship's 2e-4. A hung collective raises after HALO_TIMEOUT_S; a phase
# whose ranks have not all answered by HALO_RANK_TIMEOUT_S fails.
HALO_SHARDS, HALO_STEPS = (2, 4), 4
HALO_GATHER_TOL, HALO_HYBRID_TOL = 2e-5, 2e-4
HALO_TIMEOUT_S, HALO_RANK_TIMEOUT_S = 60, 300
# 17c: config 5 over C5_SHARDS ranks (phase 16a's halo geometry: grid 56,
# one halo layer; two for the noised train step), 2 rollout steps and one
# train step, its model checkpointed in chunks of 5 steps (config 4's). The
# slab plans take the chooser's spec at query block C5_HALO_QB (its
# query_block argument): window 256 then spans a tile's mean need (QB plus
# three mean cells, 162 rows) with 94 rows to spare, about 6 sigma after
# the 16-row floor of the window starts. The chooser's own pick (QB 256, W
# 384, phase 16a's) spares the same 94 rows over a need of 290, about 4.6
# sigma, across the 8 shards' 108,864 windows, and dropped an edge on this
# seeded first frame. Every certificate component is held to 0.
C5_HALO_STEPS, C5_REMAT_CHUNK, C5_HALO_QB = 2, 5, 128
# Phase 18, the entry points: 18b and 18c on ENTRY_WORLD ranks that share
# the card; 18c renders at each of ENTRY_RENDER_SHARDS. 18b's halo fit
# against the single-device fit with the noise keyed per particle: the first
# step within phase 17b's 1e-4 relative (the same step, sums in another
# order); the epoch's steps within 1e-3 relative (after Adam's first
# updates, bf16 products of parameters a few ulps apart).
ENTRY_WORLD, ENTRY_RENDER_SHARDS = 4, (2, 4)
ENTRY_FIRST_LOSS_RTOL, ENTRY_EPOCH_LOSS_RTOL = 1e-4, 1e-3

METADATA = {
    "temp_mean": 1.0, "temp_std": 0.3, "temp_rate_mean": 0.0,
    "temp_rate_std": 0.02, "vel_mean": 0.0, "vel_std": 0.06,
    "acc_mean": 0.0, "acc_std": 0.2, "box_size": 1.0, "dt": 0.05,
}
PORT_PACKAGE = "cosmology_gnn_simulation_tpu_torch"
SOURCE_DIR = f"{PORT_PACKAGE}/csrc"
# The JAX package (the port's name less "_torch") is named here only as the
# path of the TPU kernels the CUDA kernels replace; nothing of it is imported.
TPU_OPS = f"{PORT_PACKAGE.removesuffix('_torch')}/ops"


def fail(msg: str):
    raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, reps: int) -> float:
    """Mean device ms per call over ``reps`` calls after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device ms per call of ``fn``'s launches, replayed from a CUDA
    graph of ``reps`` calls (after a warm-up on a side stream): the kernel's
    time without the host's cost of each Python call, which exceeds the
    kernel's where the kernel is short."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def print_ptxas(logs, name):
    """Each kernel instantiation's registers and spills from ``name``'s
    -Xptxas -v log, by its template arguments (the mangled name's
    ``ILi1ELi0EE`` is <1, 0>). ptxas reports a kernel's stack and spills,
    then its registers, after the line that names it."""
    log = logs.get(name)
    if log is None:
        print(f"{name} -Xptxas -v: library already built, no log")
        return
    rows = []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            func = line.split("'")[1]
            args = re.search(r"I((?:L[a-z]+\d+E)+)EE", func)
            label = (f"<{', '.join(re.findall(r'L[a-z]+(\d+)E', args.group(1)))}>"
                     if args else func)
            rows.append([label, "", ""])
        elif rows and "registers" in line:
            rows[-1][1] = line.split(": ", 1)[-1].strip()
        elif rows and "spill" in line:
            rows[-1][2] = line.strip()
    print(f"{name} -Xptxas -v per kernel:")
    for label, regs, spills in rows:
        print(f"  {label}: {regs} | {spills}")


def kernel_entry(source, replaces, max_abs_err, ms, plain_ms, nbytes, ops, op_rate,
                 library_ms):
    """One kernel's report: its bound is the larger of its bytes over the
    memory rate and its operations over the peak rate for their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / op_rate
    return dict(route="cuda", source=f"{SOURCE_DIR}/{source}", replaces=f"{TPU_OPS}/{replaces}",
                max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=library_ms)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def window_kernels(label, table, pad, starts, spec, transpose, reps):
    """Both CUDA kernels of window_matmul.cu (``cellblock.WINDOW_KERNELS``:
    PR 8's tiled one and the persistent one) on one K4 (or, with
    ``transpose``, K4^T) shape: each held against the plain version with
    phase 4's tolerances, then timed by events in turns (tiled, persistent,
    persistent, tiled), through ``cellblock.window_matmul_launch`` (outside
    the wrappers: no launch is counted). Prints one line; returns
    {kernel: [ms, ms]} and the kernel ``window_kernel`` picks for the
    shape."""
    from cosmology_gnn_simulation_tpu_torch.ops import cellblock

    ref = (cellblock.window_matmul_t_reference if transpose
           else cellblock.window_matmul_reference)(table, pad, starts, spec=spec)
    times = {}
    for kernel in cellblock.WINDOW_KERNELS:
        err = (cellblock.window_matmul_launch(table, pad, starts, spec=spec,
                                              transpose=transpose, kernel=kernel) - ref).abs()
        if not (float(err.max()) <= K4_MAX_ABS_TOL and float(err.mean()) <= K4_MEAN_ABS_TOL):
            fail(f"{label} {kernel} kernel: max abs err {float(err.max())}, mean "
                 f"{float(err.mean())}")
        del err
    del ref
    for kernel in (*cellblock.WINDOW_KERNELS, *reversed(cellblock.WINDOW_KERNELS)):
        times.setdefault(kernel, []).append(time_ms(lambda: cellblock.window_matmul_launch(
            table, pad, starts, spec=spec, transpose=transpose, kernel=kernel), reps))
    picked = cellblock.window_kernel(pad.shape[1], spec.window)
    print(f"{label} kernels (QB {spec.query_block}, W {spec.window}, H {pad.shape[1]}), ms in "
          f"turns: " + ", ".join(f"{k} {', '.join(f'{t:.4f}' for t in v)}"
                                 for k, v in times.items()) + f"; the shape rule takes {picked}")
    return times, picked


def window_bmm_ms(table, pad, starts, spec, transpose, tiles):
    """The library yardstick of K4 (or K4^T) on one plan: torch.bmm of S
    (S_rev^T) as bf16 [T, QB, 9W] against the tiles' gathered windows [T,
    9W, H] (bf16 out), in chunks of ``tiles`` tiles whose times (events) are
    summed; the casts and the gather are not timed."""
    t_all, qb = spec.num_tiles, spec.query_block
    lanes = torch.arange(spec.window, device=pad.device)
    total = 0.0
    for t0 in range(0, t_all, tiles):
        t1 = min(t0 + tiles, t_all)
        if transpose:
            s_b = table[t0:t1, :, :qb].transpose(1, 2).to(torch.bfloat16).contiguous()
        else:
            s_b = table.view(t_all, qb, -1)[t0:t1].to(torch.bfloat16)
        windows = pad[(starts[t0:t1].long()[:, :, None] + lanes).reshape(t1 - t0, -1)]
        total += time_ms(lambda: torch.bmm(s_b, windows), 3)
        del s_b, windows
    return total


def live_chunks(table, spec, transpose):
    """The share of the persistent window kernel's units of work, a 128-row
    (K4) or 128-lane (K4^T) slice of a tile x a 64-deep chunk of its S row,
    that hold a count: the chunks whose window it loads (9W a multiple of
    64)."""
    t, qb = spec.num_tiles, spec.query_block
    if transpose:  # [T, chunks, lanes] -> [T, QB, chunks]
        nz = (table.view(t, spec.s_width // 64, 64, -1) != 0).any(2)[:, :, :qb].transpose(1, 2)
    else:
        nz = (table.view(t, qb, spec.s_width // 64, 64) != 0).any(3)
    slices = -(-qb // 128)
    nz = torch.nn.functional.pad(nz.to(torch.uint8), (0, 0, 0, 128 * slices - qb))
    return float(nz.view(t, slices, 128, -1).amax(2).float().mean())


def k6_wide_stages(x, agg, g, node, w_bytes, fused_step_mod):
    """The width-general K6's three stages timed alone by CUDA events, through
    the library's stage entry points on one scratch (launches outside the
    wrapper: not counted): the chain (the weights' bf16 conversion, the
    recomputed forward and the backward chain), the weight-gradient
    products and the fixed-order reductions, each with its bound; and, as a
    yardstick only, the three dW products by torch.matmul on the chain's
    bf16 operands with an f32 output (``torch.mm(..., out_dtype=)`` where
    this PyTorch has it, else a bf16 output, named so)."""
    from cosmology_gnn_simulation_tpu_torch import kernels

    rows, width = x.shape
    dev = x.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = fused_step_mod._lib("fused_tail_wide_bwd")
    x_bf16, agg_bf16 = int(x.dtype == torch.bfloat16), int(agg.dtype == torch.bfloat16)
    lay = fused_step_mod.wide_bwd_layout(lib, rows, width, x_bf16, sms)
    scratch = torch.empty(lay["total"], dtype=torch.uint8, device=dev)
    grads = torch.empty(3 * width * width + 5 * width, dtype=torch.float32, device=dev)
    dx, dagg = torch.empty_like(x), torch.empty_like(agg)
    flat = fused_step_mod._flatten(node, width)
    p, stream, total = kernels.ptr, kernels.stream_handle(dev), lay["total"]

    def run(name, err):
        if err != 0:
            fail(f"K6 wide stage {name}: cudaError {err}")

    stages = {
        "chain": lambda: run("chain", lib.fused_tail_wide_bwd_chain_launch(
            p(x), p(agg), p(g), x_bf16, agg_bf16, width, *[p(w) for w in flat[:-1]], p(dx),
            p(dagg), p(scratch), total, sms, rows, stream)),
        "dw": lambda: run("dw", lib.fused_tail_wide_bwd_dw_launch(
            p(x), x_bf16, width, p(scratch), total, sms, rows, stream)),
        "reduce": lambda: run("reduce", lib.fused_tail_wide_bwd_reduce_launch(
            x_bf16, width, p(scratch), total, sms, p(grads), rows, stream)),
    }
    eb, ab = x.element_size(), agg.element_size()
    nops = 5 if x_bf16 else 6
    wg, vg = 3 * width * width, 5 * width
    chain_part = lay["chain_blocks"] * vg * 4
    w_part = lay["splits"] * wg * 4
    # Bytes: each input read once, each output written once; operations: the
    # products' (f32 additions for the reductions).
    cost = {
        "chain": (rows * width * (3 * eb + 2 * ab + nops * 2) + w_bytes + wg * 2 + chain_part,
                  6 * 2 * rows * width * width, BF16_TENSOR_FLOP_PER_S),
        "dw": (6 * rows * width * 2 + w_part, 3 * 2 * rows * width * width,
               BF16_TENSOR_FLOP_PER_S),
        "reduce": (w_part + chain_part + (wg + vg) * 4,
                   (lay["splits"] - 1) * wg + (lay["chain_blocks"] - 1) * vg, F32_FLOP_PER_S),
    }
    out = {}
    for name, fn in stages.items():  # in order: each stage reads the one before
        ms = time_ms(fn, 10)
        nb, ops, rate = cost[name]
        t_bytes, t_ops = nb / HBM_BYTES_PER_S, ops / rate
        out[name] = dict(ms=ms, bound_ms=max(t_bytes, t_ops) * 1e3,
                         bound_by="bytes" if t_bytes >= t_ops else "operations")
    torch.cuda.synchronize()
    arrays = scratch[lay["ops"]:lay["ops"] + nops * rows * width * 2].view(torch.bfloat16)
    arrays = arrays.view(nops, rows, width)
    a_ops = [x if x_bf16 else arrays[5], arrays[0], arrays[1]]  # x, h0, h1
    b_ops = [arrays[4], arrays[3], arrays[2]]                    # dpre0, dpre1, dy
    try:
        torch.mm(a_ops[0][:16].t(), b_ops[0][:16], out_dtype=torch.float32)
        name, mm = "torch.mm(bf16, bf16, out_dtype=float32)", (
            lambda a, b: torch.mm(a.t(), b, out_dtype=torch.float32))
    except (TypeError, RuntimeError):
        name, mm = "torch.matmul(bf16, bf16) (bf16 output)", lambda a, b: torch.matmul(a.t(), b)
    out["yardstick"] = name
    out["yardstick_ms"] = time_ms(lambda: [mm(a, b) for a, b in zip(a_ops, b_ops)], 5)
    mine = grads[:wg].view(3, width, width)
    rel = max(float((mine[i] - mm(a, b).float()).abs().max()) / float(mine[i].abs().max())
              for i, (a, b) in enumerate(zip(a_ops, b_ops)))
    out["yardstick_max_rel"] = rel
    return out


# The uncertified regime's clustered frames: (label, share of the particles
# in a normal ball about the box centre, the ball's sigma). They and
# clustered_frame must stay the frames of tests/test_torch_knn_select_schedule.py
# (CLUSTERED, clustered_positions: seed 21, this script's --seed 0 + 21), which
# the CPU tests hold against the JAX package.
CLUSTERED = (("clustered95", 0.95, 0.01), ("clustered30", 0.30, 0.05))


def clustered_frame(n: int, share: float, sigma: float, seed: int):
    """A share of the particles in a normal ball of width sigma about the
    box centre, the rest uniform (the frames of the port's tests)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1, (n, 3))
    m = int(share * n)
    pos[:m] = 0.5 + sigma * rng.standard_normal((m, 3))
    return np.remainder(pos, 1.0).astype(np.float32)


def clustered_window(n: int, seed: int):
    """seed_window's drift and temperatures about the clustered30 frame (30 %
    of the particles in a sigma 0.05 ball), where the certificate fails."""
    rng = np.random.default_rng(seed)
    base = clustered_frame(n, 0.30, 0.05, seed)[None]
    drift = rng.normal(0, 5e-4, (WINDOW, n, 3)).cumsum(axis=0)
    pos = np.remainder(base + drift, 1.0).astype(np.float32)
    temp = np.abs(rng.normal(1.0, 0.3, (WINDOW, n, 1))).astype(np.float32)
    return pos, temp


def seed_window(n: int, seed: int):
    """bench.py's seed frames: uniform base + a small random-walk drift."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (1, n, 3))
    drift = rng.normal(0, 5e-4, (WINDOW, n, 3)).cumsum(axis=0)
    pos = np.remainder(base + drift, 1.0).astype(np.float32)
    temp = np.abs(rng.normal(1.0, 0.3, (WINDOW, n, 1))).astype(np.float32)
    return pos, temp


def train_batch(n: int, seed: int):
    """A batch of one: seed_window's positions over WINDOW + 1 frames (the
    last is the target) and slowly drifting temperatures."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (1, n, 3))
    drift = rng.normal(0, 5e-4, (WINDOW + 1, n, 3)).cumsum(axis=0)
    pos = np.remainder(base + drift, 1.0).astype(np.float32)
    temp = (1.0 + rng.normal(0, 1e-3, (WINDOW + 1, n, 1)).cumsum(axis=0)).astype(np.float32)
    return {"positions": pos[None, :WINDOW], "temperatures": temp[None, :WINDOW],
            "target_positions": pos[None, WINDOW], "target_temperatures": temp[None, WINDOW]}


class MemoryDataset:
    """``SequenceDataset.batches``' contract over simulations held in memory
    (the windows and the shuffle of the port's ``data/dataset.py``; with
    ``include_extras`` every other field of the simulations, by name)."""

    CORE = {"positions": "Coordinates", "temperatures": "InternalEnergy"}

    def __init__(self, sims):
        self.sims = sims
        self.per_sim = sims[0]["Coordinates"].shape[0] - WINDOW
        self.extras = sorted(name for name, value in sims[0].items()
                             if np.ndim(value) > 0 and name not in self.CORE.values())

    def __len__(self):
        return len(self.sims) * self.per_sim

    def batches(self, batch_size, *, shuffle=True, seed=0, drop_remainder=True,
                include_extras=False):
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for i in range(0, len(order), batch_size):
            chunk = order[i:i + batch_size]
            if drop_remainder and len(chunk) < batch_size:
                break
            spans = [(self.sims[j // self.per_sim], j % self.per_sim) for j in chunk]

            def stack(name, target):
                return np.stack([sim[name][start + WINDOW] if target
                                 else sim[name][start:start + WINDOW] for sim, start in spans])

            batch = {}
            for key, name in self.CORE.items():
                batch[key] = stack(name, False)
                batch[f"target_{key}"] = stack(name, True)
            if include_extras:
                batch["extra_inputs"] = {name: stack(name, False) for name in self.extras}
                batch["extra_targets"] = {name: stack(name, True) for name in self.extras}
            yield batch


def mostly_close(a, b, rel, mean_rel):
    """(ok, max abs error): at most 1e-5 of the entries off by more than
    ``rel`` of b's largest magnitude, mean error within ``mean_rel`` of b's
    mean magnitude."""
    a, b = a.detach().float(), b.detach().float()
    err = (a - b).abs()
    off = int((err > rel * float(b.abs().max())).sum())
    ok = off <= 1e-5 * b.numel() and float(err.mean()) <= mean_rel * float(b.abs().mean())
    return ok, float(err.max())


def slab_kernel_checks(local_t, box_t, valid_t, nbr, spec, gen, label, plan=None):
    """K3, K7, K4 and K4^T against their plain versions on one halo slab
    plan's inputs (the candidates in the local frame, the per-dimension
    box, the validity mask, the neighbor lists with the halo rows'
    sentinels): S, S_rev and their counts bit-equal (and equal to
    ``plan``'s tables where given), K4 and K4^T within phase 4's tolerances
    at width C5_H. Returns the plan's inputs and the kernels' tables."""
    from cosmology_gnn_simulation_tpu_torch.ops import cellblock

    dev, width = local_t.device, spec.s_width
    layout = cellblock.cellblock_layout(local_t, box_t, spec, valid_t)
    senders = cellblock.aux_slot_senders(layout, nbr, spec)
    offsets, _ = cellblock.aux_offsets(senders, layout, spec)
    packs = (senders // spec.grid_size).to(torch.int32)
    del senders
    s_table, s_total = cellblock.s_onehot(offsets, width=width, with_total=True)
    ref_s = cellblock.s_onehot_reference(offsets, width=width)
    if not (torch.equal(s_table, ref_s) and (plan is None or torch.equal(plan.s_table, ref_s))
            and int(s_total) == int(ref_s.sum(dtype=torch.int64))):
        fail(f"K3 {label}: S or its count differs from the plain version")
    del ref_s
    s_rev, rev_total = cellblock.reverse_table(packs, layout, spec)
    ref_rev = cellblock.reverse_table_reference(
        cellblock.reverse_candidates(packs, layout, spec), layout.window_starts,
        layout.tile_pack_base, layout.window_lims, spec=spec)
    if not (torch.equal(s_rev, ref_rev)
            and (plan is None or torch.equal(plan.s_rev_table, ref_rev))
            and int(rev_total) == int(ref_rev.sum(dtype=torch.int64)) == int(s_total)):
        fail(f"K7 {label}: S_rev or its total ({int(rev_total)}) differs from the plain "
             f"version's or from S's count ({int(s_total)})")
    del ref_rev
    z_pad = torch.randn(spec.num_padded, C5_H, generator=gen).bfloat16().to(dev)
    errs = {}
    for name, fn, ref_fn, table in (
            ("K4", cellblock.window_matmul, cellblock.window_matmul_reference, s_table),
            ("K4^T", cellblock.window_matmul_t, cellblock.window_matmul_t_reference, s_rev)):
        out = fn(table, z_pad, layout.window_starts, spec=spec)
        err = (out - ref_fn(table, z_pad, layout.window_starts, spec=spec)).abs()
        errs[name] = float(err.max())
        if not (errs[name] <= K4_MAX_ABS_TOL and float(err.mean()) <= K4_MEAN_ABS_TOL):
            fail(f"{name} {label}: max abs err {errs[name]}, mean {float(err.mean())}")
        del out, err
    return dict(layout=layout, offsets=offsets, packs=packs, s_table=s_table, s_total=s_total,
                s_rev=s_rev, z_pad=z_pad, errs=errs)


def config4_phases(args, dev, report, path_launches, zero):
    """Phases 14a-14d (the config-4 path; see the module docstring)."""
    from cosmology_gnn_simulation_tpu_torch import kernels
    from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
        default_model_config,
        init_encode_process_decode,
        step_params,
    )
    from cosmology_gnn_simulation_tpu_torch.ops import cellblock, pallas_knn
    from cosmology_gnn_simulation_tpu_torch.ops import fused_step as fused_step_mod
    from cosmology_gnn_simulation_tpu_torch.ops.cell_list import choose_cell_grid, f32
    from cosmology_gnn_simulation_tpu_torch.ops.fused_step import (
        fused_step_tail,
        fused_step_tail_bwd,
        fused_step_tail_bwd_reference,
        fused_step_tail_reference,
    )
    from cosmology_gnn_simulation_tpu_torch.rollout import rollout
    from cosmology_gnn_simulation_tpu_torch.training import (
        TrainConfig,
        make_optimizer,
        make_train_step,
    )
    from cosmology_gnn_simulation_tpu_torch.training.trainer import Optimizer
    from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats, tree_leaves

    c4_spec = cellblock.choose_cellblock_spec(C4_N, C4_K, variable=True)
    c4_uniform = cellblock.choose_cellblock_spec(C4_N, C4_K)
    rows = c4_spec.num_slots
    grid = choose_cell_grid(C4_N, C4_K)
    cap = pallas_knn.codes_packing_cap(C4_N, C4_K, grid)

    def check_k1_codes(frame, label):
        """K1' (codes, k = 32) on ``frame`` bit-equal to its plain version."""
        tcap, _, spill_cap = pallas_knn.spill_layout(C4_N, C4_K, grid)
        g = grid.grid_size
        t = pallas_knn.build_table(frame, g, tcap, f32(1.0, dev))
        planes = (t.x, t.y, t.z, t.ids)
        spill = pallas_knn.build_spill(frame, t.particle_rank, tcap, spill_cap)
        args_ = dict(k=C4_K, n=C4_N, g=g, box=1.0,
                     mi_start=pallas_knn.min_image_start(tcap, spill_cap))
        codes_, kth = pallas_knn.knn_codes(planes, spill, **args_)
        ref_codes, ref_kth = pallas_knn.knn_codes_reference(
            planes, spill, **{**args_, "box": f32(1.0, dev)})
        if not (torch.equal(codes_, ref_codes)
                and torch.equal(kth.view(torch.int32), ref_kth.view(torch.int32))):
            fail(f"K1' config 4 {label}: codes differ from the plain version in "
                 f"{int((codes_ != ref_codes).any(1).sum())} rows, or kth not bit-equal")

    def plain_plan_counts(frame, codes_, spill_, spec_):
        """The frame's plan counts with every step in its plain version (the
        layout is torch code; K2's plain version decodes K1''s codes, which
        ``check_k1_codes`` holds bit-equal to theirs): ``(overflow,
        dropped_edges, window_overflow)``."""
        lay = cellblock.cellblock_layout(frame, 1.0, spec_)
        off = cellblock.s_decode_reference(
            *cellblock.s_decode_inputs(lay, codes_, cap, spill_, spec_), spec=spec_,
            codes_cap=cap)
        return (int(lay.overflow), int((off == spec_.s_width + 1).sum()),
                int(lay.window_overflow))

    # ---- 14a. K5 and K6 at width 256 and with a bf16 carry ----------------
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(args.seed + 40)
    timings = {}
    for width, carry in ((256, torch.float32), (256, torch.bfloat16), (128, torch.bfloat16)):
        cfg = default_model_config(latent_size=width, mlp_hidden_size=width)
        node = step_params(init_encode_process_decode(cfg, gen, device=dev), 0)["node"]
        x = torch.randn(rows, width, generator=gen).to(dev).to(carry)
        agg = torch.randn(rows, width, generator=gen).mul(3.0).to(dev)  # K4's f32 sums
        g_out = torch.randn(rows, width, generator=gen).to(dev).to(carry)
        label = f"width {width}, {str(carry).split('.')[-1]} carry, f32 agg, {rows} rows"
        kernels.reset_launches()
        out = fused_step_tail(x, agg, node)
        dx, dagg, grads = fused_step_tail_bwd(x, agg, g_out, node)
        if kernels.launches["fused_tail_wide"] != 1 or kernels.launches["fused_tail_wide_bwd"] != 1:
            fail(f"K5/K6 {label}: launches {dict(kernels.launches)}")
        ref = fused_step_tail_reference(x, agg, node)
        err = (out.float() - ref.float()).abs()
        e_max, e_mean = float(err.max()), float(err.mean())
        tol = ((K5_MAX_ABS_TOL, K5_MEAN_ABS_TOL) if carry == torch.float32
               else (K5_BF16_MAX_ABS_TOL, K5_BF16_MEAN_ABS_TOL))
        if out.dtype != carry or not (e_max <= tol[0] and e_mean <= tol[1]):
            fail(f"K5 {label}: dtype {out.dtype}, max abs err {e_max} (tol {tol[0]}), mean "
                 f"{e_mean} (tol {tol[1]})")
        del ref, err
        rdx, rdagg, rgrads = fused_step_tail_bwd_reference(x, agg, g_out, node)
        errs = []
        names = ["dx", "dagg", "dw_self", "db0", "dw1", "db1", "dwf", "dbf", "dscale", "dbias"]
        off_share = K6_WIDE_OFF_SHARE if width == 256 else 1e-5
        for name, a, b in zip(names, [dx, dagg, *grads], [rdx, rdagg, *rgrads]):
            a, b = a.detach().float(), b.detach().float()
            diff = (a - b).abs()
            off = int((diff > K6_REL * float(b.abs().max())).sum())
            ok = (off <= off_share * b.numel()
                  and float(diff.mean()) <= K6_MEAN * float(b.abs().mean()))
            if not ok or (name == "dx" and dx.dtype != carry):
                fail(f"K6 {label} {name}: {off} entries off, max abs err {float(diff.max())}, "
                     f"mean {float(diff.mean())}")
            errs.append(float(diff.max()))
        del rdx, rdagg, rgrads
        k5 = lambda: fused_step_tail(x, agg, node)  # noqa: E731
        k6 = lambda: fused_step_tail_bwd(x, agg, g_out, node)  # noqa: E731
        t = dict(k5=time_ms(k5, 20), k5_graph=graph_ms(k5, 10),
                 k5_plain=time_ms(lambda: fused_step_tail_reference(x, agg, node), 3),
                 k6=time_ms(k6, 10), k6_graph=graph_ms(k6, 5),
                 k6_plain=time_ms(lambda: fused_step_tail_bwd_reference(x, agg, g_out, node), 2))
        eb = x.element_size()
        # K5 in: x, agg, the weights; out: the new carry. Three width^2
        # products a row. K6 in: x, agg, g, the weights; out: dx, dagg and
        # the gradients; nine products a row (three recomputed).
        w_bytes = (3 * width * width + 5 * width) * 4
        k5_bytes = rows * width * (2 * eb + 4) + w_bytes
        k6_bytes = rows * width * (3 * eb + 8) + 2 * w_bytes
        k5_ops, k6_ops = 3 * 2 * rows * width * width, 9 * 2 * rows * width * width
        t["k5_bound"] = max(k5_bytes / HBM_BYTES_PER_S, k5_ops / BF16_TENSOR_FLOP_PER_S) * 1e3
        t["k6_bound"] = max(k6_bytes / HBM_BYTES_PER_S, k6_ops / BF16_TENSOR_FLOP_PER_S) * 1e3
        t["stages"] = k6_wide_stages(x, agg, g_out, node, w_bytes, fused_step_mod)
        timings[(width, carry)] = t
        if (width, carry) == (C4_WIDTH, torch.bfloat16):  # the config-4 path's variant
            report["fused_tail_wide"] = kernel_entry(
                "fused_tail_wide.cu", "fused_step.py:66", e_max, t["k5"], t["k5_plain"],
                k5_bytes, k5_ops, BF16_TENSOR_FLOP_PER_S, None)
            report["fused_tail_wide"]["graph_ms"] = t["k5_graph"]
            report["fused_tail_wide_bwd"] = kernel_entry(
                "fused_tail_wide_bwd.cu", "fused_step.py:113", max(errs), t["k6"], t["k6_plain"],
                k6_bytes, k6_ops, BF16_TENSOR_FLOP_PER_S, None)
            report["fused_tail_wide_bwd"]["graph_ms"] = t["k6_graph"]
            report["fused_tail_wide_bwd"]["stages"] = t["stages"]
        print(f"K5 {label}: max abs err {e_max:.3g} (tol {tol[0]}), mean {e_mean:.3g} "
              f"(tol {tol[1]}); {t['k5']:.4f} ms (graph {t['k5_graph']:.4f}; bound "
              f"{t['k5_bound']:.4f}); plain {t['k5_plain']:.4f} ms")
        print(f"K6 {label}: dx, dagg and the 8 gradients within tolerance (at most "
              f"{off_share:g} of the entries off by {K6_REL} of the largest, mean within "
              f"{K6_MEAN}); max abs err per output {[float(f'{e:.3g}') for e in errs]}; "
              f"{t['k6']:.4f} ms (graph {t['k6_graph']:.4f}; bound {t['k6_bound']:.4f}); plain "
              f"{t['k6_plain']:.4f} ms")
        st = t["stages"]
        print(f"K6 {label} stages, ms (bound ms, by): " + "; ".join(
            f"{k} {st[k]['ms']:.4f} ({st[k]['bound_ms']:.4f}, {st[k]['bound_by']})"
            for k in ("chain", "dw", "reduce")) + f"; yardstick {st['yardstick']}: "
            f"{st['yardstick_ms']:.4f} ms, the kernel's dW within "
            f"{st['yardstick_max_rel']:.3g} of its largest magnitude")
        del x, agg, g_out, out, dx, dagg, grads, node
    torch.cuda.empty_cache()
    print(f"phase 14a K5, K6 wide: {time.perf_counter() - t0:.1f} s")

    # ---- 14b. the config-4 variable plan -------------------------------------
    t0 = time.perf_counter()
    print(f"config-4 variable spec (choose_cellblock_spec({C4_N}, {C4_K}, variable=True)): "
          f"{c4_spec}; {c4_spec.num_slots} slots ({c4_uniform.num_slots} uniform), "
          f"{c4_spec.num_tiles} tiles, {c4_spec.num_padded} padded rows")
    c4_pos, c4_temp = seed_window(C4_N, args.seed + 41)
    frame = torch.from_numpy(c4_pos[-1]).to(dev)
    check_k1_codes(frame, "seed frame")
    _, codes, spill = pallas_knn.pallas_cell_list_knn(frame, C4_K, 1.0, grid, codes_only=True)
    layout = cellblock.cellblock_layout(frame, 1.0, c4_spec)
    width = c4_spec.s_width
    kernels.reset_launches()
    offsets, dropped = cellblock.s_decode(codes, spill, layout, c4_spec, cap)
    ref_off = cellblock.s_decode_reference(
        *cellblock.s_decode_inputs(layout, codes, cap, spill, c4_spec), spec=c4_spec,
        codes_cap=cap)
    if not torch.equal(offsets, ref_off) or int(dropped) != int((ref_off == width + 1).sum()):
        fail(f"K2 config 4: offsets differ in {int((offsets != ref_off).sum())} entries, "
             f"dropped {int(dropped)}")
    packs = cellblock.sender_packs(cellblock.slot_codes(layout, codes, cap, spill, c4_spec),
                                   layout, cap, c4_spec)
    s_rev, rev_total = cellblock.reverse_table(packs, layout, c4_spec)
    ref_rev = cellblock.reverse_table_reference(
        cellblock.reverse_candidates(packs, layout, c4_spec), layout.window_starts,
        layout.tile_pack_base, layout.window_lims, spec=c4_spec)
    ref_rev_total = int(ref_rev.sum(dtype=torch.int64))
    if not (torch.equal(s_rev, ref_rev) and int(rev_total) == ref_rev_total):
        fail(f"K7 config 4: reverse table or its total ({int(rev_total)}, plain "
             f"{ref_rev_total}) differs")
    if kernels.launches["s_decode"] != 1 or kernels.launches["reverse_table"] != 1:
        fail(f"config-4 plan kernels: launches {dict(kernels.launches)}")
    # The plan build (kernels) against the plain plan (every kernel's plain
    # version on the same layout).
    ref_s = cellblock.s_onehot_reference(ref_off, width=width)
    ref_mismatch = int(ref_s.sum(dtype=torch.int64)) - ref_rev_total
    plan = cellblock.build_cellblock(frame, None, 1.0, c4_spec, with_reverse=True,
                                     neighbor_codes=codes, codes_cap=cap, codes_spill=spill)
    if not (torch.equal(plan.s_table, ref_s) and torch.equal(plan.s_rev_table, ref_rev)
            and int(plan.overflow) == int(layout.overflow)
            and int(plan.reverse_mismatch) == ref_mismatch
            and int(plan.dropped_edges) == int((ref_off == width + 1).sum())):
        fail(f"config-4 plan: tables or counts differ from the plain plan's (overflow "
             f"{int(plan.overflow)}, reverse_mismatch {int(plan.reverse_mismatch)} vs "
             f"{ref_mismatch})")
    plain_violations = int(layout.overflow) + int((ref_off == width + 1).sum()) + abs(ref_mismatch)
    s_table = plan.s_table
    del ref_s, ref_rev, plan
    k2 = lambda: cellblock.s_decode(codes, spill, layout, c4_spec, cap)  # noqa: E731
    k7 = lambda: cellblock.reverse_table(packs, layout, c4_spec)  # noqa: E731
    k2_ms, k2_graph = time_ms(k2, 50), graph_ms(k2, 20)
    k7_ms, k7_graph = time_ms(k7, 10), graph_ms(k7, 5)
    k2_bytes = nbytes(codes, layout.particle_of_slot, layout.order, layout.sorted_cz,
                      layout.cstart_rel, layout.tile_const, layout.tile_col, offsets) + 4
    k7_bytes = nbytes(packs, layout.pad_src, layout.window_starts, layout.tile_pack_base,
                      layout.window_lims, layout.main_base, s_rev) + 4
    k2_bound = max(k2_bytes / HBM_BYTES_PER_S, 30 * offsets.numel() / F32_FLOP_PER_S) * 1e3
    k7_bound = k7_bytes / HBM_BYTES_PER_S * 1e3
    print(f"config-4 variable plan (N={C4_N}, k={C4_K}, seed frame): K1' codes and kth "
          f"bit-equal; K2 offsets and dropped "
          f"({int(dropped)}) bit-equal, K7 S_rev and its total ({int(rev_total)}) bit-equal; "
          f"plan S, S_rev, overflow ({int(layout.overflow)}) and reverse_mismatch "
          f"({ref_mismatch}) equal to the plain plan's; K2 {k2_ms:.4f} ms (graph "
          f"{k2_graph:.4f}; bound {k2_bound:.4f}); K7 {k7_ms:.4f} ms (graph {k7_graph:.4f}; "
          f"bound {k7_bound:.4f}); S {c4_spec.num_slots * width / 1e9:.3f} GB, S_rev "
          f"{s_rev.numel() / 1e9:.3f} GB")
    # K4 and K4^T at config 4 (H = 256, the bf16 candidates of a message-
    # passing step), timed as phase 4 times them at the flagship.
    z_pad = torch.randn(c4_spec.num_padded, C4_WIDTH, generator=gen).bfloat16().to(dev)
    k4 = lambda: cellblock.window_matmul(s_table, z_pad, layout.window_starts,  # noqa: E731
                                         spec=c4_spec)
    k4t = lambda: cellblock.window_matmul_t(s_rev, z_pad, layout.window_starts,  # noqa: E731
                                            spec=c4_spec)
    k4_errs = {}
    for label, fn, ref_fn, table in (
            ("K4", k4, cellblock.window_matmul_reference, s_table),
            ("K4^T", k4t, cellblock.window_matmul_t_reference, s_rev)):
        err = (fn() - ref_fn(table, z_pad, layout.window_starts, spec=c4_spec)).abs()
        k4_errs[label] = (float(err.max()), float(err.mean()))
        del err
        if not (k4_errs[label][0] <= K4_MAX_ABS_TOL and k4_errs[label][1] <= K4_MEAN_ABS_TOL):
            fail(f"{label} config 4: max abs err {k4_errs[label][0]} (tol {K4_MAX_ABS_TOL}), "
                 f"mean {k4_errs[label][1]} (tol {K4_MEAN_ABS_TOL})")
    k4_ms, k4_graph, k4t_ms, k4t_graph = time_ms(k4, 10), graph_ms(k4, 5), time_ms(k4t, 10), \
        graph_ms(k4t, 5)
    out_bytes = c4_spec.num_slots * C4_WIDTH * 4
    k4_bound = (nbytes(s_table, z_pad, layout.window_starts) + out_bytes) / HBM_BYTES_PER_S * 1e3
    k4t_bound = (nbytes(s_rev, z_pad, layout.window_starts) + out_bytes) / HBM_BYTES_PER_S * 1e3
    print(f"config-4 K4 (H {C4_WIDTH}, variable plan): max abs err {k4_errs['K4'][0]:.3g}, mean "
          f"{k4_errs['K4'][1]:.3g}; K4^T max abs err {k4_errs['K4^T'][0]:.3g}, mean "
          f"{k4_errs['K4^T'][1]:.3g} (tol {K4_MAX_ABS_TOL}, {K4_MEAN_ABS_TOL}); K4 {k4_ms:.4f} ms "
          f"(graph {k4_graph:.4f}; bytes bound {k4_bound:.4f}); K4^T {k4t_ms:.4f} ms (graph "
          f"{k4t_graph:.4f}; bytes bound {k4t_bound:.4f})")
    # Each mode's rate and share of its bound, the two kernels in turns, the
    # share of live chunks and the torch.bmm yardstick (in chunks of tiles).
    for label, name, table, ms, graph, bound, transpose in (
            ("K4", "window_matmul", s_table, k4_ms, k4_graph, k4_bound, False),
            ("K4^T", "window_matmul_t", s_rev, k4t_ms, k4t_graph, k4t_bound, True)):
        kern, _ = window_kernels(f"{label} config 4", table, z_pad, layout.window_starts, c4_spec,
                                 transpose, 10)
        lib = window_bmm_ms(table, z_pad, layout.window_starts, c4_spec, transpose,
                            C4_BMM_TILES)
        live = live_chunks(table, c4_spec, transpose)
        rate = bound / 1e3 * HBM_BYTES_PER_S / (ms / 1e3) / 1e9
        print(f"config-4 {label}: {ms:.4f} ms, {rate:.1f} GB/s ({100 * bound / ms:.1f} % of its "
              f"bytes bound); bmm {lib:.4f} ms (summed over chunks of {C4_BMM_TILES} tiles); "
              f"{100 * live:.2f} % of (128-row, 64-deep) chunks live")
        report[name].update(config4_ms=ms, config4_graph_ms=graph, config4_bound_ms=bound,
                            config4_library_ms=lib, config4_live_chunks=live)
        report[name]["kernels_ms"]["config4"] = kern
    del z_pad, s_table, table
    del codes, spill, layout, offsets, ref_off, packs, s_rev
    torch.cuda.empty_cache()
    print(f"phase 14b config-4 plan: {time.perf_counter() - t0:.1f} s")

    # ---- 14c. the config-4 rollout -------------------------------------------
    t0 = time.perf_counter()
    cfg = default_model_config(latent_size=C4_WIDTH, mlp_hidden_size=C4_WIDTH,
                               num_message_passing_steps=C4_MP)
    params = init_encode_process_decode(cfg, torch.Generator().manual_seed(args.seed), device=dev)
    stats = NormalizationStats.from_metadata(METADATA, device=dev)
    per_step = {"knn_codes": 1, "s_decode": 1, "s_onehot": 1, "window_matmul": C4_MP,
                "fused_tail_wide": C4_MP}
    c4_ms = {}
    for variable in (True, False):
        label = "variable" if variable else "uniform"
        kw = dict(num_neighbors=C4_K, dtype=torch.bfloat16, aggregation="cellblock",
                  cellblock_variable=variable, exactness_guard="flag", device=dev)
        rollout(params, cfg, c4_pos, c4_temp, stats, 1, **kw)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        result = rollout(params, cfg, c4_pos, c4_temp, stats, C4_ROLLOUT_STEPS, **kw)
        end.record()
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        step_ms = start.elapsed_time(end) / C4_ROLLOUT_STEPS
        coords, energy = result["Coordinates"], result["InternalEnergy"]
        if coords.shape != (WINDOW + C4_ROLLOUT_STEPS, C4_N, 3) or not (
                bool(torch.isfinite(coords).all()) and bool(torch.isfinite(energy).all())):
            fail(f"config-4 rollout {label}: trajectory {tuple(coords.shape)} not finite")
        certificate = result["neighbor_exactness"].tolist()
        if not all(certificate[:C4_CERTIFIED_STEPS]):
            fail(f"config-4 rollout {label}: certificate false on steps {certificate}")
        expected = {name: c * C4_ROLLOUT_STEPS for name, c in per_step.items()}
        if launches != {**zero, **expected}:
            fail(f"config-4 rollout {label}: launches {launches}, expected {expected}")
        spec_used = c4_spec if variable else c4_uniform
        for step, ok in enumerate(certificate):
            if ok:
                continue
            # What the certificate saw: the step's search and plan, rebuilt
            # from the frame it started from, and the same plan with every
            # step in its plain version, whose counts must be the kernels'.
            sframe = torch.remainder(coords[WINDOW - 1 + step], 1.0)
            _, sdiag = pallas_knn.pallas_cell_list_knn(sframe, C4_K, 1.0, grid,
                                                       return_diagnostics=True)
            _, scodes, sspill = pallas_knn.pallas_cell_list_knn(sframe, C4_K, 1.0, grid,
                                                                codes_only=True)
            splan = cellblock.build_cellblock(sframe, None, 1.0, spec_used,
                                              neighbor_codes=scodes, codes_cap=cap,
                                              codes_spill=sspill)
            counts = (int(splan.overflow), int(splan.dropped_edges), int(splan.window_overflow))
            check_k1_codes(sframe, f"rollout {label} step {step + 1}")
            plain_counts = plain_plan_counts(sframe, scodes, sspill, spec_used)
            if counts != plain_counts:
                fail(f"config-4 rollout {label} step {step + 1}: plan (overflow, dropped, "
                     f"window_overflow) {counts}, the plain plan's {plain_counts}")
            print(f"config-4 rollout {label} step {step + 1}: certificate false: k-NN overflow "
                  f"{int(sdiag[0])}, max excess {float(sdiag[2]):.6g} (exact if <= 0); plan "
                  f"overflow {counts[0]}, dropped edges {counts[1]}, window_overflow "
                  f"{counts[2]}, equal to the plain plan's (K1' codes bit-equal on the frame)")
            del scodes, sspill, splan
        path_launches[f"config-4 rollout {label}"], c4_ms[label] = launches, step_ms
        print(f"config-4 rollout {label}: N={C4_N} k={C4_K} latent {C4_WIDTH}, {C4_MP} MP, bf16, "
              f"slots, {C4_ROLLOUT_STEPS} steps, {step_ms:.3f} ms/step "
              f"({C4_N / step_ms * 1e3:.0f} particle-steps/s), launches "
              f"{ {k: v for k, v in launches.items() if v} }, certificate by step {certificate} "
              f"(the first {C4_CERTIFIED_STEPS} required), peak memory {peak_gib:.3f} GiB")
        del result, coords, energy
    torch.cuda.empty_cache()
    # Slots against hybrid on one spec at N = 65,536 and the flagship's k
    # (at k = 32 the chooser's variable spec for this N drops edges from the
    # first step, and the two carries then part where a particle has no
    # slot): the same sums, so within 2e-4, and the certificate true.
    spos, stemp = seed_window(N, args.seed + 42)
    kw = dict(num_neighbors=K, dtype=torch.bfloat16, exactness_guard="flag", device=dev)
    for variable in (True, False):
        runs = [rollout(params, cfg, spos, stemp, stats, 2, aggregation=aggregation,
                        cellblock_variable=variable, **kw)
                for aggregation in ("cellblock", "cellblock_hybrid")]
        cross = float((runs[0]["Coordinates"] - runs[1]["Coordinates"]).abs().max())
        certified = all(bool(r["neighbor_exactness"].all()) for r in runs)
        label = "variable" if variable else "uniform"
        if not (cross <= C4_SLOTS_TOL and certified):
            fail(f"N={N} {label} slots and hybrid config-4 rollouts differ by {cross} "
                 f"(certified: {certified})")
        print(f"config-4 slots check: N={N}, k={K}, 2 steps, {label} slots vs hybrid on the card "
              f"max coordinate diff {cross:.3g} (tol {C4_SLOTS_TOL}), certificate true")
        del runs
    print(f"phase 14c config-4 rollout: {time.perf_counter() - t0:.1f} s")

    # ---- 14d. the config-4 train step ------------------------------------------
    t0 = time.perf_counter()
    tcfg = cfg._replace(remat_chunk=C4_REMAT_CHUNK, carry_dtype="bfloat16")
    base_tc = dict(aggregation="cellblock", cellblock_variable=True, fused_tail=True,
                   num_neighbors=C4_K, compute_dtype="bfloat16")
    tbatch = train_batch(C4_N, args.seed + 43)
    tc = TrainConfig(noise_std=TRAIN_NOISE, **base_tc)
    tparams = init_encode_process_decode(tcfg, torch.Generator().manual_seed(args.seed),
                                         device=dev)
    optimizer = make_optimizer(tc, steps_per_epoch=C4_TRAIN_STEPS + 1)
    state = optimizer.init(tparams)
    train_step = make_train_step(tcfg, stats, tc, optimizer)
    tgen = torch.Generator(device=dev).manual_seed(args.seed)
    train_step(tparams, state, tbatch, tgen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    metrics = [train_step(tparams, state, tbatch, tgen)[2] for _ in range(C4_TRAIN_STEPS)]
    end.record()
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    train_ms = start.elapsed_time(end) / C4_TRAIN_STEPS
    losses = [float(m["loss"]) for m in metrics]
    violations = [float(m["cellblock_violations"]) for m in metrics]
    if not all(np.isfinite(losses)):
        fail(f"config-4 train: loss not finite: {losses}")
    # Each chunk's forward again up to its last step's input (as phase 12c).
    forwards = 2 * C4_MP + (C4_MP // C4_REMAT_CHUNK) * (C4_REMAT_CHUNK - 1)
    per_train = {"knn_codes": 1, "s_decode": 1, "s_onehot": 1, "reverse_table": 1,
                 "window_matmul": forwards, "window_matmul_t": C4_MP,
                 "fused_tail_wide": forwards, "fused_tail_wide_bwd": C4_MP}
    expected = {name: c * C4_TRAIN_STEPS for name, c in per_train.items()}
    if launches != {**zero, **expected}:
        fail(f"config-4 train: launches {launches}, expected {expected}")
    path_launches["config-4 train"] = launches
    print(f"config-4 train: N={C4_N} k={C4_K} latent {C4_WIDTH}, {C4_MP} MP, slots, variable, "
          f"fused tail, remat_chunk={C4_REMAT_CHUNK}, bf16 carry, noise {TRAIN_NOISE}, batch 1, "
          f"Adam, {C4_TRAIN_STEPS} steps, {train_ms:.3f} ms/step, losses "
          f"{[float(f'{v:.6g}') for v in losses]}, cellblock_violations {violations}, launches "
          f"{ {k: v for k, v in launches.items() if v} }, peak memory {peak_gib:.3f} GiB")
    del tparams, state, optimizer, train_step, metrics
    torch.cuda.empty_cache()
    # cellblock_violations against the plain plan's count on the step's own
    # frame: noise 0 and no augmentation, so the plan's frame is the batch's
    # last input frame, wrapped.
    quiet = TrainConfig(noise_std=0.0, augment_prob=0.0, **base_tc)
    sgd = Optimizer(lambda leaves: torch.optim.SGD(leaves, lr=1.0))
    qparams = init_encode_process_decode(tcfg, torch.Generator().manual_seed(args.seed),
                                         device=dev)
    _, _, qm = make_train_step(tcfg, stats, quiet, sgd)(qparams, sgd.init(qparams), tbatch,
                                                        torch.Generator(device=dev))
    qframe = torch.remainder(torch.from_numpy(tbatch["positions"][0, -1]).to(dev), 1.0)
    _, qcodes, qspill = pallas_knn.pallas_cell_list_knn(qframe, C4_K, 1.0, grid, codes_only=True)
    qlayout = cellblock.cellblock_layout(qframe, 1.0, c4_spec)
    qoff = cellblock.s_decode_reference(
        *cellblock.s_decode_inputs(qlayout, qcodes, cap, qspill, c4_spec), spec=c4_spec,
        codes_cap=cap)
    qpacks = cellblock.sender_packs(cellblock.slot_codes(qlayout, qcodes, cap, qspill, c4_spec),
                                    qlayout, cap, c4_spec)
    qrev = cellblock.reverse_table_reference(
        cellblock.reverse_candidates(qpacks, qlayout, c4_spec), qlayout.window_starts,
        qlayout.tile_pack_base, qlayout.window_lims, spec=c4_spec)
    qmismatch = (int(((qoff >= 0) & (qoff < c4_spec.s_width)).sum())
                 - int(qrev.sum(dtype=torch.int64)))
    qplain = int(qlayout.overflow) + int((qoff == c4_spec.s_width + 1).sum()) + abs(qmismatch)
    if float(qm["cellblock_violations"]) != qplain or not np.isfinite(float(qm["loss"])):
        fail(f"config-4 train: cellblock_violations {float(qm['cellblock_violations'])} vs the "
             f"plain plan's {qplain} on the same frame")
    print(f"config-4 train (noise 0, no augmentation): cellblock_violations "
          f"{float(qm['cellblock_violations'])} equal to the plain plan's count on its frame "
          f"(overflow {int(qlayout.overflow)}, reverse_mismatch {qmismatch}); the seed frame's "
          f"{plain_violations}")
    del qparams, qcodes, qspill, qlayout, qoff, qpacks, qrev
    torch.cuda.empty_cache()
    # One step at N = 8,192 on the card against the CPU plain path.
    sbatch = train_batch(SMALL_N, args.seed + 44)
    stats_cpu = NormalizationStats.from_metadata(METADATA, device="cpu")
    runs = {}
    for device in (dev, torch.device("cpu")):
        sgd = Optimizer(lambda leaves: torch.optim.SGD(leaves, lr=1.0))
        stc = TrainConfig(noise_std=0.0, augment_prob=0.0, **base_tc)
        sparams = init_encode_process_decode(tcfg, torch.Generator().manual_seed(args.seed),
                                             device=device)
        before = [t.detach().clone() for t in tree_leaves(sparams)]
        step = make_train_step(tcfg, stats if device.type == "cuda" else stats_cpu, stc, sgd)
        sparams, _, m = step(sparams, sgd.init(sparams), sbatch, torch.Generator(device=device))
        runs[device.type] = (float(m["loss"]),
                             [(b - a.detach()).cpu() for b, a in zip(before, tree_leaves(sparams))])
    (loss, grads), (cpu_loss, cpu_grads) = runs["cuda"], runs["cpu"]
    grad_err = max(float((a - b).abs().max()) / float(b.abs().max())
                   for a, b in zip(grads, cpu_grads) if float(b.abs().max()))
    loss_err = abs(loss - cpu_loss) / abs(cpu_loss)
    if not (loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_TOL):
        fail(f"config-4 train: N={SMALL_N} card vs CPU plain path: loss rel err {loss_err}, "
             f"worst gradient rel err {grad_err}")
    print(f"config-4 train check: N={SMALL_N}, card vs CPU plain path: loss {loss:.6g} vs "
          f"{cpu_loss:.6g} (rel err {loss_err:.3g}, tol {TRAIN_LOSS_RTOL}), worst gradient leaf "
          f"rel err {grad_err:.3g} (tol {TRAIN_GRAD_TOL})")
    print(f"phase 14d config-4 train: {time.perf_counter() - t0:.1f} s")
    return c4_ms, train_ms


def table_phase(args, dev, report, path_launches, zero):
    """Phase 15a (the table codes layout; see the module docstring).
    Returns each frame's plan-build device ms by route."""
    from cosmology_gnn_simulation_tpu_torch import kernels
    from cosmology_gnn_simulation_tpu_torch.ops import cellblock, pallas_knn
    from cosmology_gnn_simulation_tpu_torch.ops.cell_list import choose_cell_grid, f32

    t0 = time.perf_counter()
    label, share, sigma = CLUSTERED[1]
    frames = (
        ("flagship", N, K, seed_window(N, args.seed)[0][-1], False),
        (label, N, K, clustered_frame(N, share, sigma, args.seed + 21), False),
        ("config-4 variable", C4_N, C4_K, seed_window(C4_N, args.seed + 41)[0][-1], True),
    )
    build_ms = {}
    for name, n, k, frame, variable in frames:
        pos = torch.from_numpy(frame).to(dev)
        spec = cellblock.choose_cellblock_spec(n, k, variable=variable)
        grid = choose_cell_grid(n, k)
        g = grid.grid_size
        cap = pallas_knn.codes_packing_cap(n, k, grid)
        tcap, _, spill_cap = pallas_knn.spill_layout(n, k, grid)
        # K1' in the table layout: the kernel's rows as they are, against its
        # plain version on the same table; each used spill slot's picks
        # against the particle layout's codes of its particle.
        kernels.reset_launches()
        _, codes, spill = pallas_knn.pallas_cell_list_knn(pos, k, 1.0, grid, codes_only=True,
                                                          codes_layout="table")
        _, pcodes, pspill = pallas_knn.pallas_cell_list_knn(pos, k, 1.0, grid, codes_only=True)
        t = pallas_knn.build_table(pos, g, tcap, f32(1.0, dev))
        planes = (t.x, t.y, t.z, t.ids)
        sp_planes = pallas_knn.build_spill(pos, t.particle_rank, tcap, spill_cap)
        ref_codes, _ = pallas_knn.knn_codes_reference(
            planes, sp_planes, k=k, n=n, g=g, box=f32(1.0, dev),
            mi_start=pallas_knn.min_image_start(tcap, spill_cap))
        if not torch.equal(codes, ref_codes):
            fail(f"K1' table {name}: the table output differs from knn_codes_reference in "
                 f"{int((codes != ref_codes).any(1).sum())} rows")
        used = sp_planes[3] != n
        n_spilled = int(used.sum())
        if spill is None or len(spill) != 3 or not torch.equal(
                spill[2][used], pcodes[sp_planes[3][used].long()]):
            fail(f"K1' table {name}: the spill picks differ from the particle layout's codes")
        if name == label and n_spilled == 0:
            fail(f"K1' table {name}: the clustered frame spilled no particle")
        layout = cellblock.cellblock_layout(pos, 1.0, spec)
        rows = cellblock.codes_rows(layout, spill, cap, spec, "table")
        valid = 27 * cap + spill_cap
        fixed = torch.where(codes >= valid, codes[:, :1], codes)
        if not torch.equal(torch.cat([fixed, spill[2]])[rows], pcodes[layout.order]):
            fail(f"K1' table {name}: a particle's table row differs from its particle-layout "
                 "codes")
        # K2 on table rows against its plain version and the particle route;
        # the plan's S against the particle route's and the plain plan's.
        kernels.reset_launches()
        offsets, dropped = cellblock.s_decode(codes, spill, layout, spec, cap, "table")
        if dict(kernels.launches) != {**zero, "s_decode": 1}:
            fail(f"K2 table {name}: launches {dict(kernels.launches)}")
        ref_off = cellblock.s_decode_reference(
            *cellblock.s_decode_inputs(layout, codes, cap, spill, spec, "table"), spec=spec,
            codes_cap=cap)
        p_off, p_dropped = cellblock.s_decode(pcodes, pspill, layout, spec, cap)
        width = spec.s_width
        if not (torch.equal(offsets, ref_off) and torch.equal(offsets, p_off)
                and int(dropped) == int(p_dropped) == int((ref_off == width + 1).sum())):
            fail(f"K2 table {name}: offsets differ from the plain version in "
                 f"{int((offsets != ref_off).sum())} and from the particle route in "
                 f"{int((offsets != p_off).sum())} entries, dropped {int(dropped)} vs "
                 f"{int(p_dropped)}")
        kernels.reset_launches()
        plan = cellblock.build_cellblock(pos, None, 1.0, spec, neighbor_codes=codes,
                                         codes_cap=cap, codes_spill=spill,
                                         codes_layout="table")
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        if launches != {**zero, "s_decode": 1, "s_onehot": 1}:
            fail(f"table plan {name}: launches {launches}")
        p_plan = cellblock.build_cellblock(pos, None, 1.0, spec, neighbor_codes=pcodes,
                                           codes_cap=cap, codes_spill=pspill)
        ref_s = cellblock.s_onehot_reference(ref_off, width=width)
        if not (torch.equal(plan.s_table, p_plan.s_table) and torch.equal(plan.s_table, ref_s)
                and int(plan.dropped_edges) == int(p_plan.dropped_edges)):
            fail(f"table plan {name}: S or dropped edges differ from the particle route's or "
                 "the plain plan's")
        path_launches[f"table plan {name}"] = launches
        # The plan build's device ms by route from a CUDA graph: K1' with its
        # wrapper, then K2 (the layout, shared, outside).
        routes = {}
        for route in ("particle", "table"):
            def build(route=route):
                _, c, sp = pallas_knn.pallas_cell_list_knn(pos, k, 1.0, grid, codes_only=True,
                                                           codes_layout=route)
                return cellblock.s_decode(c, sp, layout, spec, cap, route)

            routes[route] = graph_ms(build, 5 if n > N else 20)
        build_ms[name] = routes
        k2t = lambda: cellblock.s_decode(codes, spill, layout, spec, cap, "table")  # noqa: E731
        k2t_ms, k2t_graph = time_ms(k2t, 50), graph_ms(k2t, 20)
        # In: the N table rows the slots read, the spill picks and tables,
        # the slot, row and z-cell maps, the start and tile tables; out: the
        # offsets and the count. ~30 integer operations a pick.
        k2t_bytes = (n * k * 4 + nbytes(spill[2], spill[0], spill[1], layout.particle_of_slot,
                                        rows, layout.sorted_cz, layout.cstart_rel,
                                        layout.tile_const, offsets) + 4)
        k2t_bound = max(k2t_bytes / HBM_BYTES_PER_S, 30 * offsets.numel() / F32_FLOP_PER_S) * 1e3
        if name == "flagship":
            report["s_decode"].update(table_ms=k2t_ms, table_graph_ms=k2t_graph,
                                      table_bound_ms=k2t_bound)
        layout_name = "variable" if variable else "uniform"
        print(f"table layout {name} (N={n}, k={k}, {spec.num_slots} slots, {layout_name}): "
              f"K1' table output ({tuple(codes.shape)}) bit-equal to knn_codes_reference, "
              f"{n_spilled} spilled with picks equal to the particle layout's codes; K2 on "
              f"table rows bit-equal to its plain version and to the particle route (dropped "
              f"{int(dropped)}); S equal to the particle route's and the plain plan's; launches "
              f"{ {kk: v for kk, v in launches.items() if v} }; K2 table {k2t_ms:.4f} ms (graph "
              f"{k2t_graph:.4f}, bound {k2t_bound:.5f}); plan build K1'+wrapper+K2 from a graph: "
              f"particle {routes['particle']:.4f} ms, table {routes['table']:.4f} ms")
        del codes, pcodes, spill, pspill, t, planes, sp_planes, ref_codes, layout, rows, fixed
        del offsets, ref_off, p_off, plan, p_plan, ref_s, pos
        torch.cuda.empty_cache()
    print(f"phase 15a table layout: {time.perf_counter() - t0:.1f} s")
    return build_ms


def sharded_phase(args, dev, report, path_launches, zero):
    """Phase 15b (the index-sharded paths at world size 1 over NCCL; see the
    module docstring). Returns the ms per step of the sharded and bare train
    steps and rollouts."""
    import torch.distributed as dist

    from cosmology_gnn_simulation_tpu_torch import kernels
    from cosmology_gnn_simulation_tpu_torch.data.synthetic import generate_synthetic_simulation
    from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
        default_model_config,
        init_encode_process_decode,
    )
    from cosmology_gnn_simulation_tpu_torch.parallel import collectives as coll
    from cosmology_gnn_simulation_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from cosmology_gnn_simulation_tpu_torch.parallel.sharded import (
        make_data_parallel_train_step,
        make_sharded_rollout,
        shard_batch,
    )
    from cosmology_gnn_simulation_tpu_torch.rollout import rollout
    from cosmology_gnn_simulation_tpu_torch.training import (
        TrainConfig,
        Trainer,
        make_optimizer,
        make_train_step,
    )
    from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats, tree_leaves

    t0 = time.perf_counter()
    cfg = default_model_config()
    mp = cfg.num_message_passing_steps
    stats = NormalizationStats.from_metadata(METADATA, device=dev)
    ms = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        initialize_distributed(f"file://{tmp}/rendezvous", 1, 0, device="cuda")
        try:
            mesh = make_mesh((1, 1))
            backends = {dist.get_backend(), *(dist.get_backend(a.group)
                                              for a in mesh.axes.values())}
            if backends != {"nccl"} or mesh.device.type != "cuda":
                fail(f"sharded: backends {backends}, device {mesh.device}")
            tbatch = train_batch(N, args.seed)
            local = shard_batch(tbatch, mesh)

            def params():
                return init_encode_process_decode(cfg, torch.Generator().manual_seed(args.seed),
                                                  device=dev)

            # (a) noise 0, no augmentation: one Adam step of each, equal.
            tc0 = TrainConfig(num_neighbors=K, compute_dtype="bfloat16", noise_std=0.0,
                              augment_prob=0.0)
            opt = make_optimizer(tc0, steps_per_epoch=1)
            bare, sharded_ = params(), params()
            _, _, m_bare = make_train_step(cfg, stats, tc0, opt)(
                bare, opt.init(bare), tbatch, torch.Generator(device=dev).manual_seed(args.seed))
            torch.cuda.synchronize()
            kernels.reset_launches()
            coll.reset_collectives()
            _, _, m_sharded = make_data_parallel_train_step(cfg, stats, tc0, opt, mesh)(
                sharded_, opt.init(sharded_), local, 0)
            torch.cuda.synchronize()
            per_step = {"knn_select": 1, "fused_tail": mp, "fused_tail_bwd": mp}
            per_collectives = {"all_gather": 1 + mp, "all_reduce": mp + 4, "broadcast": 0,
                               "ppermute": 0}
            if dict(kernels.launches) != {**zero, **per_step}:
                fail(f"sharded train step: launches {dict(kernels.launches)}")
            if dict(coll.collectives) != per_collectives:
                fail(f"sharded train step: collectives {dict(coll.collectives)}")
            loss_err = abs(float(m_sharded["loss"]) - float(m_bare["loss"]))
            param_err = max(float((a - b).abs().max())
                            for a, b in zip(tree_leaves(sharded_), tree_leaves(bare)))
            if not (loss_err <= SHARDED_TOL and param_err <= SHARDED_TOL):
                fail(f"sharded train step vs make_train_step: loss diff {loss_err}, worst "
                     f"parameter diff {param_err} (tol {SHARDED_TOL})")
            print(f"sharded train step (1,1) NCCL, N={N} k={K} default model bf16, noise 0, no "
                  f"augmentation, Adam: loss {float(m_sharded['loss']):.6g}, diff to "
                  f"make_train_step {loss_err:.3g}, worst parameter diff {param_err:.3g} (tol "
                  f"{SHARDED_TOL}); launches { {k: v for k, v in kernels.launches.items() if v} }, "
                  f"collectives {dict(coll.collectives)}")
            del bare, sharded_

            # (b) the flagship training row: noise 3e-4, augmentation on.
            tc = TrainConfig(num_neighbors=K, compute_dtype="bfloat16", noise_std=TRAIN_NOISE)
            steps = {"sharded": make_data_parallel_train_step, "bare": make_train_step}
            for kind, make in steps.items():
                p = params()
                opt = make_optimizer(tc, steps_per_epoch=TRAIN_STEPS + 1)
                state = opt.init(p)
                if kind == "sharded":
                    step = make(cfg, stats, tc, opt, mesh)
                    run = lambda i: step(p, state, local, i)[2]  # noqa: E731
                else:
                    step, gen = make(cfg, stats, tc, opt), torch.Generator(device=dev)
                    run = lambda i: step(p, state, tbatch, gen)[2]  # noqa: E731
                run(0)  # warm-up
                torch.cuda.synchronize()
                kernels.reset_launches()
                coll.reset_collectives()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                metrics = [run(i) for i in range(1, TRAIN_STEPS + 1)]
                end.record()
                torch.cuda.synchronize()
                ms[f"train {kind}"] = start.elapsed_time(end) / TRAIN_STEPS
                losses = [float(m["loss"]) for m in metrics]
                if not all(np.isfinite(losses)):
                    fail(f"train {kind} (flagship row): losses {losses}")
                if kind == "sharded":
                    expected = {name: c * TRAIN_STEPS for name, c in per_step.items()}
                    counts = {name: c * TRAIN_STEPS for name, c in per_collectives.items()}
                    if dict(kernels.launches) != {**zero, **expected}:
                        fail(f"sharded train (flagship row): launches {dict(kernels.launches)}")
                    if dict(coll.collectives) != counts:
                        fail(f"sharded train (flagship row): collectives "
                             f"{dict(coll.collectives)}")
                    path_launches["sharded train"] = dict(kernels.launches)
                print(f"train {kind} (flagship row: noise {TRAIN_NOISE}, augmentation, batch 1, "
                      f"Adam): {TRAIN_STEPS} steps, {ms[f'train {kind}']:.3f} ms/step, losses "
                      f"{[float(f'{v:.6g}') for v in losses]}"
                      + (f", per step launches {per_step}, collectives {per_collectives}"
                         if kind == "sharded" else ""))
                del p, state, step, run, metrics

            # (c) an 8-step sharded rollout against the gather rollout.
            p = params()
            pos, temp = seed_window(N, args.seed)
            kw = dict(num_neighbors=K, dtype=torch.bfloat16)
            sharded_rollout = make_sharded_rollout(cfg, stats, mesh, STEPS, **kw)
            sharded_rollout(p, pos, temp)  # warm-up
            torch.cuda.synchronize()
            kernels.reset_launches()
            coll.reset_collectives()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = sharded_rollout(p, pos, temp)
            end.record()
            torch.cuda.synchronize()
            ms["rollout sharded"] = start.elapsed_time(end) / STEPS
            launches = dict(kernels.launches)
            expected = {"knn_select": STEPS, "fused_tail": mp * STEPS}
            rollout_collectives = {"all_gather": STEPS * (1 + mp), "all_reduce": 0,
                                   "broadcast": 0, "ppermute": 0}
            if launches != {**zero, **expected} or dict(coll.collectives) != rollout_collectives:
                fail(f"sharded rollout: launches {launches}, collectives "
                     f"{dict(coll.collectives)}")
            path_launches["sharded rollout"] = launches
            start.record()
            ref = rollout(p, cfg, pos, temp, stats, STEPS, aggregation="gather", device=dev, **kw)
            end.record()
            torch.cuda.synchronize()
            ms["rollout gather"] = start.elapsed_time(end) / STEPS
            err = max(float((out[key] - ref[key]).abs().max())
                      for key in ("Coordinates", "InternalEnergy"))
            if not (err <= SMALL_COORD_TOL and bool(torch.isfinite(out["Coordinates"]).all())):
                fail(f"sharded rollout vs gather rollout: max diff {err} (tol "
                     f"{SMALL_COORD_TOL})")
            print(f"sharded rollout (1,1) NCCL: N={N}, {STEPS} steps bf16, within {err:.3g} of "
                  f"rollout(aggregation='gather') (tol {SMALL_COORD_TOL}); launches "
                  f"{ {k: v for k, v in launches.items() if v} }, collectives "
                  f"{dict(coll.collectives)}; {ms['rollout sharded']:.3f} ms/step (gather "
                  f"rollout {ms['rollout gather']:.3f})")
            del p, out, ref

            # (d) Trainer(mesh) against Trainer(): 2 steps and a validation
            # pass (noise 0, no augmentation), params and history equal.
            train_sim = generate_synthetic_simulation(num_snapshots=WINDOW + 2, num_particles=N,
                                                      seed=args.seed + 50)
            val_sim = generate_synthetic_simulation(num_snapshots=WINDOW + 1, num_particles=N,
                                                    seed=args.seed + 51)
            fitted = {}
            for kind in ("single", "mesh"):
                tcf = TrainConfig(num_neighbors=K, compute_dtype="bfloat16", noise_std=0.0,
                                  augment_prob=0.0, num_epochs=1, save_every=1,
                                  output_dir=os.path.join(tmp, kind))
                trainer = Trainer(cfg, stats, tcf, 2, params(),
                                  mesh=mesh if kind == "mesh" else None, device=dev)
                with contextlib.redirect_stdout(io.StringIO()):
                    best = trainer.fit(MemoryDataset([train_sim]), MemoryDataset([val_sim]))
                fitted[kind] = ([t.detach().clone() for t in tree_leaves(best)],
                                trainer.history)
            (p_one, h_one), (p_mesh, h_mesh) = fitted["single"], fitted["mesh"]
            fit_err = max(float((a - b).abs().max()) for a, b in zip(p_mesh, p_one))
            hist_err = max(abs(h_mesh[key][0] - h_one[key][0]) for key in ("train_loss",
                                                                           "val_loss"))
            if not (fit_err <= SHARDED_TOL and hist_err <= SHARDED_TOL):
                fail(f"Trainer(mesh) vs Trainer(): worst parameter diff {fit_err}, history diff "
                     f"{hist_err}")
            print(f"Trainer(mesh) (1,1) NCCL: 2 steps and validation at N={N}, params within "
                  f"{fit_err:.3g} and losses within {hist_err:.3g} of Trainer()'s (tol "
                  f"{SHARDED_TOL}); train loss {h_mesh['train_loss'][0]:.6g}, val loss "
                  f"{h_mesh['val_loss'][0]:.6g}")
        finally:
            dist.destroy_process_group()
    print(f"phase 15b sharded paths: {time.perf_counter() - t0:.1f} s")
    return ms


def halo_phase(args, dev, report, path_launches, zero, cfg, stats, train_ms):
    """Phases 16a and 16b (one config-5 shard's slab plan; the gid-keyed
    hybrid train step; see the module docstring). Returns the plan build's
    ms and peak GiB and the gid-keyed step's ms."""
    from cosmology_gnn_simulation_tpu_torch import kernels
    from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
        init_encode_process_decode,
    )
    from cosmology_gnn_simulation_tpu_torch.ops import cellblock, noise
    from cosmology_gnn_simulation_tpu_torch.ops.cell_list import (
        CellGrid,
        cell_list_knn,
        f32,
        window_margin_sq,
    )
    from cosmology_gnn_simulation_tpu_torch.ops.periodic import min_image_displacement
    from cosmology_gnn_simulation_tpu_torch.parallel import halo
    from cosmology_gnn_simulation_tpu_torch.training import TrainConfig, make_optimizer
    from cosmology_gnn_simulation_tpu_torch.training import make_train_step
    from cosmology_gnn_simulation_tpu_torch.training.trainer import Optimizer
    from cosmology_gnn_simulation_tpu_torch.types import tree_leaves

    # ---- 16a. one config-5 shard's slab plan ---------------------------------
    t0 = time.perf_counter()
    hc = halo.choose_halo_config(C5_N, C5_K, C5_SHARDS)
    spec = cellblock.choose_cellblock_spec_halo(C5_N, hc.grid_size, hc.slab_layers,
                                                hc.halo_layers, C5_SHARDS)
    width, g = spec.s_width, hc.grid_size
    print(f"config-5 halo geometry (choose_halo_config({C5_N}, {C5_K}, {C5_SHARDS})): {hc}; "
          f"{hc.candidate_count} candidate rows a shard; slab spec "
          f"(choose_cellblock_spec_halo): {spec}; {spec.num_slots} slots, {spec.num_tiles} "
          f"tiles, {spec.num_padded} padded rows, S {spec.num_slots * width / 1e9:.3f} GB, S_rev "
          f"{spec.num_tiles * width * spec.rev_lanes / 1e9:.3f} GB")
    c5_pos, c5_temp = seed_window(C5_N, args.seed + 51)
    part = halo.partition_windows(c5_pos, c5_temp, hc, 1.0)
    recent, valid = part["positions"][-1], part["valid"]
    del c5_pos, c5_temp
    gen = torch.Generator().manual_seed(args.seed + 52)
    expected = {**zero, "s_onehot": 1, "reverse_table": 1, "window_matmul": 1,
                "window_matmul_t": 1}
    slab = {}
    for shard in C5_CHECK_SHARDS:
        cand, cand_valid, halo_over = halo.shard_candidates(recent, valid, hc, 1.0, shard)
        local, box_local = halo.slab_frame(cand, hc, spec.gx, 1.0, shard)
        cap, m = hc.local_capacity, cand.shape[0]
        cand_t, valid_t = torch.from_numpy(cand).to(dev), torch.from_numpy(cand_valid).to(dev)
        local_t, box_t = torch.from_numpy(local).to(dev), torch.from_numpy(box_local).to(dev)
        own_t, own_valid = cand_t[:cap], valid_t[:cap]
        # The masked cell list: the owned rows query the candidate set.
        grid = CellGrid(g, hc.cell_capacity)
        idx, (cell_over, _, _) = cell_list_knn(cand_t, C5_K, 1.0, grid, queries=own_t,
                                               valid=valid_t, return_diagnostics=True)
        d2 = (min_image_displacement(own_t[:, None, :] - cand_t[idx], f32(1.0, dev)) ** 2).sum(-1)
        excess = float(torch.where(own_valid, d2.max(1).values
                                   - window_margin_sq(own_t, f32(1.0, dev), grid),
                                   -torch.inf).max())
        if halo_over or int(cell_over) or not bool(valid_t[idx[own_valid]].all()):
            fail(f"slab shard {shard}: halo overflow {halo_over}, cell overflow {int(cell_over)}, "
                 "or a valid query picked an invalid row")
        nbr = torch.cat([idx, torch.full((m - cap, C5_K), m, dtype=idx.dtype, device=dev)])

        # The main path: plan (K3, K7), aggregation forward (K4) and backward
        # (K4^T), counts zeroed before and read after.
        z = torch.randn(m, C5_H, generator=gen).to(dev)
        torch.cuda.synchronize()
        kernels.reset_launches()
        plan = cellblock.build_cellblock(local_t, nbr, box_t, spec, with_reverse=True,
                                         valid=valid_t)
        z_sorted = z[plan.order].requires_grad_(True)
        agg = cellblock.cellblock_aggregate(z_sorted, plan, spec, carry_dtype=torch.bfloat16)
        (dz,) = torch.autograd.grad((agg * agg).sum(), z_sorted)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        if launches != expected:
            fail(f"slab shard {shard}: launches {launches}, expected {expected}")
        counts = (int(plan.overflow), int(plan.dropped_edges), int(plan.reverse_mismatch))
        if counts != (0, 0, 0) or not bool(torch.isfinite(dz).all()):
            fail(f"slab shard {shard}: overflow, dropped edges, reverse_mismatch {counts}, or a "
                 "gradient not finite")
        # The aggregation at the owned rows (through the inverse order)
        # against the gather-sum over the neighbor ids, bf16-rounded as the
        # carry is.
        inv = torch.empty_like(plan.order)
        inv[plan.order] = torch.arange(m, device=dev)
        owned = agg.detach()[inv[:cap]][own_valid]
        ref = z.bfloat16().float()[idx[own_valid]].sum(1)
        agg_err = (owned - ref).abs()
        if not (float(agg_err.max()) <= K4_MAX_ABS_TOL and float(agg_err.mean()) <= K4_MEAN_ABS_TOL):
            fail(f"slab shard {shard}: aggregation vs gather-sum max abs err "
                 f"{float(agg_err.max())}, mean {float(agg_err.mean())}")
        path_launches[f"slab plan shard {shard}"] = launches

        # Each kernel against its plain version on this plan's inputs.
        checked = slab_kernel_checks(local_t, box_t, valid_t, nbr, spec, gen,
                                     f"slab shard {shard}", plan)
        layout, offsets, packs = checked["layout"], checked["offsets"], checked["packs"]
        s_table, s_rev, z_pad = checked["s_table"], checked["s_rev"], checked["z_pad"]
        s_total, errs = checked["s_total"], checked["errs"]
        print(f"slab shard {shard}: {int(cand_valid.sum())} valid of {m} candidate rows "
              f"({int(cand_valid[:cap].sum())} owned), masked cell list overflow 0, max excess "
              f"over the owned queries {excess:.4g} (<= 0 certifies); plan overflow, dropped "
              f"edges, reverse_mismatch 0; {int(s_total)} edges; K3 and K7 bit-equal to their "
              f"plain versions (S, S_rev, totals); K4 max abs err {errs['K4']:.3g}, K4^T "
              f"{errs['K4^T']:.3g} (tol {K4_MAX_ABS_TOL}); aggregation at the owned rows vs the "
              f"gather-sum max abs err {float(agg_err.max()):.3g}; launches "
              f"{ {k: v for k, v in launches.items() if v} }")

        if shard == C5_CHECK_SHARDS[0]:
            # Times (events, graph), bounds and plain times; the plan build.
            def build():
                return cellblock.build_cellblock(local_t, nbr, box_t, spec, with_reverse=True,
                                                 valid=valid_t)

            del plan, agg, dz, z_sorted
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            build_ms = time_ms(build, 2)
            build_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            k3 = lambda: cellblock.s_onehot(offsets, width=width, with_total=True)  # noqa: E731
            k7 = lambda: cellblock.reverse_table(packs, layout, spec)  # noqa: E731
            k4 = lambda: cellblock.window_matmul(  # noqa: E731
                s_table, z_pad, layout.window_starts, spec=spec)
            k4t = lambda: cellblock.window_matmul_t(  # noqa: E731
                s_rev, z_pad, layout.window_starts, spec=spec)
            out = torch.empty((spec.num_slots, C5_H), dtype=torch.float32, device=dev)
            k7_bytes = nbytes(packs, layout.pad_src, layout.window_starts, layout.tile_pack_base,
                              layout.window_lims, layout.main_base, s_rev) + 4
            rows = [
                ("s_onehot", k3, lambda: cellblock.s_onehot_reference(offsets, width=width),
                 nbytes(offsets, s_table) + 4, offsets.numel(), F32_FLOP_PER_S),
                ("reverse_table", k7, lambda: cellblock.reverse_table_reference(
                    cellblock.reverse_candidates(packs, layout, spec), layout.window_starts,
                    layout.tile_pack_base, layout.window_lims, spec=spec), k7_bytes,
                 3 * spec.num_tiles * width * C5_K, F32_FLOP_PER_S),
                ("window_matmul", k4, lambda: cellblock.window_matmul_reference(
                    s_table, z_pad, layout.window_starts, spec=spec),
                 nbytes(s_table, z_pad, layout.window_starts, out),
                 2 * int((s_table != 0).sum()) * C5_H, BF16_TENSOR_FLOP_PER_S),
                ("window_matmul_t", k4t, lambda: cellblock.window_matmul_t_reference(
                    s_rev, z_pad, layout.window_starts, spec=spec),
                 nbytes(s_rev, z_pad, layout.window_starts, out),
                 2 * int((s_rev != 0).sum()) * C5_H, BF16_TENSOR_FLOP_PER_S),
            ]
            del out
            for name, fn, plain, nb, ops, rate in rows:
                t = dict(slab_ms=time_ms(fn, 10), slab_graph_ms=graph_ms(fn, 5),
                         slab_plain_ms=time_ms(plain, 1),
                         slab_bound_ms=max(nb / HBM_BYTES_PER_S, ops / rate) * 1e3,
                         slab_launches=launches[name])
                report[name].update(t)
                slab[name] = t
                print(f"{name} on the slab plan: {t['slab_ms']:.4f} ms (graph "
                      f"{t['slab_graph_ms']:.4f}; bound {t['slab_bound_ms']:.4f}, {nb} bytes); "
                      f"plain {t['slab_plain_ms']:.4f} ms")
            for name, label, table, transpose in (("window_matmul", "K4", s_table, False),
                                                  ("window_matmul_t", "K4^T", s_rev, True)):
                report[name]["kernels_ms"]["slab"] = window_kernels(
                    f"{label} slab", table, z_pad, layout.window_starts, spec, transpose, 10)[0]
            slab["build_ms"], slab["build_peak_gib"] = build_ms, build_peak
            print(f"slab plan build (shard {shard}: layout, aux offsets, K3, sender packs, K7): "
                  f"{build_ms:.4f} ms by events, peak {build_peak:.3f} GiB above the "
                  f"{base / 2**30:.3f} GiB held before it")
        del cand_t, valid_t, local_t, own_t, idx, nbr, z, layout, offsets, packs
        del s_table, s_rev, z_pad, checked
        torch.cuda.empty_cache()
    del part, recent, valid
    print(f"phase 16a config-5 slab plan: {time.perf_counter() - t0:.1f} s")

    # ---- 16b. the gid-keyed hybrid train step -------------------------------
    t0 = time.perf_counter()
    mp = cfg.num_message_passing_steps
    per_step = {"knn_codes": 1, "s_decode": 1, "s_onehot": 1, "reverse_table": 1,
                "window_matmul": mp, "window_matmul_t": mp, "fused_tail": mp,
                "fused_tail_bwd": mp}
    tbatch = train_batch(N, args.seed)

    def timed_steps(keyed: bool):
        """1 warm-up and TRAIN_STEPS timed steps of the flagship hybrid
        train row, noise keyed per particle or by the stream: (ms per step,
        launches of the timed steps, their metrics)."""
        tc_ = TrainConfig(aggregation="cellblock_hybrid", num_neighbors=K,
                          compute_dtype="bfloat16", noise_std=TRAIN_NOISE,
                          partition_invariant_noise=keyed)
        tparams = init_encode_process_decode(cfg, torch.Generator().manual_seed(args.seed),
                                             device=dev)
        optimizer = make_optimizer(tc_, steps_per_epoch=TRAIN_STEPS + 1)
        state = optimizer.init(tparams)
        train_step = make_train_step(cfg, stats, tc_, optimizer)
        tgen = torch.Generator(device=dev).manual_seed(args.seed)
        train_step(tparams, state, tbatch, tgen)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics_ = [train_step(tparams, state, tbatch, tgen)[2] for _ in range(TRAIN_STEPS)]
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / TRAIN_STEPS, dict(kernels.launches), metrics_

    gid_ms, launches, metrics = timed_steps(True)
    losses = [float(mt["loss"]) for mt in metrics]
    violations = [float(mt["cellblock_violations"]) for mt in metrics]
    want = {**zero, **{name: c * TRAIN_STEPS for name, c in per_step.items()}}
    if launches != want or not all(np.isfinite(losses)) or any(violations):
        fail(f"gid-keyed train step: launches {launches} (expected {want}), losses {losses}, "
             f"cellblock_violations {violations}")
    # The two keyings in turns in this call (stream, gid, gid, stream).
    turns = [(keyed, timed_steps(keyed)[0]) for keyed in (False, True, True, False)]
    stream_turns = [ms for keyed, ms in turns if not keyed]
    gid_turns = [ms for keyed, ms in turns if keyed]
    tc = TrainConfig(aggregation="cellblock_hybrid", num_neighbors=K, compute_dtype="bfloat16",
                     noise_std=TRAIN_NOISE, partition_invariant_noise=True)
    path_launches["train cellblock_hybrid gid-keyed"] = launches
    del metrics
    # Layout invariance: the sample with its particles (and their ids)
    # permuted, one SGD step (lr 1) from the same weights and generator.
    perm = np.random.default_rng(args.seed + 53).permutation(N)
    permuted = {"positions": tbatch["positions"][:, :, perm],
                "temperatures": tbatch["temperatures"][:, :, perm],
                "target_positions": tbatch["target_positions"][:, perm],
                "target_temperatures": tbatch["target_temperatures"][:, perm],
                "gids": perm[None]}
    runs = []
    for batch in (tbatch, permuted):
        sgd = Optimizer(lambda leaves: torch.optim.SGD(leaves, lr=1.0))
        sparams = init_encode_process_decode(cfg, torch.Generator().manual_seed(args.seed),
                                             device=dev)
        before = [t.detach().clone() for t in tree_leaves(sparams)]
        step = make_train_step(cfg, stats, tc, sgd)
        sparams, _, mt = step(sparams, sgd.init(sparams), batch,
                              torch.Generator(device=dev).manual_seed(args.seed + 54))
        runs.append((float(mt["loss"]), [b - a.detach() for b, a in zip(before,
                                                                        tree_leaves(sparams))]))
    (loss, grads), (p_loss, p_grads) = runs
    loss_err = abs(p_loss - loss) / abs(loss)
    grad_err = max(float((a - b).abs().max()) / float(b.abs().max())
                   for a, b in zip(p_grads, grads) if float(b.abs().max()))
    if not (loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_TOL):
        fail(f"gid-keyed train step, permuted sample: loss rel err {loss_err}, worst gradient "
             f"rel err {grad_err}")
    del runs, grads, p_grads
    # The keying's integer bits on the card equal the CPU's; its normals
    # within GID_NORMAL_ULPS (the card's and the CPU's log, sqrt and cos).
    key = torch.tensor([args.seed * 7919 + 12345])
    gids = torch.from_numpy(perm)
    elements = (WINDOW - 1) * 3
    bits_ok = torch.equal(noise.gid_bits(key.to(dev), gids.to(dev), elements).cpu(),
                          noise.gid_bits(key, gids, elements))
    z_card = noise.gid_normals(key.to(dev), gids.to(dev), (N, WINDOW - 1, 3)).cpu()
    z_cpu = noise.gid_normals(key, gids, (N, WINDOW - 1, 3))
    ulps = int((z_card.view(torch.int32).long() - z_cpu.view(torch.int32).long()).abs().max())
    if not bits_ok or ulps > GID_NORMAL_ULPS or not bool((z_card.sign() == z_cpu.sign()).all()):
        fail(f"gid-keyed noise: integer bits equal {bits_ok}, normals {ulps} ulps apart")
    print(f"gid-keyed train step (partition_invariant_noise=True): N={N} k={K} default model "
          f"bf16, noise {TRAIN_NOISE}, batch 1, {TRAIN_STEPS} steps, {gid_ms:.3f} ms/step "
          f"(phase 11's stream-keyed step {train_ms['cellblock_hybrid']:.3f}; in turns here, "
          f"stream {stream_turns[0]:.3f}, gid {gid_turns[0]:.3f}, gid {gid_turns[1]:.3f}, "
          f"stream {stream_turns[1]:.3f}), losses "
          f"{[float(f'{v:.6g}') for v in losses]}, cellblock_violations 0, launches "
          f"{ {k: v for k, v in launches.items() if v} }; the permuted sample: loss rel err "
          f"{loss_err:.3g} (tol {TRAIN_LOSS_RTOL}), worst gradient leaf rel err {grad_err:.3g} "
          f"(tol {TRAIN_GRAD_TOL}); the keying's bits on the card equal the CPU's, its normals "
          f"at most {ulps} ulps apart (tol {GID_NORMAL_ULPS})")
    print(f"phase 16b gid-keyed train step: {time.perf_counter() - t0:.1f} s")
    return slab, gid_ms


# ---- 17. the halo paths, P ranks on the card ------------------------------
# The rank side: module-level functions, so the spawned ranks import them.


def _halo_setup(seed, dev, **model):
    """The default model's config (``model`` overrides), the flagship stats
    and the seeded weights every rank and the parent share."""
    from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
        default_model_config,
        init_encode_process_decode,
    )
    from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats

    cfg = default_model_config(**model)
    stats = NormalizationStats.from_metadata(METADATA, device=dev)
    params = init_encode_process_decode(cfg, torch.Generator().manual_seed(seed), device=dev)
    return cfg, stats, params


def _counts():
    """This rank's kernel launches, collectives and staged bytes."""
    from cosmology_gnn_simulation_tpu_torch import kernels
    from cosmology_gnn_simulation_tpu_torch.parallel import collectives as coll

    return (dict(kernels.launches), dict(coll.collectives),
            coll.collectives_bytes["host_staged"])


def _reset_counts():
    from cosmology_gnn_simulation_tpu_torch import kernels
    from cosmology_gnn_simulation_tpu_torch.parallel import collectives as coll

    kernels.reset_launches()
    coll.reset_collectives()


def _timed(module, name):
    """Wrap ``module.name`` in CUDA events (around the ring permute: the
    exchange's device span, the copy down, the host exchange and the copy
    up); returns the list the (start, end) pairs go to."""
    spans, fn = [], getattr(module, name)

    def timed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out

    setattr(module, name, timed)
    return spans


def _span_ms(spans) -> list:
    """Each span's ms, in call order; clears the list."""
    torch.cuda.synchronize()
    out = [start.elapsed_time(end) for start, end in spans]
    spans.clear()
    return out


def halo_rollout_task(mesh, seed, t_spawn):
    """17a, one rank: the halo gather rollout (float32) and the halo x
    cell-block hybrid rollout (bf16, fused tail) of the flagship window,
    each after a 1-step warm-up, with its counts and ms per step."""
    import torch.distributed as dist

    from cosmology_gnn_simulation_tpu_torch.ops import cellblock
    from cosmology_gnn_simulation_tpu_torch.parallel import halo

    dev = mesh.device
    cfg, stats, params = _halo_setup(seed, dev)
    p = mesh.shape["particle"]
    hc = halo.choose_halo_config(N, K, p)
    spec = cellblock.choose_cellblock_spec_halo(N, hc.grid_size, hc.slab_layers,
                                                hc.halo_layers, p)
    part = halo.partition_windows(*seed_window(N, seed), hc, 1.0)
    args = halo.window_segment(part, hc, mesh.axis("particle").index)
    out = {"backends": sorted({dist.get_backend(), *(dist.get_backend(a.group)
                                                      for a in mesh.axes.values())}),
           "hc": tuple(hc), "spec": tuple(spec), "initial_gid": args[3][args[2]]}
    for label, dtype, cb in (("gather f32", None, None), ("hybrid bf16", torch.bfloat16, spec)):
        kw = dict(num_neighbors=K, dtype=dtype, cellblock_spec=cb)
        halo.make_halo_rollout(cfg, stats, mesh, 1, hc, **kw)(params, *args)
        fn = halo.make_halo_rollout(cfg, stats, mesh, HALO_STEPS, hc,
                                    with_certificate_components=True, **kw)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        outs, diag, exact, certs = fn(params, *args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / HALO_STEPS
        launches, colls, staged = _counts()
        out[label] = {"outs": {k: v.cpu().numpy() for k, v in outs.items()},
                      "diag": {k: int(v) for k, v in diag.items()},
                      "exact": exact.cpu().numpy(),
                      "certs": {k: v.cpu().numpy() for k, v in certs.items()},
                      "launches": launches, "collectives": colls, "staged": staged, "ms": ms}
        _progress(mesh, t_spawn, f"{label} rollouts")
    return out


def _train_row(noise=TRAIN_NOISE):
    """The flagship training row with the noise keyed per particle and no
    augmentation (the halo step augments on the host, so the single-device
    step it is held to does not augment)."""
    from cosmology_gnn_simulation_tpu_torch.training import TrainConfig

    return TrainConfig(aggregation="cellblock_hybrid", num_neighbors=K, compute_dtype="bfloat16",
                       noise_std=noise, partition_invariant_noise=True, augment_prob=0.0)


def _sgd():
    from cosmology_gnn_simulation_tpu_torch.training.trainer import Optimizer

    return Optimizer(lambda leaves: torch.optim.SGD(leaves, lr=1.0))


def halo_train_task(mesh, seed, t_spawn):
    """17b, one rank: the halo x cell-block train step (reverse plans, bf16,
    the gid-keyed noise) of the flagship batch, one SGD step (lr 1: the
    update is the gradient) from the seeded weights with its counts, then
    one more timed; the halo eval step; peak memory."""
    from cosmology_gnn_simulation_tpu_torch.ops import cellblock
    from cosmology_gnn_simulation_tpu_torch.parallel import halo
    from cosmology_gnn_simulation_tpu_torch.types import tree_leaves

    dev = mesh.device
    cfg, stats, params = _halo_setup(seed, dev)
    p = mesh.shape["particle"]
    tc = _train_row()
    hc = halo.choose_halo_config(N, K, p, noise=True)
    spec = cellblock.choose_cellblock_spec_halo(N, hc.grid_size, hc.slab_layers,
                                                hc.halo_layers, p)
    local = halo.shard_halo_batch(halo.partition_batch(train_batch(N, seed), hc, 1.0), mesh)
    sgd = _sgd()
    state = sgd.init(params)
    step = halo.make_halo_train_step(cfg, stats, tc, sgd, mesh, hc, cellblock_spec=spec)
    before = [t.detach().clone() for t in tree_leaves(params)]
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    _, _, metrics = step(params, state, local, gen)
    torch.cuda.synchronize()
    launches, colls, staged = _counts()
    grads = [(b - a.detach()).cpu().numpy() for b, a in zip(before, tree_leaves(params))]
    t0 = time.perf_counter()
    step(params, state, local, gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    eval_params = _halo_setup(seed, dev)[2]
    _reset_counts()
    metrics_eval = halo.make_halo_eval_step(cfg, stats, tc, mesh, hc)(eval_params, local)
    torch.cuda.synchronize()
    eval_launches, eval_colls, _ = _counts()
    _progress(mesh, t_spawn, "train and eval steps")
    return {"hc": tuple(hc), "spec": tuple(spec),
            "metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
            "launches": launches, "collectives": colls, "staged": staged, "ms": ms, "peak": peak,
            "eval": {k: v.cpu().numpy() for k, v in metrics_eval.items()},
            "eval_launches": eval_launches, "eval_collectives": eval_colls}


def _progress(mesh, t_spawn, msg):
    """A line from rank 0 as a spawned phase goes, with the seconds since
    the parent spawned the ranks (stdout is shared)."""
    if mesh.axis("particle").index == 0:
        print(f"  [rank 0, {time.time() - t_spawn:.1f} s] {msg}", flush=True)


def _fed(feed):
    """The next item the parent fed this rank (``_feed_config5``)."""
    item = feed.get(timeout=HALO_RANK_TIMEOUT_S)
    if item is None:
        raise RuntimeError("the parent's partition of the config-5 data failed")
    return item


def _feed_config5(feeds, seed):
    """17c's data, made and partitioned once in the parent while the ranks
    start: to each rank (its queue in ``feeds``) its segment of the first
    window with the host mirror of its exchanged candidates, then its slice
    of the partitioned training batch (``shard_halo_batch``, which reads
    only the mesh's coordinates and device, cut here on the host)."""
    from cosmology_gnn_simulation_tpu_torch.parallel import halo
    from cosmology_gnn_simulation_tpu_torch.parallel.mesh import Mesh, MeshAxis

    t0 = time.perf_counter()
    p = len(feeds)
    hc = halo.choose_halo_config(C5_N, C5_K, p)
    part = halo.partition_windows(*seed_window(C5_N, seed + 51), hc, 1.0)
    for q, feed in enumerate(feeds):
        want, want_valid, _ = halo.shard_candidates(part["positions"][-1], part["valid"], hc,
                                                    1.0, q)
        feed.put(([torch.from_numpy(np.ascontiguousarray(a))
                   for a in halo.window_segment(part, hc, q)], want, want_valid))
    del part
    hc_t = halo.choose_halo_config(C5_N, C5_K, p, noise=True)
    batch = halo.partition_batch(train_batch(C5_N, seed), hc_t, 1.0)
    for q, feed in enumerate(feeds):
        coords = Mesh(("data", "particle"), np.arange(p).reshape(1, p), q,
                      {"data": MeshAxis("data", None, 1, 0),
                       "particle": MeshAxis("particle", None, p, q)}, torch.device("cpu"))
        feed.put(halo.shard_halo_batch(batch, coords))
    print(f"phase 17c: the parent made and partitioned the data in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def config5_task(mesh, seed, t_spawn, feed):
    """17c, one rank of BASELINE config 5 (its data from ``_feed_config5``):
    featurize_halo's graph and slab plan of the first frame, its candidates
    through the exchange against the host mirror, rank 0's plan's kernels
    against their plain versions;
    2 halo x cell-block rollout steps (bf16, fused tail) and one train step
    (the training row, remat_chunk 5): for each its ms (the rollout's split
    into featurize_halo, the model and the rest), permutes, staged bytes,
    the permutes' device span and peak memory."""
    import torch.distributed as dist

    from cosmology_gnn_simulation_tpu_torch.models import encode_process_decode as epd
    from cosmology_gnn_simulation_tpu_torch.ops import cellblock
    from cosmology_gnn_simulation_tpu_torch.parallel import collectives as coll
    from cosmology_gnn_simulation_tpu_torch.parallel import halo

    dev = mesh.device
    axis = mesh.axis("particle")
    p = mesh.shape["particle"]
    cfg, stats, params = _halo_setup(seed, dev, remat_chunk=C5_REMAT_CHUNK)
    hc = halo.choose_halo_config(C5_N, C5_K, p)
    spec = cellblock.choose_cellblock_spec_halo(C5_N, hc.grid_size, hc.slab_layers,
                                                hc.halo_layers, p, query_block=C5_HALO_QB)
    args, want, want_valid = _fed(feed)
    out = {"hc": tuple(hc), "spec": tuple(spec)}
    _progress(mesh, t_spawn, "first window received")

    # The first frame's graph and slab plan (with its reverse table), as the
    # rollout's first step builds them; its candidates through the exchange
    # against the host mirror; rank 0's plan against the plain versions.
    cap = hc.local_capacity
    valid = args[2].to(dev)
    graph, sends, _ = halo.featurize_halo(
        args[0].to(dev), args[1].to(dev), valid, stats,
        num_neighbors=C5_K, hc=hc, axis=axis, cellblock_spec=spec, cellblock_reverse=True)
    cand = halo.expand_candidates(torch.cat([graph.positions, valid[:, None].float()], dim=-1),
                                  sends, axis)
    cand_pos, cand_valid = cand[:, :3], cand[:, 3] > 0.5
    if not (np.array_equal(cand_pos.cpu().numpy(), want)
            and np.array_equal(cand_valid.cpu().numpy(), want_valid)):
        fail(f"config 5 rank {axis.index}: the exchanged candidates differ from the host mirror")
    plan = graph.cellblock.plan
    out["plan"] = {"overflow": int(plan.overflow), "dropped": int(plan.dropped_edges),
                   "window_overflow": int(plan.window_overflow),
                   "reverse_mismatch": int(plan.reverse_mismatch)}
    if axis.index == 0:
        m = cand_pos.shape[0]
        nbr = torch.cat([graph.neighbors, graph.neighbors.new_full((m - cap, C5_K), m)])
        local, box_local = halo._local_frame(cand_pos, hc, spec.gx, 1.0, 0)
        _reset_counts()
        checked = slab_kernel_checks(local, box_local, cand_valid, nbr, spec,
                                     torch.Generator().manual_seed(seed + 52),
                                     "config 5 rank 0's featurize_halo plan", plan)
        out["kernels"] = {"launches": _counts()[0], "errs": checked["errs"],
                          "edges": int(checked["s_total"])}
        del checked, nbr, local
    del graph, sends, plan, cand, cand_pos, cand_valid, valid
    torch.cuda.empty_cache()
    dist.barrier()
    _progress(mesh, t_spawn, "first plan and exchange checked")

    spans = {"exchange": _timed(coll, "_permute"), "featurize": _timed(halo, "featurize_halo"),
             "model": _timed(epd, "apply_encode_process_decode")}
    fn = halo.make_halo_rollout(cfg, stats, mesh, C5_HALO_STEPS, hc, num_neighbors=C5_K,
                                dtype=torch.bfloat16, with_certificate_components=True,
                                cellblock_spec=spec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t1 = time.perf_counter()
    outs, diag, exact, certs = fn(params, *args)
    torch.cuda.synchronize()
    rollout_ms = (time.perf_counter() - t1) * 1e3 / C5_HALO_STEPS
    _, colls, staged = _counts()
    valid_out = outs["valid"]
    finite = bool(torch.isfinite(outs["positions"][valid_out]).all()
                  and torch.isfinite(outs["temperatures"][valid_out]).all())
    out["rollout"] = {"ms": rollout_ms, "exchange_ms": sum(_span_ms(spans["exchange"]))
                      / C5_HALO_STEPS,
                      "featurize_ms": _span_ms(spans["featurize"]),
                      "model_ms": _span_ms(spans["model"]),
                      "ppermute": colls["ppermute"] / C5_HALO_STEPS,
                      "staged": staged / C5_HALO_STEPS, "finite": finite,
                      "count": valid_out.sum(dim=1).cpu().numpy(),
                      "diag": {k: int(v) for k, v in diag.items()},
                      "exact": exact.cpu().numpy(),
                      "certs": {k: v.cpu().numpy() for k, v in certs.items()},
                      "peak": torch.cuda.max_memory_allocated() / 2**30}
    _progress(mesh, t_spawn, f"{C5_HALO_STEPS} rollout steps, {rollout_ms:.1f} ms a step")
    del outs, valid_out, fn, args
    torch.cuda.empty_cache()

    hc_t = halo.choose_halo_config(C5_N, C5_K, p, noise=True)
    spec_t = cellblock.choose_cellblock_spec_halo(C5_N, hc_t.grid_size, hc_t.slab_layers,
                                                  hc_t.halo_layers, p, query_block=C5_HALO_QB)
    local = {key: value.to(dev) for key, value in _fed(feed).items()}
    sgd = _sgd()
    step = halo.make_halo_train_step(cfg, stats, _train_row(), sgd, mesh, hc_t,
                                     cellblock_spec=spec_t)
    _progress(mesh, t_spawn, "train batch received")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t1 = time.perf_counter()
    _, _, metrics = step(params, sgd.init(params), local,
                         torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    train_ms = (time.perf_counter() - t1) * 1e3
    launches, colls, staged = _counts()
    out["train"] = {"ms": train_ms, "exchange_ms": sum(_span_ms(spans["exchange"])),
                    "ppermute": colls["ppermute"], "staged": staged,
                    "loss": float(metrics["loss"]), "launches": launches,
                    "hc": tuple(hc_t), "spec": tuple(spec_t),
                    "peak": torch.cuda.max_memory_allocated() / 2**30}
    _progress(mesh, t_spawn, f"train step {train_ms:.1f} ms")
    return out


def halo_flagship_task(mesh, seed, t_spawn):
    """17a's rollouts, then at 4 shards 17b's train and eval steps."""
    out = {"rollouts": halo_rollout_task(mesh, seed, t_spawn)}
    if mesh.shape["particle"] == 4:
        out["train"] = halo_train_task(mesh, seed, t_spawn)
    torch.cuda.empty_cache()
    return out


def _leading_mesh(p, dev):
    """A ``(1, p)`` mesh over the world's first p ranks, None on the others.
    Every rank makes every group, in the same order (``new_group``'s
    contract); ``make_mesh`` spans the whole world, so this mesh is laid
    out here."""
    import torch.distributed as dist

    from cosmology_gnn_simulation_tpu_torch.parallel.mesh import Mesh, MeshAxis

    rank = dist.get_rank()
    particle = dist.new_group(list(range(p)))
    data = [dist.new_group([r]) for r in range(p)]
    if rank >= p:
        return None
    return Mesh(("data", "particle"), np.arange(p).reshape(1, p), rank,
                {"data": MeshAxis("data", data[rank], 1, 0),
                 "particle": MeshAxis("particle", particle, p, rank)}, dev)


def _halo_rank(world, t_spawn, seed, feeds):
    """One spawned rank, in the gloo group on cuda:0 (no kernel is built
    here: the parent built them all). Four ranks run 17a at each of
    HALO_SHARDS (a shard count below the world's on the first ranks while
    the others wait) and 17b on the world; C5_SHARDS ranks run 17c.
    ``feeds``: the ranks' queues of 17c's data. Returns the results and
    this rank's clock at each turn."""
    import torch.distributed as dist

    from cosmology_gnn_simulation_tpu_torch import kernels
    from cosmology_gnn_simulation_tpu_torch.parallel.mesh import make_mesh

    unbuilt = [name for name in kernels.SOURCES if not kernels._library_path(name).exists()]
    if unbuilt:
        raise RuntimeError(f"kernels not built before the spawn: {unbuilt}")
    mesh = make_mesh((1, world), device="cuda:0")
    _progress(mesh, t_spawn, "in the process group")
    out = {"marks": [t_spawn, time.time()]}
    if world == C5_SHARDS:
        out["config5"] = config5_task(mesh, seed, t_spawn, feeds[mesh.rank])
    else:
        for p in HALO_SHARDS:
            # The halo train and eval steps sum over the world: 17b runs on
            # the world's mesh.
            sub = mesh if p == world else _leading_mesh(p, mesh.device)
            if sub is not None:
                out[p] = halo_flagship_task(sub, seed, t_spawn)
            dist.monitored_barrier(timeout=datetime.timedelta(seconds=HALO_RANK_TIMEOUT_S))
            out["marks"].append(time.time())
    out["marks"].append(time.time())
    return out


def run_ranks(world: int, seed: int, feed=None):
    """``world`` ranks (``parallel.local_ranks``: spawned, a file store, an
    explicitly requested gloo group on cuda:0) each running ``_halo_rank``:
    their results in rank order. ``feed(queues, seed)`` runs here while the
    ranks start and puts each rank's data on its queue. A rank that raises,
    dies or has not answered in HALO_RANK_TIMEOUT_S fails the phase; every
    rank is stopped before this returns."""
    import torch.multiprocessing as mp

    from cosmology_gnn_simulation_tpu_torch.parallel.local_ranks import LocalRanks

    feeds = [] if feed is None else [mp.get_context("spawn").Queue() for _ in range(world)]
    for queue in feeds:
        queue.cancel_join_thread()  # a rank that never reads must not hold up the exit
    ranks = LocalRanks(world, _halo_rank, (world, time.time(), seed, feeds), device="cuda:0",
                       backend="gloo", timeout_s=HALO_RANK_TIMEOUT_S,
                       collective_timeout=datetime.timedelta(seconds=HALO_TIMEOUT_S))
    try:
        if feed is not None:
            feed(feeds, seed)
    except BaseException:
        for queue in feeds:
            queue.put(None)  # the waiting ranks raise at once
        with contextlib.suppress(RuntimeError):
            ranks.results()  # stops every rank
        raise
    try:
        return ranks.results()
    except RuntimeError as err:
        fail(f"halo ranks ({world}): {err}")


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def _check_halo_rollouts(p, ranks, refs, pos, temp, zero, mp, summary):
    """17a's checks of one spawn's halo rollouts (see the module docstring)."""
    from cosmology_gnn_simulation_tpu_torch.parallel import halo

    per_step = {"gather f32": ({}, {"all_gather": 1, "all_reduce": 0, "broadcast": 0,
                                    "ppermute": 2 + 2 * mp + 2}),
                "hybrid bf16": ({"s_onehot": 1, "window_matmul": mp, "fused_tail": mp},
                                {"all_gather": 1, "all_reduce": 0, "broadcast": 0,
                                 "ppermute": 2 + 2 * mp + 2})}
    tols = {"gather f32": HALO_GATHER_TOL, "hybrid bf16": HALO_HYBRID_TOL}
    print(f"halo ranks P={p} on {torch.cuda.get_device_name(0)}: process group backends "
          f"{ranks[0]['backends']} (every rank on cuda:0); {halo.HaloConfig(*ranks[0]['hc'])}; "
          f"slab spec {ranks[0]['spec']}")
    for label in ("gather f32", "hybrid bf16"):
        got = [r[label] for r in ranks]
        outs = {key: np.concatenate([g["outs"][key] for g in got], axis=1)
                for key in got[0]["outs"]}
        traj = halo.reassemble_trajectory(outs, pos, temp)
        err = max(float(np.abs(traj[key] - refs[label][key]).max())
                  for key in ("Coordinates", "InternalEnergy"))
        finite = bool(np.isfinite(traj["Coordinates"]).all())
        launches = {**zero, **{k: v * HALO_STEPS for k, v in per_step[label][0].items()}}
        colls = {k: v * HALO_STEPS for k, v in per_step[label][1].items()}
        counts_ok = all(g["launches"] == launches and g["collectives"] == colls for g in got)
        cert_ok = all(g["exact"].all() and g["diag"] == {"overflow": 0, "stranded": 0}
                      for g in got)
        conserved = bool((outs["valid"].sum(axis=1) == N).all())
        last = got[0]["outs"]
        moved = set(ranks[0]["initial_gid"].tolist()) != set(
            last["gid"][-1][last["valid"][-1]].tolist())
        if not (err <= tols[label] and finite and counts_ok and cert_ok and conserved and moved):
            fail(f"halo {label} rollout P={p}: max diff {err} (tol {tols[label]}), finite "
                 f"{finite}, counts {[(g['launches'], g['collectives']) for g in got]} "
                 f"(expected {launches}, {colls}), certificate {[g['exact'] for g in got]}, "
                 f"diag {[g['diag'] for g in got]}, count conserved {conserved}, a gid "
                 f"changed shard {moved}")
        summary[f"rollout {label} P={p}"] = [g["ms"] for g in got]
        print(f"halo {label} rollout P={p}: N={N}, {HALO_STEPS} steps, within {err:.3g} of the "
              f"single-device rollout (tol {tols[label]}); certificate true every step, "
              f"overflow and stranded 0, count conserved, rank 0's gids changed; per rank "
              f"and step launches {_nonzero(per_step[label][0])}, collectives "
              f"{_nonzero(per_step[label][1])}; host-staged bytes a step per rank "
              f"{[g['staged'] // HALO_STEPS for g in got]}; ms a step per rank "
              f"{[round(g['ms'], 3) for g in got]}; max excess "
              f"{float(got[0]['certs']['max_excess_sq'].max()):.4g}")


def _check_halo_train(p, ranks, refs, zero, mp, summary):
    """17b's checks of the halo train and eval steps (see the module
    docstring)."""
    from cosmology_gnn_simulation_tpu_torch.parallel import halo

    want = {**zero, "s_onehot": 1, "reverse_table": 1, "window_matmul": mp,
            "window_matmul_t": mp, "fused_tail": mp, "fused_tail_bwd": mp}
    want_colls = {"all_gather": 0, "all_reduce": 3, "broadcast": 0, "ppermute": 2 + 4 * mp}
    want_eval = {**zero, "fused_tail": mp}
    want_eval_colls = {"all_gather": 1, "all_reduce": 1, "broadcast": 0, "ppermute": 2 + 2 * mp}
    single_loss, single_grads = refs["train"]
    got = ranks[0]
    loss_err = abs(got["metrics"]["loss"] - single_loss) / abs(single_loss)
    grad_err = max(float(np.abs(a - b).max()) / float(np.abs(b).max())
                   for a, b in zip(got["grads"], single_grads) if np.abs(b).max())
    same = all(all(np.array_equal(a, b) for a, b in zip(r["grads"], got["grads"]))
               for r in ranks[1:])
    counts_ok = all(r["launches"] == want and r["collectives"] == want_colls
                    and r["eval_launches"] == want_eval and r["eval_collectives"] == want_eval_colls
                    for r in ranks)
    eval_err = max(abs(float(got["eval"][k][0]) - refs["eval"][k])
                   / max(abs(refs["eval"][k]), 1e-30) for k in got["eval"])
    if not (loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_TOL and same and counts_ok
            and eval_err <= TRAIN_LOSS_RTOL):
        fail(f"halo train step P={p}: loss rel err {loss_err}, worst gradient rel err {grad_err}, "
             f"updates equal on every rank {same}, counts "
             f"{[(r['launches'], r['collectives'], r['eval_launches'], r['eval_collectives']) for r in ranks]}, "
             f"eval rel err {eval_err}")
    summary[f"train P={p}"] = [r["ms"] for r in ranks]
    print(f"halo x cell-block train step P={p} (flagship row: N={N}, bf16, noise {TRAIN_NOISE} "
          f"keyed per particle, no augmentation, reverse plans; {halo.HaloConfig(*got['hc'])}; "
          f"slab spec {got['spec']}): loss {got['metrics']['loss']:.6g} (single-device "
          f"{single_loss:.6g}, rel err {loss_err:.3g}, tol {TRAIN_LOSS_RTOL}), worst "
          f"gradient leaf rel err {grad_err:.3g} (tol {TRAIN_GRAD_TOL}), the same update on every "
          f"rank; per rank launches {_nonzero(want)}, collectives {_nonzero(want_colls)}, "
          f"host-staged bytes {[r['staged'] for r in ranks]}; ms of a second step per rank "
          f"{[round(r['ms'], 3) for r in ranks]}; peak GiB per rank "
          f"{[round(r['peak'], 3) for r in ranks]}; the halo eval step's per-sample metrics "
          f"within {eval_err:.3g} of the single-device eval step's (launches "
          f"{_nonzero(want_eval)}, collectives {_nonzero(want_eval_colls)})")


def halo_ranks_phase(args, dev, zero):
    """Phase 17 (the halo paths on ranks that share the card; see the module
    docstring). Returns the numbers the summary line prints."""
    from cosmology_gnn_simulation_tpu_torch.parallel import halo
    from cosmology_gnn_simulation_tpu_torch.rollout import rollout
    from cosmology_gnn_simulation_tpu_torch.training import make_eval_step, make_train_step
    from cosmology_gnn_simulation_tpu_torch.types import tree_leaves

    torch.cuda.empty_cache()
    summary = {}
    cfg, stats, params = _halo_setup(args.seed, dev)
    mp = cfg.num_message_passing_steps
    # The ranks' exchanges run on the host's cores: the parent, waiting,
    # keeps one thread.
    threads = torch.get_num_threads()

    # The single-device references: 17a's rollouts, 17b's SGD step (lr 1:
    # the update is the gradient) and eval step, from the same weights.
    t0 = time.perf_counter()
    pos, temp = seed_window(N, args.seed)
    refs = {"gather f32": rollout(params, cfg, pos, temp, stats, HALO_STEPS,
                                  aggregation="gather", num_neighbors=K, device=dev),
            "hybrid bf16": rollout(params, cfg, pos, temp, stats, HALO_STEPS,
                                   aggregation="cellblock_hybrid", num_neighbors=K,
                                   dtype=torch.bfloat16, device=dev)}
    refs = {k: {key: v[key].cpu().numpy() for key in ("Coordinates", "InternalEnergy")}
            for k, v in refs.items()}
    tbatch = train_batch(N, args.seed)
    sgd = _sgd()
    before = [t.detach().clone() for t in tree_leaves(params)]
    _, _, m_single = make_train_step(cfg, stats, _train_row(), sgd)(
        params, sgd.init(params), tbatch, torch.Generator(device=dev).manual_seed(args.seed))
    refs["train"] = (float(m_single["loss"]),
                     [(b - a.detach()).cpu().numpy() for b, a in zip(before, tree_leaves(params))])
    _, _, params = _halo_setup(args.seed, dev)
    # The halo eval step aggregates by gather (as JAX's).
    single_eval = make_eval_step(cfg, stats, dataclasses.replace(_train_row(),
                                                                 aggregation="gather"))(
        params, tbatch)
    refs["eval"] = {k: float(v) for k, v in single_eval.items()}
    del before, params, single_eval, tbatch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"phase 17 single-device references: {time.perf_counter() - t0:.1f} s")

    # ---- 17a and 17b: the flagship on 2 and 4 of 4 ranks -------------
    torch.set_num_threads(1)
    torch.cuda.empty_cache()
    world = max(HALO_SHARDS)
    ranks = run_ranks(world, args.seed)
    marks = ranks[0]["marks"]
    print(f"phase 17 ranks: {world} in the process group {marks[1] - marks[0]:.1f} s after the "
          f"spawn")
    for i, p in enumerate(HALO_SHARDS):
        _check_halo_rollouts(p, [r[p]["rollouts"] for r in ranks[:p]], refs, pos, temp, zero,
                             mp, summary)
        if p == 4:
            _check_halo_train(p, [r[p]["train"] for r in ranks[:p]], refs, zero, mp, summary)
        print(f"phase 17{'a' if p != 4 else 'a, 17b'} halo flagship P={p} (ranks 0-{p - 1} of "
              f"{world}): {marks[i + 2] - marks[i + 1]:.1f} s")
    print(f"phase 17a, 17b: {marks[-1] - marks[0]:.1f} s from the spawn")

    # ---- 17c. config 5 over its 8 shards -------------------------------
    torch.cuda.empty_cache()
    print(f"the parent holds {torch.cuda.memory_allocated() / 2**30:.3f} GiB of the card "
          f"({torch.cuda.memory_reserved() / 2**30:.3f} reserved) before the spawn")
    ranks = run_ranks(C5_SHARDS, args.seed, _feed_config5)
    marks = ranks[0]["marks"]
    print(f"phase 17c ranks: {C5_SHARDS} in the process group {marks[1] - marks[0]:.1f} s after "
          f"the spawn")
    ranks = [r["config5"] for r in ranks]
    c5_train = [r["train"] for r in ranks]
    k0 = ranks[0]["kernels"]
    k_want = {**zero, "s_onehot": 1, "reverse_table": 1, "window_matmul": 1,
              "window_matmul_t": 1}
    rolls = [r["rollout"] for r in ranks]
    certs = rolls[0]["certs"]
    # Every component of the certificate is 0 at every step (the search's,
    # the migration's and the plans'), so the certificate holds.
    cert_ok = (all(not certs[k].any() for k in certs if not k.startswith("max"))
               and (certs["max_excess_sq"] <= 0).all() and all(r["exact"].all() for r in rolls)
               and all(r["plan"]["overflow"] == r["plan"]["dropped"]
                       == r["plan"]["reverse_mismatch"] == 0 for r in ranks))
    count = sum(r["count"] for r in rolls)
    if not (k0["launches"] == k_want and cert_ok and all(r["finite"] for r in rolls)
            and (count == C5_N).all() and all(r["diag"] == {"overflow": 0, "stranded": 0}
                                               for r in rolls)
            and all(np.isfinite(r["loss"]) for r in c5_train)):
        fail(f"config 5 halo: kernel launches {k0['launches']}, certificate {certs}, exact "
             f"{[r['exact'] for r in rolls]}, first plans {[r['plan'] for r in ranks]}, finite "
             f"{[r['finite'] for r in rolls]}, count {count}, diag {[r['diag'] for r in rolls]}, "
             f"train losses {[r['loss'] for r in c5_train]}")
    summary["config5 rollout"] = [r["ms"] for r in rolls]
    summary["config5 train"] = [r["ms"] for r in c5_train]
    print(f"config 5 halo ({C5_SHARDS} ranks on cuda:0, N={C5_N}, k={C5_K}): "
          f"{halo.HaloConfig(*ranks[0]['hc'])}, slab spec {ranks[0]['spec']} (query_block "
          f"{C5_HALO_QB}); every rank's featurize_halo plan of the first frame: overflow, "
          f"dropped edges, reverse mismatch 0 (rows past a window, per rank: "
          f"{[r['plan']['window_overflow'] for r in ranks]}), its exchanged candidates "
          f"bit-equal to the host mirror; rank 0's plan ({k0['edges']} edges): S and S_rev "
          f"bit-equal to K3's and K7's plain versions, K4 max abs err {k0['errs']['K4']:.3g}, "
          f"K4^T {k0['errs']['K4^T']:.3g} (tol {K4_MAX_ABS_TOL}); {C5_HALO_STEPS} rollout "
          f"steps bf16: every certificate component 0 every step (halo, cell, migration and "
          f"plan overflow, stranded, dropped edges), max excess "
          f"{float(certs['max_excess_sq'].max()):.4g}, certificate "
          f"{rolls[0]['exact'].tolist()}; outputs finite, count conserved")
    for q, r in enumerate(rolls):
        print(f"  config 5 rank {q}: rollout {r['ms']:.1f} ms a step (the call's first step "
              f"included), featurize_halo per step "
              f"{[round(v, 1) for v in r['featurize_ms']]} ms, the model "
              f"{[round(v, 1) for v in r['model_ms']]} ms (each with its exchanges), the "
              f"exchanges {r['exchange_ms']:.1f} ms a step, {r['ppermute']:.0f} permutes and "
              f"{r['staged'] / 2**20:.1f} MiB host-staged a step, peak {r['peak']:.3f} GiB")
    print(f"config 5's train step ({C5_SHARDS} ranks): {halo.HaloConfig(*c5_train[0]['hc'])}, "
          f"slab spec {c5_train[0]['spec']}; the training row (noise {TRAIN_NOISE} keyed per "
          f"particle, remat_chunk {C5_REMAT_CHUNK}), loss {c5_train[0]['loss']:.6g}, launches "
          f"{_nonzero(c5_train[0]['launches'])}")
    for q, r in enumerate(c5_train):
        print(f"  config 5 train rank {q}: {r['ms']:.1f} ms (the first step), its exchanges "
              f"{r['exchange_ms']:.1f} ms, {r['ppermute']} permutes, "
              f"{r['staged'] / 2**20:.1f} MiB host-staged, peak {r['peak']:.3f} GiB")
    print(f"phase 17c config-5 halo: {marks[-1] - marks[0]:.1f} s from the spawn")
    torch.set_num_threads(threads)
    return summary


# ---------------------------------------------------------------------------
# Phase 18: the native loader and the halo path's entry points
# ---------------------------------------------------------------------------


def _sync_calls(fn):
    """``fn()`` under CUDA's sync debug mode: its result and the
    synchronizing calls it made (each one's warning)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, [w for w in caught if "synchronizing CUDA operation" in str(w.message)]


def _batch_arrays(batch):
    """(name, array) of every array of a batch, the extras' too, by name."""
    for key, value in sorted(batch.items()):
        if isinstance(value, dict):
            yield from ((f"{key}.{name}", v) for name, v in sorted(value.items()))
        else:
            yield key, value


def _states_equal(a, b) -> float:
    """The largest difference between two saved states' params and Adam
    state (0.0: bit-equal)."""
    from cosmology_gnn_simulation_tpu_torch.types import tree_leaves

    diffs = [float((x - y).abs().max()) for x, y in zip(tree_leaves(a["params"]),
                                                         tree_leaves(b["params"]), strict=True)]
    for i, state in a["optimizer"]["state"].items():
        other = b["optimizer"]["state"][i]
        diffs += [float((state[key].float() - other[key].float()).abs().max())
                  for key in ("step", "exp_avg", "exp_avg_sq")]
    return max(diffs)


def _files(path):
    return sorted(os.listdir(path)) if os.path.isdir(path) else []


def native_loader_phase(dev, cfg, stats, fit_sims, fit_tc, epoch0, memory_step_ms, work):
    """Phase 18a (see the module docstring). Returns the caches' paths and
    the numbers the summary line prints."""
    from cosmology_gnn_simulation_tpu_torch.data import native_loader
    from cosmology_gnn_simulation_tpu_torch.training import Trainer
    from cosmology_gnn_simulation_tpu_torch.utils import checkpoint as ckpt_lib

    t0 = time.perf_counter()
    lib = native_loader.build()
    build_s = time.perf_counter() - t0
    print(f"native loader: g++ {' '.join(native_loader.CXX_FLAGS)} "
          f"{os.path.relpath(native_loader.SOURCE)} -> {os.path.relpath(lib)}: {build_s:.2f} s")
    caches = {name: native_loader.write_cache(sim, os.path.join(work, f"{name}.cgnn"))
              for name, sim in fit_sims.items()}
    feeds = {name: native_loader.NativeSequenceLoader([path], WINDOW, pin_memory=True)
             for name, path in caches.items()}
    memory = {name: MemoryDataset([sim]) for name, sim in fit_sims.items()}

    # Bit-equal batches: shuffle off, on (phase 12's seed), and on with the
    # extras and a tail batch; every buffer pinned.
    cases = [(1, dict(shuffle=False)), (1, dict(shuffle=True, seed=fit_tc.seed)),
             (3, dict(shuffle=True, seed=fit_tc.seed + 1, drop_remainder=False,
                      include_extras=True))]
    arrays = 0
    for name in feeds:
        for size, kw in cases:
            got, want = list(feeds[name].batches(size, **kw)), list(memory[name].batches(size, **kw))
            if len(got) != len(want):
                fail(f"native loader {name} {kw}: {len(got)} batches, MemoryDataset {len(want)}")
            for a, b in zip(got, want):
                pairs = list(zip(_batch_arrays(a), _batch_arrays(b), strict=True))
                for (key, x), (other, y) in pairs:
                    if key != other or not x.is_pinned() or not torch.equal(
                            x, torch.from_numpy(np.ascontiguousarray(y))):
                        fail(f"native loader {name} {kw}: {key} (pinned {x.is_pinned()}) differs "
                             f"from MemoryDataset's {other}")
                arrays += len(pairs)

    def host_ms(feed, reps=5):
        count, t = 0, time.perf_counter()
        for _ in range(reps):
            count += sum(1 for _ in feed.batches(1, shuffle=True, seed=fit_tc.seed))
        return (time.perf_counter() - t) * 1e3 / count

    host = {"memory": host_ms(memory["train"]), "native pinned": host_ms(feeds["train"])}

    # Phase 12's first epoch again, from the native feed.
    refit_tc = dataclasses.replace(fit_tc, num_epochs=1, output_dir=os.path.join(work, "refit"))
    refit = Trainer(cfg, stats, refit_tc, len(feeds["train"]), device=dev)
    spans, step = [], refit.train_step

    def timed(*step_args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(*step_args)
        end.record()
        spans.append((start, end))
        return out

    refit.train_step = timed
    refit.fit(feeds["train"], feeds["val"], verbose=False)
    torch.cuda.synchronize()
    native_step_ms = [start.elapsed_time(end) for start, end in spans]
    diff = _states_equal(ckpt_lib.load_state(os.path.join(refit_tc.output_dir, "model_epoch_0")),
                         epoch0)
    if diff != 0:
        fail(f"the native feed's refit of phase 12's first epoch differs from it by {diff} "
             "(params and Adam state of model_epoch_0)")
    # One more train step from each feed under CUDA's sync debug mode.
    syncs = {}
    for label, dataset in (("pinned", feeds["train"]), ("pageable", memory["train"])):
        batch = next(iter(dataset.batches(1, shuffle=False)))
        _, calls = _sync_calls(lambda: refit.train_step(refit.params, refit.opt_state, batch,
                                                        refit.generator))
        syncs[label] = len(calls)
    for feed in feeds.values():
        feed.close()
    print(f"native loader feed: caches of phase 12's simulations (N={N}; "
          f"{', '.join(f'{n} {os.path.getsize(p) / 2**20:.1f} MiB' for n, p in caches.items())}); "
          f"batches bit-equal to MemoryDataset's ({arrays} arrays: shuffle off, on, and with the "
          f"extras and a tail batch), every buffer pinned; host ms per batch (batch 1, the "
          f"training set, 5 epochs): {', '.join(f'{k} {v:.4f}' for k, v in host.items())}; "
          f"phase 12's first epoch refitted from the native feed: model_epoch_0 params and Adam "
          f"state bit-equal; ms per train step inside fit (CUDA events): memory feed (phase 12a, "
          f"epoch 0) {[round(x, 4) for x in memory_step_ms]}, native pinned feed "
          f"{[round(x, 4) for x in native_step_ms]}; synchronizing calls in one train step: "
          f"pinned feed {syncs['pinned']}, pageable {syncs['pageable']}")
    return {"caches": caches, "build_s": build_s, "host_ms": host, "step_ms": native_step_ms,
            "syncs": syncs}


class _StepLog:
    """Wraps ``Trainer.fit`` in this process so that every train step of a
    fit logs its loss, its CUDA-event span, its kernel launches, collectives
    and host-staged bytes; the params after the last step are kept as one
    flat copy on the device. ``read()`` waits for the device and returns
    (and clears) them."""

    def __init__(self):
        from cosmology_gnn_simulation_tpu_torch.training.trainer import Trainer
        from cosmology_gnn_simulation_tpu_torch.types import tree_leaves

        self.steps, self.flat = [], None
        fit, log = Trainer.fit, self

        def logged_fit(trainer, *args, **kwargs):
            step = trainer.train_step

            def logged(*step_args):
                _reset_counts()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = step(*step_args)
                end.record()
                launches, colls, staged = _counts()
                log.steps.append((start, end, out[2]["loss"], _nonzero(launches), colls, staged))
                log.flat = torch.cat([t.detach().reshape(-1) for t in tree_leaves(out[0])])
                return out

            trainer.train_step = logged
            return fit(trainer, *args, **kwargs)

        Trainer.fit = logged_fit

    def read(self):
        torch.cuda.synchronize()
        steps = [{"ms": start.elapsed_time(end), "loss": float(loss), "launches": launches,
                  "collectives": colls, "staged": staged}
                 for start, end, loss, launches, colls, staged in self.steps]
        flat = self.flat.cpu().numpy()
        self.steps, self.flat = [], None
        return steps, flat


def render_truth(seed):
    """render's ground truth: the flagship seed window and HALO_STEPS more
    frames (its last frame again)."""
    pos, temp = seed_window(N, seed)
    return {"Coordinates": np.concatenate([pos, np.repeat(pos[-1:], HALO_STEPS, axis=0)]),
            "InternalEnergy": np.concatenate([temp, np.repeat(temp[-1:], HALO_STEPS, axis=0)])}


def entry_train_argv(seed, world):
    """18b's cli.train flags: the default model, k = 16, bf16, noise
    TRAIN_NOISE, no augmentation, 2 epochs of batch 1, every epoch saved;
    ``world`` spatial shards over ranks that share cuda:0 by gloo."""
    return ["--train_dir", "native", "--val_dir", "native", "--metadata_path", "in-memory",
            "--spatial_shards", str(world), "--dist_backend", "gloo", "--device", "cuda:0",
            "--num_neighbors", str(K), "--compute_dtype", "bfloat16",
            "--noise_std", str(TRAIN_NOISE), "--augment_prob", "0", "--num_epochs", "2",
            "--batch_size", "1", "--save_every", "1", "--seed", str(seed)]


def entry_render_argv(shards, output_dir):
    """18c's cli.render_rollout flags (``shards`` 0: the single device)."""
    argv = ["--model_path", "in-memory", "--test_data", "in-memory", "--metadata_path",
            "in-memory", "--num_neighbors", str(K), "--num_steps", str(HALO_STEPS),
            "--device", "cuda:0", "--output_dir", output_dir]
    return argv + (["--spatial_shards", str(shards), "--dist_backend", "gloo"] if shards else [])


def _entry_rank(world, t_spawn, seed, caches, work):
    """One spawned rank of phase 18 (in the gloo group on cuda:0): 18b's
    halo Trainer through cli.train's body on the native feed, continuous
    and resumed from rank 0's model_epoch_0, then 18c's cli.render_rollout
    body at each of ENTRY_RENDER_SHARDS. Returns the results and this
    rank's clock at each turn."""
    import torch.distributed as dist

    from cosmology_gnn_simulation_tpu_torch.cli import render_rollout
    from cosmology_gnn_simulation_tpu_torch.cli import train as train_cli
    from cosmology_gnn_simulation_tpu_torch.config import build_train_parser
    from cosmology_gnn_simulation_tpu_torch.data import native_loader
    from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
        default_model_config,
        init_encode_process_decode,
    )
    from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats

    rank = dist.get_rank()
    out = {"marks": [t_spawn, time.time()]}
    stats = NormalizationStats.from_metadata(METADATA, device="cpu")
    log = _StepLog()
    argv = entry_train_argv(seed, world)
    torch.cuda.reset_peak_memory_stats()
    for label, extra in (("continuous", []), ("resumed", [
            "--resume", os.path.join(work, "continuous", "rank0", "model_epoch_0")])):
        output_dir = os.path.join(work, label, f"rank{rank}")
        args = build_train_parser().parse_args([*argv, "--output_dir", output_dir, *extra])
        feeds = [native_loader.NativeSequenceLoader([caches[name]], WINDOW, pin_memory=True)
                 for name in ("train", "val")]
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            trainer = train_cli.train(args, stats, *feeds)
        steps, flat = log.read()
        out[label] = {"history": trainer.history, "steps": steps, "flat": flat,
                      "files": _files(output_dir), "printed": printed.getvalue(),
                      "mesh": trainer.mesh.shape, "halo": tuple(trainer.halo)}
        del trainer, feeds
        dist.barrier()  # rank 0's checkpoints are written
        _progress_rank(rank, t_spawn, f"18b {label}")
        out["marks"].append(time.time())
    out["train_peak"] = torch.cuda.max_memory_allocated() / 2**30

    cfg = default_model_config()
    params = init_encode_process_decode(cfg, torch.Generator().manual_seed(seed), device="cpu")
    truth = render_truth(seed)
    spans, run = [], render_rollout.run_halo_rollout

    def timed_run(*run_args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = run(*run_args, **kwargs)
        torch.cuda.synchronize()
        spans.append(((time.perf_counter() - t0) * 1e3, run_args[6].shape))  # the mesh's
        return result

    render_rollout.run_halo_rollout = timed_run
    for shards in ENTRY_RENDER_SHARDS:
        output_dir = os.path.join(work, f"render{shards}", f"rank{rank}")
        args = render_rollout.build_parser().parse_args(entry_render_argv(shards, output_dir))
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            errors = render_rollout.render(args, params, cfg, stats, truth)
        ms, mesh_shape = spans[-1]
        out[f"render{shards}"] = {"errors": errors, "files": _files(output_dir),
                                  "printed": printed.getvalue(), "ms": ms / HALO_STEPS,
                                  "mesh": mesh_shape}
        _progress_rank(rank, t_spawn, f"18c render P={shards}")
        out["marks"].append(time.time())
    return out


def _progress_rank(rank, t_spawn, msg):
    if rank == 0:
        print(f"  phase 18 rank 0: {msg} at {time.time() - t_spawn:.1f} s", flush=True)


def _entry_references(args, dev, cfg, stats, caches, work):
    """18b's and 18c's single-device references, made while the ranks
    start: the single-device Trainer(partition_invariant_noise=True) over
    the native feed for 18b's first epoch (its per-step losses), and
    render_rollout's body on one device."""
    from cosmology_gnn_simulation_tpu_torch.cli import render_rollout
    from cosmology_gnn_simulation_tpu_torch.data import native_loader
    from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
        init_encode_process_decode,
    )
    from cosmology_gnn_simulation_tpu_torch.training import TrainConfig, Trainer

    tc = TrainConfig(num_neighbors=K, batch_size=1, compute_dtype="bfloat16",
                     noise_std=TRAIN_NOISE, augment_prob=0.0, num_epochs=1, seed=args.seed,
                     partition_invariant_noise=True, output_dir=os.path.join(work, "single"))
    feeds = [native_loader.NativeSequenceLoader([caches[name]], WINDOW, pin_memory=True)
             for name in ("train", "val")]
    single = Trainer(cfg, stats, tc, len(feeds[0]), device=dev)
    losses, step = [], single.train_step

    def logged(*step_args):
        out = step(*step_args)
        losses.append(out[2]["loss"])
        return out

    single.train_step = logged
    single.fit(*feeds, verbose=False)
    losses = [float(v) for v in losses]
    output_dir = os.path.join(work, "render_single")
    params = init_encode_process_decode(cfg, torch.Generator().manual_seed(args.seed), device=dev)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        errors = render_rollout.render(
            render_rollout.build_parser().parse_args(entry_render_argv(0, output_dir)),
            params, cfg, stats, render_truth(args.seed))
    return {"losses": losses, "errors": errors,
            "coords": np.load(os.path.join(output_dir, "rollout_coordinates.npy"))}


def entry_points_phase(args, dev, zero, cfg, stats, fit_sims, fit_tc, fit_epoch0,
                       memory_step_ms):
    """Phase 18 (see the module docstring): 18a in this process, then 18b
    and 18c on ENTRY_WORLD ranks that share the card. Returns the numbers
    the summary line prints."""
    from cosmology_gnn_simulation_tpu_torch.ops.fused_step import resolve_fused_tail
    from cosmology_gnn_simulation_tpu_torch.parallel.local_ranks import LocalRanks
    from cosmology_gnn_simulation_tpu_torch.utils import checkpoint as ckpt_lib

    t_phase = time.perf_counter()
    work_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_entry_")
    work = work_dir.name
    threads = torch.get_num_threads()
    try:
        torch.cuda.empty_cache()
        native = native_loader_phase(dev, cfg, stats, fit_sims, fit_tc, fit_epoch0,
                                     memory_step_ms, work)
        print(f"phase 18a native loader: {time.perf_counter() - t_phase:.1f} s")

        # ---- 18b, 18c: the halo entry points on 4 ranks ---------------------
        t0 = time.perf_counter()
        torch.set_num_threads(1)  # the ranks' host work has the cores
        ranks = LocalRanks(ENTRY_WORLD, _entry_rank,
                           (ENTRY_WORLD, time.time(), args.seed, native["caches"], work),
                           device="cuda:0", backend="gloo", timeout_s=HALO_RANK_TIMEOUT_S,
                           collective_timeout=datetime.timedelta(seconds=HALO_TIMEOUT_S))
        try:
            refs = _entry_references(args, dev, cfg, stats, native["caches"], work)
            refs_s = time.perf_counter() - t0
        except BaseException:
            with contextlib.suppress(RuntimeError):
                ranks.results()  # stops every rank
            raise
        try:
            results = ranks.results()
        except RuntimeError as err:
            fail(f"phase 18 ranks: {err}")
        marks = results[0]["marks"]
        print(f"phase 18 ranks: {ENTRY_WORLD} in the process group {marks[1] - marks[0]:.1f} s "
              f"after the spawn; the single-device references took {refs_s:.1f} s meanwhile, "
              f"the ranks {time.perf_counter() - t0:.1f} s in all")
        summary = {"18a": native}
        summary["18b"] = _check_entry_train(results, refs, cfg, work, ckpt_lib,
                                            resolve_fused_tail(None, cfg, dev, torch.bfloat16))
        print(f"phase 18b halo Trainer through cli.train: {marks[3] - marks[1]:.1f} s")
        summary["18c"] = _check_entry_render(results, refs, work)
        print(f"phase 18c render_rollout: {marks[-1] - marks[3]:.1f} s")
    finally:
        torch.set_num_threads(threads)
        work_dir.cleanup()
    summary["s"] = time.perf_counter() - t_phase
    print(f"phase 18 entry points: {summary['s']:.1f} s")
    return summary


def _check_entry_train(results, refs, cfg, work, ckpt_lib, fused):
    """18b's checks (see the module docstring); returns the per-rank
    numbers."""
    mp = cfg.num_message_passing_steps
    runs = [r["continuous"] for r in results]
    resumed = [r["resumed"] for r in results]
    step_colls = {"all_gather": 0, "all_reduce": 3, "broadcast": 0, "ppermute": 2 + 4 * mp}
    step_launches = {"fused_tail": mp, "fused_tail_bwd": mp} if fused else {}
    per_epoch = len(runs[0]["steps"]) // 2
    h = runs[0]["history"]
    finite = all(np.isfinite(h["train_loss"] + h["val_loss"])) and len(h["train_loss"]) == 2
    agree = all(r["history"] == h and np.array_equal(r["flat"], runs[0]["flat"])
                for r in runs[1:])
    exact = all(s["collectives"] == step_colls and s["launches"] == step_launches
                for r in runs + resumed for s in r["steps"])
    artifacts = {"model_best", "model_epoch_0", "model_epoch_1", "model_final",
                 "training_history.json"}
    written = artifacts <= set(runs[0]["files"]) and all(not r["files"] for r in runs[1:])
    with open(os.path.join(work, "continuous", "rank0", "training_history.json")) as f:
        saved = json.load(f)
    keys = sorted(saved) == HISTORY_KEYS and sorted(saved["component_losses"]) == COMPONENT_KEYS
    if not (finite and agree and exact and written and keys and per_epoch == 4
            and runs[0]["mesh"] == {"data": 1, "particle": ENTRY_WORLD}):
        fail(f"halo Trainer through cli.train: history {h}, ranks agree {agree}, per-step "
             f"collectives {[s['collectives'] for s in runs[0]['steps']]} (want {step_colls}), "
             f"launches {[s['launches'] for s in runs[0]['steps']]} (want {step_launches}), "
             f"files {[r['files'] for r in runs]}, history keys {sorted(saved)}, mesh "
             f"{runs[0]['mesh']}")
    # The resume from model_epoch_0 equals the continuous run bit for bit.
    a = ckpt_lib.load_state(os.path.join(work, "continuous", "rank0", "model_epoch_1"))
    b = ckpt_lib.load_state(os.path.join(work, "resumed", "rank0", "model_epoch_1"))
    diff = _states_equal(a, b)
    if (diff != 0 or not torch.equal(a["generator"], b["generator"])
            or any(r["history"] != h for r in resumed) or len(resumed[0]["steps"]) != per_epoch
            or any(r["files"] for r in resumed[1:])):
        fail(f"halo resume: largest difference {diff}, generator equal "
             f"{torch.equal(a['generator'], b['generator'])}, histories "
             f"{[r['history'] for r in resumed]}, steps {len(resumed[0]['steps'])}")
    # Against the single-device Trainer(partition_invariant_noise=True).
    halo_losses = [s["loss"] for s in runs[0]["steps"][:per_epoch]]
    rel = [abs(x - y) / abs(y) for x, y in zip(halo_losses, refs["losses"], strict=True)]
    if not (rel[0] <= ENTRY_FIRST_LOSS_RTOL and max(rel) <= ENTRY_EPOCH_LOSS_RTOL):
        fail(f"halo fit against the single-device fit: losses {halo_losses} and "
             f"{refs['losses']}, relative differences {rel}")
    hc = runs[0]["halo"]
    print(f"halo Trainer through cli.train's body ({ENTRY_WORLD} ranks on cuda:0, gloo; "
          f"--spatial_shards {ENTRY_WORLD}, mesh {runs[0]['mesh']}, HaloConfig{tuple(hc)}; the "
          f"default model bf16, k={K}, noise {TRAIN_NOISE} keyed per particle, no augmentation, "
          f"the native pinned feed, 2 epochs of {per_epoch} steps): train losses "
          f"{[float(f'{v:.6g}') for v in h['train_loss']]}, val losses "
          f"{[float(f'{v:.6g}') for v in h['val_loss']]}; params after the last step and "
          f"history equal on every rank; rank 0 alone wrote {sorted(artifacts)}; per train step "
          f"launches {step_launches or 'none'} and collectives {step_colls} on every rank; "
          f"model_epoch_0 restored and epoch 1 refitted: model_epoch_1 params, Adam state and "
          f"generator bit-equal, history equal; epoch 0's step losses against the "
          f"single-device Trainer(partition_invariant_noise=True) on the same feed: relative "
          f"differences {[float(f'{x:.3g}') for x in rel]} (first step tol "
          f"{ENTRY_FIRST_LOSS_RTOL}, the epoch's {ENTRY_EPOCH_LOSS_RTOL})")
    numbers = []
    for q, (r, s) in enumerate(zip(runs, results)):
        later = [st["ms"] for st in r["steps"][1:]]
        numbers.append(float(np.mean(later)))
        print(f"  18b rank {q}: ms per train step inside fit (CUDA events; the first "
              f"{r['steps'][0]['ms']:.1f}, then mean {np.mean(later):.1f}, "
              f"{[round(v, 1) for v in later]}), {r['steps'][1]['staged']} bytes host-staged "
              f"a step, peak {s['train_peak']:.3f} GiB")
    return numbers


def _check_entry_render(results, refs, work):
    """18c's checks (see the module docstring); returns each rank's ms a
    step per shard count."""
    numbers = {}
    for shards in ENTRY_RENDER_SHARDS:
        got = [r[f"render{shards}"] for r in results]
        worst = max(float(np.max(np.abs(np.asarray(g["errors"][key], np.float64)
                                        - np.asarray(value, np.float64))))
                    for g in got for key, value in refs["errors"].items())
        coords = np.load(os.path.join(work, f"render{shards}", "rank0",
                                      "rollout_coordinates.npy"))
        coord_err = float(np.abs(coords - refs["coords"]).max())
        want_mesh = {"data": ENTRY_WORLD // shards, "particle": shards}
        files = {"rollout_coordinates.npy", "rollout_temperatures.npy", "rollout_summary.txt"}
        printed_ok = all("kNN exactness certificate held for every rollout step" in g["printed"]
                         and "WARNING: halo rollout" not in g["printed"] for g in got)
        if not (worst <= HALO_GATHER_TOL and coord_err <= HALO_GATHER_TOL and printed_ok
                and all(g["mesh"] == want_mesh for g in got)
                and files <= set(got[0]["files"]) and all(not g["files"] for g in got[1:])):
            fail(f"render_rollout --spatial_shards {shards}: errors off by {worst}, positions "
                 f"by {coord_err} (tol {HALO_GATHER_TOL}), meshes {[g['mesh'] for g in got]}, "
                 f"files {[g['files'] for g in got]}, printed {[g['printed'] for g in got]}")
        numbers[shards] = [g["ms"] for g in got]
        print(f"render_rollout's body --spatial_shards {shards} (mesh {want_mesh}, "
              f"{ENTRY_WORLD} ranks on cuda:0): the flagship seed window, {HALO_STEPS} steps f32; "
              f"positions within {coord_err:.3g} and errors within {worst:.3g} of the "
              f"single-device render (tol {HALO_GATHER_TOL}); certificate held every step, no "
              f"migration overflow or stranded particle; rank 0 alone wrote "
              f"{sorted(got[0]['files'])}; ms a step per rank (run_halo_rollout, the first "
              f"step's warm-up included) {[round(v, 1) for v in numbers[shards]]}")
    return numbers


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cosmology_gnn_simulation_tpu_torch import kernels
    from cosmology_gnn_simulation_tpu_torch.models.encode_process_decode import (
        default_model_config,
        init_encode_process_decode,
        step_params,
    )
    from cosmology_gnn_simulation_tpu_torch.ops import cellblock, pallas_knn
    from cosmology_gnn_simulation_tpu_torch.ops import fused_step as fused_step_mod
    from cosmology_gnn_simulation_tpu_torch.ops.cell_list import choose_cell_grid, f32
    from cosmology_gnn_simulation_tpu_torch.ops.fused_step import (
        fused_step_tail,
        fused_step_tail_bwd,
        fused_step_tail_bwd_reference,
        fused_step_tail_reference,
    )
    from cosmology_gnn_simulation_tpu_torch.ops.neighbors import (
        knn_periodic,
        knn_periodic_reference,
    )
    from cosmology_gnn_simulation_tpu_torch.rollout import one_step_prediction, rollout
    from cosmology_gnn_simulation_tpu_torch.cli import render_rollout
    from cosmology_gnn_simulation_tpu_torch.evaluation import validate_one_step
    from cosmology_gnn_simulation_tpu_torch.data.synthetic import generate_synthetic_simulation
    from cosmology_gnn_simulation_tpu_torch.training import (
        TrainConfig,
        Trainer,
        make_optimizer,
        make_train_step,
    )
    from cosmology_gnn_simulation_tpu_torch.training.trainer import Optimizer
    from cosmology_gnn_simulation_tpu_torch.types import NormalizationStats, tree_leaves
    from cosmology_gnn_simulation_tpu_torch.utils import checkpoint as ckpt_lib

    dev = torch.device("cuda")
    t_all = time.perf_counter()
    report = {}

    # ---- 1. device and build -------------------------------------------
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    logs = kernels.build()
    for name, log in logs.items():
        print(f"--- nvcc -Xptxas -v: {name}\n{log.strip()}")
    for name in ("fused_tail_wide", "fused_tail_wide_bwd"):
        print_ptxas(logs, name)
    print(f"phase 1 device+build: {time.perf_counter() - t0:.1f} s")

    # ---- 2. K1 and K1' against their plain versions ---------------------
    t0 = time.perf_counter()
    pos0 = torch.as_tensor(seed_window(N, args.seed)[0][-1], device=dev)
    grid = choose_cell_grid(N, K)
    cap, _, spill_cap = pallas_knn.spill_layout(N, K, grid)
    g = grid.grid_size
    box = f32(1.0, dev)

    def k1_inputs(pos):
        t = pallas_knn.build_table(pos, g, cap, box)
        spill = pallas_knn.build_spill(pos, t.particle_rank, cap, spill_cap)
        return (t.x, t.y, t.z, t.ids), spill, int((t.particle_rank >= cap).sum())

    # The kernels take the box as a host number; the plain versions its f32 tensor.
    k1_args = dict(k=K, n=N, g=g, box=1.0, mi_start=pallas_knn.min_image_start(cap, spill_cap))
    ref_args = {**k1_args, "box": box}
    crammed = pos0.clone()
    # Spill frame: 40 and 30 particles pulled into two cells of capacity cap.
    crammed[:40] = torch.tensor([0.52, 0.31, 0.77], device=dev) + 0.01 * crammed[:40]
    crammed[40:70] = torch.tensor([0.995, 0.002, 0.5], device=dev) + 0.004 * crammed[40:70]
    crammed = torch.remainder(crammed, 1.0)
    # Lattice frame: the uniform frame snapped to the 2^-10 lattice, where
    # many squared distances are exactly equal (the tie order is tested).
    lattice = torch.remainder(torch.round(pos0 * 1024) / 1024, 1.0)
    frames = (("uniform", pos0), ("spill", crammed), ("lattice", lattice))
    for label, pos in frames:
        table, spill, n_spilled = k1_inputs(pos)
        ids, kth = pallas_knn.knn_select(table, spill, **k1_args)
        ref_ids, ref_kth = pallas_knn.knn_select_reference(table, spill, **ref_args)
        if not torch.equal(ids, ref_ids):
            fail(f"K1 {label}: ids differ from the plain version in "
                 f"{int((ids != ref_ids).any(1).sum())} rows")
        if not torch.equal(kth.view(torch.int32), ref_kth.view(torch.int32)):
            fail(f"K1 {label}: kth not bit-equal to the plain version")
        dual_ids, dual_codes, dkth = pallas_knn.knn_dual(table, spill, **k1_args)
        ref_dids, ref_dcodes, ref_dkth = pallas_knn.knn_dual_reference(table, spill, **ref_args)
        if not (torch.equal(dual_ids, ids) and torch.equal(dual_ids, ref_dids)):
            fail(f"K1'' {label}: ids differ from K1's in "
                 f"{int((dual_ids != ids).any(1).sum())} rows")
        if not torch.equal(dual_codes, ref_dcodes):
            fail(f"K1'' {label}: codes differ from the plain version in "
                 f"{int((dual_codes != ref_dcodes).any(1).sum())} rows")
        if not (torch.equal(dkth.view(torch.int32), ref_dkth.view(torch.int32))
                and torch.equal(dkth.view(torch.int32), kth.view(torch.int32))):
            fail(f"K1'' {label}: kth not bit-equal to the plain version and K1")
        codes, ckth = pallas_knn.knn_codes(table, spill, **k1_args)
        ref_codes, ref_ckth = pallas_knn.knn_codes_reference(table, spill, **ref_args)
        if not torch.equal(codes, ref_codes):
            fail(f"K1' {label}: codes differ from the plain version in "
                 f"{int((codes != ref_codes).any(1).sum())} rows")
        if not torch.equal(ckth.view(torch.int32), ref_ckth.view(torch.int32)):
            fail(f"K1' {label}: kth not bit-equal to the plain version")
        if label == "lattice":
            occupied = kth < 1e29
            print(f"K1 lattice: ids equal, kth bit-equal ({n_spilled} spilled; "
                  f"{int(torch.unique(kth[occupied]).numel())} distinct k-th distances over "
                  f"{int(occupied.sum())} rows); K1' codes equal, kth bit-equal; K1'' ids "
                  f"equal to K1's, codes equal, kth bit-equal")
            continue
        nbr, (ovf, max_d2, excess) = pallas_knn.pallas_cell_list_knn(
            pos, K, 1.0, grid, return_diagnostics=True)
        exact = bool((ovf == 0) & (excess <= 0))
        brute = knn_periodic_reference(pos, K, 1.0, query_tile=1024)
        same = (torch.sort(nbr, 1).values == torch.sort(brute, 1).values).all(1)
        if not exact or not bool(same.all()):
            fail(f"K1 {label}: certificate {exact}, {int((~same).sum())} rows differ "
                 "from brute force")
        if label == "spill" and n_spilled == 0:
            fail("the spill frame spilled no particle")
        print(f"K1 {label}: ids equal, kth bit-equal, certificate true "
              f"(max_d2 {float(max_d2):.6g}, max_excess {float(excess):.6g}, "
              f"{n_spilled} spilled), sets equal to brute force; K1' codes equal, "
              f"kth bit-equal; K1'' ids equal to K1's, codes equal, kth bit-equal")
        if label == "uniform":
            k1_table, k1_spill = table, spill
            k1_err = float((kth - ref_kth).abs().max())
            k1c_err = float((ckth - ref_ckth).abs().max())
            k1d_err = float((dkth - ref_dkth).abs().max())
    kernels.reset_launches()
    k1_ms = time_ms(lambda: pallas_knn.knn_select(k1_table, k1_spill, **k1_args), 50)
    k1_graph_ms = graph_ms(lambda: pallas_knn.knn_select(k1_table, k1_spill, **k1_args), 20)
    k1_plain_ms = time_ms(lambda: pallas_knn.knn_select_reference(k1_table, k1_spill, **ref_args),
                          3)
    k1c_ms = time_ms(lambda: pallas_knn.knn_codes(k1_table, k1_spill, **k1_args), 50)
    k1c_graph_ms = graph_ms(lambda: pallas_knn.knn_codes(k1_table, k1_spill, **k1_args), 20)
    k1c_plain_ms = time_ms(lambda: pallas_knn.knn_codes_reference(k1_table, k1_spill, **ref_args),
                           3)
    k1d_ms = time_ms(lambda: pallas_knn.knn_dual(k1_table, k1_spill, **k1_args), 50)
    k1d_graph_ms = graph_ms(lambda: pallas_knn.knn_dual(k1_table, k1_spill, **k1_args), 20)
    k1d_plain_ms = time_ms(lambda: pallas_knn.knn_dual_reference(k1_table, k1_spill, **ref_args),
                           3)
    occ = (k1_table[3] < N).sum(1)  # per cell
    coords = torch.arange(g**3, device=dev)
    ci, cj, cl = coords // (g * g), (coords // g) % g, coords % g
    ring_occ = torch.zeros_like(occ)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                ring_occ += occ[(((ci + dx) % g) * g + (cj + dy) % g) * g + (cl + dz) % g]
    pairs = int((occ * (ring_occ + int((k1_spill[3] < N).sum()))).sum())
    # In: the four table planes and the spill planes; out: ids or codes
    # [G^3 * cap, k] int32 and kth. Per (query, candidate) pair: 3 sub,
    # 3 mul, 2 add, 1 compare with the k-th.
    k1_bytes = nbytes(*k1_table, *k1_spill) + g**3 * cap * (K + 1) * 4
    k1_ops = 9 * pairs
    report["knn_select"] = kernel_entry(
        "knn_select.cu", "pallas_knn.py:117", k1_err, k1_ms, k1_plain_ms, k1_bytes, k1_ops,
        F32_FLOP_PER_S, None)
    report["knn_codes"] = kernel_entry(
        "knn_select.cu", "pallas_knn.py:167", k1c_err, k1c_ms, k1c_plain_ms, k1_bytes, k1_ops,
        F32_FLOP_PER_S, None)
    # K1'' writes a second [G^3 * cap, k] int32 output (the codes).
    k1d_bytes = k1_bytes + g**3 * cap * K * 4
    report["knn_dual"] = kernel_entry(
        "knn_select.cu", "pallas_knn.py:257", k1d_err, k1d_ms, k1d_plain_ms, k1d_bytes, k1_ops,
        F32_FLOP_PER_S, None)
    for name, gms in (("knn_select", k1_graph_ms), ("knn_codes", k1c_graph_ms),
                      ("knn_dual", k1d_graph_ms)):
        report[name]["graph_ms"] = gms
    print(f"K1 time {k1_ms:.4f} ms (graph {k1_graph_ms:.4f}), plain {k1_plain_ms:.3f} ms; K1' "
          f"time {k1c_ms:.4f} ms (graph {k1c_graph_ms:.4f}), plain {k1c_plain_ms:.3f} ms; K1'' "
          f"time {k1d_ms:.4f} ms (graph {k1d_graph_ms:.4f}), plain {k1d_plain_ms:.3f} ms; "
          f"{pairs} occupied pairs, {k1_ops} operations, {k1_bytes} bytes ({k1d_bytes} K1'')")
    # k above the old register cap of 32: the KT = 64 list, both modes.
    grid48 = choose_cell_grid(N, K1_WIDE_K)
    cap48, _, spill48 = pallas_knn.spill_layout(N, K1_WIDE_K, grid48)
    args48 = dict(k=K1_WIDE_K, n=N, g=grid48.grid_size, box=1.0,
                  mi_start=pallas_knn.min_image_start(cap48, spill48))
    for frame, pos in (("uniform", pos0), ("lattice", lattice)):
        t48 = pallas_knn.build_table(pos, grid48.grid_size, cap48, box)
        sp48 = pallas_knn.build_spill(pos, t48.particle_rank, cap48, spill48)
        planes48 = (t48.x, t48.y, t48.z, t48.ids)
        for label, select, plain in (
                ("K1", pallas_knn.knn_select, pallas_knn.knn_select_reference),
                ("K1'", pallas_knn.knn_codes, pallas_knn.knn_codes_reference),
                ("K1''", pallas_knn.knn_dual, pallas_knn.knn_dual_reference)):
            *picks, kth = select(planes48, sp48, **args48)
            *ref_picks, ref_kth = plain(planes48, sp48, **{**args48, "box": box})
            if not (all(torch.equal(a, b) for a, b in zip(picks, ref_picks))
                    and torch.equal(kth.view(torch.int32), ref_kth.view(torch.int32))):
                fail(f"{label} k={K1_WIDE_K} {frame}: differs from the plain version in "
                     f"{int((picks[0] != ref_picks[0]).any(1).sum())} rows")
        if frame == "uniform":
            k1_48 = [time_ms(lambda f=f: f(planes48, sp48, **args48), 20)
                     for f in (pallas_knn.knn_select, pallas_knn.knn_codes, pallas_knn.knn_dual)]
    print(f"K1, K1' and K1'' k={K1_WIDE_K} (grid {grid48.grid_size}, cap {cap48}), uniform and "
          f"lattice frames: picks equal, kth bit-equal to the plain versions; uniform time "
          f"{k1_48[0]:.4f}, {k1_48[1]:.4f}, {k1_48[2]:.4f} ms")
    print_ptxas(logs, "knn_select")
    print(f"phase 2 K1, K1', K1'': {time.perf_counter() - t0:.1f} s")

    # ---- 3. K5 against its plain version -------------------------------
    t0 = time.perf_counter()
    cfg = default_model_config()
    params = init_encode_process_decode(cfg, torch.Generator().manual_seed(args.seed), device=dev)
    node = step_params(params, 0)["node"]
    gen = torch.Generator().manual_seed(args.seed + 1)
    x = torch.randn(N, 128, generator=gen).to(dev)
    agg = torch.randn(N, 128, generator=gen).mul(3.0).bfloat16().to(dev)
    agg32 = agg.float() + 1e-3 * torch.randn(N, 128, generator=gen).to(dev)
    for label, a in (("bf16 agg", agg), ("f32 agg", agg32)):
        err = (fused_step_tail(x, a, node) - fused_step_tail_reference(x, a, node)).abs()
        e_max, e_mean = float(err.max()), float(err.mean())
        if not (e_max <= K5_MAX_ABS_TOL and e_mean <= K5_MEAN_ABS_TOL):
            fail(f"K5 {label}: max abs err {e_max} (tol {K5_MAX_ABS_TOL}), mean {e_mean} "
                 f"(tol {K5_MEAN_ABS_TOL})")
        print(f"K5 [{N}, 128] {label}: max abs err {e_max:.3g} (tol {K5_MAX_ABS_TOL}), "
              f"mean {e_mean:.3g} (tol {K5_MEAN_ABS_TOL})")
        if label == "bf16 agg":
            k5_err = e_max
    # Timed as every kernel is (events around back-to-back calls), and from
    # a CUDA graph of the calls: where the host's cost of a call exceeds the
    # kernel's time, the first reads the host and the second the device.
    k5_ms = time_ms(lambda: fused_step_tail(x, agg, node), 200)
    k5_f32_ms = time_ms(lambda: fused_step_tail(x, agg32, node), 200)
    k5_graph_ms = graph_ms(lambda: fused_step_tail(x, agg, node), 50)
    k5_f32_graph_ms = graph_ms(lambda: fused_step_tail(x, agg32, node), 50)
    k5_plain_ms = time_ms(lambda: fused_step_tail_reference(x, agg, node), 50)
    k5_bytes = N * 128 * (4 + 2 + 4) + (3 * 128 * 128 + 5 * 128) * 4
    k5_f32_bytes = k5_bytes + N * 128 * 2
    k5_ops = 3 * 2 * N * 128 * 128
    report["fused_tail"] = kernel_entry(
        "fused_tail.cu", "fused_step.py:66", k5_err, k5_ms, k5_plain_ms, k5_bytes, k5_ops,
        BF16_TENSOR_FLOP_PER_S, None)
    report["fused_tail"]["graph_ms"] = k5_graph_ms
    k5_f32_bound = max(k5_f32_bytes / HBM_BYTES_PER_S, k5_ops / BF16_TENSOR_FLOP_PER_S) * 1e3
    print(f"K5 time {k5_ms:.4f} ms (graph {k5_graph_ms:.4f}; bound "
          f"{report['fused_tail']['bound_ms']:.4f}), f32 agg {k5_f32_ms:.4f} ms (graph "
          f"{k5_f32_graph_ms:.4f}; bound {k5_f32_bound:.4f}); plain {k5_plain_ms:.4f} ms; "
          f"{k5_ops} operations, {k5_bytes} bytes ({k5_f32_bytes} with f32 agg)")
    g_out = torch.randn(N, 128, generator=gen).to(dev)
    layers = node["layers"]
    for label, a in (("bf16 agg", agg), ("f32 agg", agg32)):
        dx, dagg, grads = fused_step_tail_bwd(x, a, g_out, node)
        rdx, rdagg, rgrads = fused_step_tail_bwd_reference(x, a, g_out, node)
        # Autograd through the plain forward, on copies of the inputs.
        leaves = [t.detach().clone().requires_grad_(True) for t in (
            x, a.float(), layers[0]["w"][:128], layers[0]["b"], layers[1]["w"],
            layers[1]["b"], layers[2]["w"], layers[2]["b"], node["ln"]["scale"],
            node["ln"]["bias"])]
        tnode = {"layers": tuple({"w": leaves[2 + 2 * i], "b": leaves[3 + 2 * i]}
                                 for i in range(3)),
                 "ln": {"scale": leaves[8], "bias": leaves[9]}}
        out = fused_step_tail_reference(leaves[0], leaves[1], tnode)
        auto = torch.autograd.grad(out, leaves, g_out)
        names = ["dx", "dagg", "dw_self", "db0", "dw1", "db1", "dwf", "dbf", "dscale",
                 "dbias"]
        errs = []
        for name, k6, ref, ag in zip(names, [dx, dagg, *grads], [rdx, rdagg, *rgrads], auto):
            ok, err = mostly_close(k6, ref, K6_REL, K6_MEAN)
            ok_auto, err_auto = mostly_close(k6, ag, K6_AUTOGRAD_REL, K6_AUTOGRAD_MEAN)
            if not (ok and ok_auto):
                fail(f"K6 {label} {name}: max abs err {err} against the plain version, "
                     f"{err_auto} against autograd")
            errs.append((err, err_auto))
        print(f"K6 [{N}, 128] {label}: dx, dagg and the 8 weight/bias/LN gradients within "
              f"tolerance; max abs err per output against the plain version "
              f"{[float(f'{e:.3g}') for e, _ in errs]}, against autograd "
              f"{[float(f'{e:.3g}') for _, e in errs]}")
        if label == "bf16 agg":
            k6_err = max(e for e, _ in errs)
    del leaves, tnode, out, auto
    k6_ms = time_ms(lambda: fused_step_tail_bwd(x, agg, g_out, node), 100)
    k6_f32_ms = time_ms(lambda: fused_step_tail_bwd(x, agg32, g_out, node), 100)
    k6_graph_ms = graph_ms(lambda: fused_step_tail_bwd(x, agg, g_out, node), 20)
    k6_f32_graph_ms = graph_ms(lambda: fused_step_tail_bwd(x, agg32, g_out, node), 20)
    k6_plain_ms = time_ms(lambda: fused_step_tail_bwd_reference(x, agg, g_out, node), 20)
    # In: x, agg (bf16), g and the weights; out: dx, dagg and the gradients.
    # Nine 128 x 128 products a row (three recomputed, six backward).
    k6_bytes = N * 128 * (4 + 2 + 4 + 4 + 2) + 2 * (3 * 128 * 128 + 5 * 128) * 4
    k6_f32_bytes = k6_bytes + 2 * N * 128 * 2
    k6_ops = 9 * 2 * N * 128 * 128
    report["fused_tail_bwd"] = kernel_entry(
        "fused_tail_bwd.cu", "fused_step.py:113", k6_err, k6_ms, k6_plain_ms, k6_bytes,
        k6_ops, BF16_TENSOR_FLOP_PER_S, None)
    report["fused_tail_bwd"]["graph_ms"] = k6_graph_ms
    k6_f32_bound = max(k6_f32_bytes / HBM_BYTES_PER_S, k6_ops / BF16_TENSOR_FLOP_PER_S) * 1e3
    print(f"K6 time {k6_ms:.4f} ms (graph {k6_graph_ms:.4f}; bound "
          f"{report['fused_tail_bwd']['bound_ms']:.4f}), f32 agg {k6_f32_ms:.4f} ms (graph "
          f"{k6_f32_graph_ms:.4f}; bound {k6_f32_bound:.4f}); plain {k6_plain_ms:.4f} ms; "
          f"{k6_ops} operations, {k6_bytes} bytes ({k6_f32_bytes} with f32 agg)")
    # A floor for the tails' tensor work, not a yardstick (no single PyTorch
    # call computes a tail): their [N, 128] x [128, 128] bf16 products alone.
    mm_a = torch.randn(N, 128, generator=gen).to(dev).bfloat16()
    mm_w = torch.randn(128, 128, generator=gen).to(dev).bfloat16()
    mm_ms = graph_ms(lambda: torch.matmul(mm_a, mm_w), 50)
    print(f"torch.matmul [{N}, 128] x [128, 128] bf16 (from a CUDA graph): {mm_ms:.4f} ms "
          f"each; the three of K5 {3 * mm_ms:.4f} ms, the nine of K6 {9 * mm_ms:.4f} ms")
    del mm_a, mm_w
    print(f"phase 3 K5, K6: {time.perf_counter() - t0:.1f} s")

    # ---- 4. K2, K3, K4 against their plain versions ----------------------
    t0 = time.perf_counter()
    spec = cellblock.choose_cellblock_spec(N, K)
    codes_cap = pallas_knn.codes_packing_cap(N, K, grid)
    width = spec.s_width

    def plan_kernels(label, pos, certified=True):
        """K2 (from K1''s particle-order codes), K3 with its count and
        without it (the rollouts' mode) and K7 with its total against their
        plain versions on one frame, and the plan build's tables and
        certificate counts against them."""
        layout = cellblock.cellblock_layout(pos, 1.0, spec)
        _, codes, spill = pallas_knn.pallas_cell_list_knn(pos, K, 1.0, grid, codes_only=True)
        offsets, dropped = cellblock.s_decode(codes, spill, layout, spec, codes_cap)
        ref_off = cellblock.s_decode_reference(
            *cellblock.s_decode_inputs(layout, codes, codes_cap, spill, spec), spec=spec,
            codes_cap=codes_cap)
        if not torch.equal(offsets, ref_off) or int(dropped) != int((ref_off == width + 1).sum()):
            fail(f"K2 {label}: offsets differ from the plain version in "
                 f"{int((offsets != ref_off).sum())} entries, dropped {int(dropped)}")
        s_table, s_total = cellblock.s_onehot(offsets, width=width, with_total=True)
        uncounted = cellblock.s_onehot(offsets, width=width)  # the rollouts' mode
        ref_s = cellblock.s_onehot_reference(offsets, width=width)
        if not (torch.equal(s_table, ref_s) and torch.equal(uncounted, ref_s)
                and int(s_total) == int(ref_s.sum(dtype=torch.int64))):
            fail(f"K3 {label}: S table (with or without its count) or its count "
                 f"({int(s_total)}) differs from the plain version")
        packs = cellblock.sender_packs(cellblock.slot_codes(layout, codes, codes_cap, spill, spec),
                                       layout, codes_cap, spec)
        s_rev, rev_total = cellblock.reverse_table(packs, layout, spec)
        ref_rev = cellblock.reverse_table_reference(
            cellblock.reverse_candidates(packs, layout, spec), layout.window_starts,
            layout.tile_pack_base, layout.window_lims, spec=spec)
        if not (torch.equal(s_rev, ref_rev)
                and int(rev_total) == int(ref_rev.sum(dtype=torch.int64))):
            fail(f"K7 {label}: reverse table or its total ({int(rev_total)}) differs from the "
                 "plain version")
        plan = cellblock.build_cellblock(pos, None, 1.0, spec, with_reverse=True,
                                         neighbor_codes=codes, codes_cap=codes_cap,
                                         codes_spill=spill)
        mismatch = int(plan.reverse_mismatch)
        if not (torch.equal(plan.s_table, s_table) and torch.equal(plan.s_rev_table, s_rev)
                and mismatch == int(s_total) - int(rev_total)
                and int(plan.dropped_edges) == int(dropped)):
            fail(f"{label}: the plan's tables or counts differ from the kernels' outputs")
        if certified and mismatch != 0:
            fail(f"K7 {label}: reverse_mismatch {mismatch}")
        print(f"K2 {label}: offsets and dropped ({int(dropped)}) equal; K3: S and its count "
              f"({int(s_total)}) equal; K7: S_rev and its total ({int(rev_total)}) equal; "
              f"reverse_mismatch {mismatch}, overflow {int(layout.overflow)}, window_overflow "
              f"{int(layout.window_overflow)}")
        return dict(layout=layout, codes=codes, spill=spill, offsets=offsets, s_table=s_table,
                    packs=packs, s_rev=s_rev, plan=plan)

    for label, pos in frames:
        out = plan_kernels(label, pos)
        if label == "uniform":
            k2_in = (out["codes"], out["spill"], out["layout"])
            k2_off, k4_s, k4_starts = out["offsets"], out["s_table"], out["layout"].window_starts
            k7_packs, k7_s = out["packs"], out["s_rev"]
        del out
    z_pad = torch.randn(spec.num_padded, 128, generator=gen).bfloat16().to(dev)
    out = cellblock.window_matmul(k4_s, z_pad, k4_starts, spec=spec)
    ref = cellblock.window_matmul_reference(k4_s, z_pad, k4_starts, spec=spec)
    err = (out - ref).abs()
    k4_err, k4_mean = float(err.max()), float(err.mean())
    if not (k4_err <= K4_MAX_ABS_TOL and k4_mean <= K4_MEAN_ABS_TOL):
        fail(f"K4 max abs err {k4_err} (tol {K4_MAX_ABS_TOL}), mean {k4_mean} "
             f"(tol {K4_MEAN_ABS_TOL})")
    print(f"K4 [{spec.num_slots}, {width}] x [{spec.num_padded}, 128]: max abs err "
          f"{k4_err:.3g} (tol {K4_MAX_ABS_TOL}), mean {k4_mean:.3g} (tol {K4_MEAN_ABS_TOL})")

    # K2 as the plan build calls it: particle-order codes to offsets and the
    # dropped count (the parent's torch prologue of slot scatter,
    # normalization and 27-roll start table is inside the kernel now).
    k2_codes, k2_spill, k2_layout = k2_in
    k2 = lambda: cellblock.s_decode(k2_codes, k2_spill, k2_layout, spec, codes_cap)  # noqa: E731
    k2_ms = time_ms(k2, 200)
    k2_graph_ms = graph_ms(k2, 50)
    k2_plain_ms = time_ms(lambda: cellblock.s_decode_reference(
        *cellblock.s_decode_inputs(k2_layout, k2_codes, codes_cap, k2_spill, spec), spec=spec,
        codes_cap=codes_cap), 20)
    # In: the codes, the slot, order and z-cell maps, the start and tile
    # tables, the spill tables; out: the offsets and the count. Per pick
    # ~30 integer operations (one division, compares, selects), counted
    # against the float32 vector rate; far below the bytes either way.
    k2_bytes = nbytes(k2_codes, k2_layout.particle_of_slot, k2_layout.order, k2_layout.sorted_cz,
                      k2_layout.cstart_rel, k2_layout.tile_const, k2_off) + 4
    if k2_spill is not None:
        k2_bytes += nbytes(*k2_spill)
    k2_ops = 30 * k2_off.numel()
    report["s_decode"] = kernel_entry(
        "s_decode.cu", "cellblock.py:546", 0.0, k2_ms, k2_plain_ms, k2_bytes, k2_ops,
        F32_FLOP_PER_S, None)
    report["s_decode"]["graph_ms"] = k2_graph_ms

    k3_ms = time_ms(lambda: cellblock.s_onehot(k2_off, width=width), 200)
    k3_graph_ms = graph_ms(lambda: cellblock.s_onehot(k2_off, width=width), 50)
    k3c_ms = time_ms(lambda: cellblock.s_onehot(k2_off, width=width, with_total=True), 200)
    k3c_graph_ms = graph_ms(lambda: cellblock.s_onehot(k2_off, width=width, with_total=True), 50)
    k3_plain_ms = time_ms(lambda: cellblock.s_onehot_reference(k2_off, width=width), 20)
    # Yardstick: scatter_add_ of ones into a zeroed int32 table with two
    # extra columns that catch the sentinels (width, width + 1).
    off_l = k2_off.long()
    ones = torch.ones_like(off_l, dtype=torch.int32)
    k3_lib_ms = time_ms(lambda: torch.zeros(
        (spec.num_slots, width + 2), dtype=torch.int32, device=dev).scatter_add_(1, off_l, ones), 50)
    report["s_onehot"] = kernel_entry(
        "s_onehot.cu", "cellblock.py:499", 0.0, k3_ms, k3_plain_ms,
        nbytes(k2_off, k4_s), k2_off.numel(), F32_FLOP_PER_S, k3_lib_ms)
    report["s_onehot"]["graph_ms"] = k3_graph_ms

    k4_ms = time_ms(lambda: cellblock.window_matmul(k4_s, z_pad, k4_starts, spec=spec), 100)
    k4_plain_ms = time_ms(lambda: cellblock.window_matmul_reference(
        k4_s, z_pad, k4_starts, spec=spec), 5)
    # Yardstick: one torch.bmm of S (as bf16) [T, QB, 9W] with the 9 windows
    # of each tile gathered beforehand [T, 9W, H] (the gather is not timed;
    # the product is dense and its output bf16).
    s_bf16 = k4_s.view(spec.num_tiles, spec.query_block, width).to(torch.bfloat16)
    rows = (k4_starts.long()[:, :, None]
            + torch.arange(spec.window, device=dev)).reshape(spec.num_tiles, width)
    windows = z_pad[rows]
    k4_lib_ms = time_ms(lambda: torch.bmm(s_bf16, windows), 50)
    del s_bf16, windows
    # The product S @ window is sparse: the work this data needs is one
    # multiply-add per nonzero S entry and latent column.
    k4_nnz = int((k4_s != 0).sum())
    k4_ops = 2 * k4_nnz * 128
    k4_live = float((k4_s.view(spec.num_tiles, spec.query_block // 32, 32, width // 64, 64) != 0)
                    .any(4).any(2).float().mean())
    report["window_matmul"] = kernel_entry(
        "window_matmul.cu", "cellblock.py:2607", k4_err, k4_ms, k4_plain_ms,
        nbytes(k4_s, z_pad, k4_starts, out), k4_ops, BF16_TENSOR_FLOP_PER_S, k4_lib_ms)
    print(f"K2 time {k2_ms:.4f} ms (graph {k2_graph_ms:.4f}; bound "
          f"{report['s_decode']['bound_ms']:.5f}), plain {k2_plain_ms:.4f} ms, {k2_bytes} bytes; "
          f"K3 time {k3_ms:.4f} ms (graph {k3_graph_ms:.4f}), with its count {k3c_ms:.4f} (graph "
          f"{k3c_graph_ms:.4f}), plain {k3_plain_ms:.4f} ms, scatter_add_ {k3_lib_ms:.4f} ms; "
          f"K4 time {k4_ms:.4f} ms, plain {k4_plain_ms:.4f} ms, bmm {k4_lib_ms:.4f} ms, "
          f"{k4_nnz} nonzero S entries of {k4_s.numel()} ({100 * (1 - k4_nnz / k4_s.numel()):.3f} % "
          f"zeros), {100 * k4_live:.2f} % of (32-row, 64-deep) S blocks live, dense bf16 work "
          f"{2 * spec.num_slots * width * 128} FLOP")
    report["window_matmul"]["kernels_ms"] = {
        "flagship": window_kernels("K4 flagship", k4_s, z_pad, k4_starts, spec, False, 100)[0]}
    del out, ref, k4_s, z_pad

    # K7's time; K4^T against its plain version on the uniform frame's S_rev.
    def k7_timing(pspec, layout, packs):
        """K7's events and graph times, its plain version's, and its
        yardstick's: one scatter_add_ of ones into a zeroed int8 table of
        [rows, rev_lanes + 1] from flat indices computed beforehand (the
        edges that do not count go to the extra column), as K3's."""
        fn = lambda: cellblock.reverse_table(packs, layout, pspec)  # noqa: E731
        ms, gms = time_ms(fn, 100), graph_ms(fn, 20)
        # The card's practical store rate: one fill_ of a table of S_rev's
        # size (a floor for the writes alone, not a yardstick).
        table = torch.empty((pspec.num_tiles, pspec.s_width, pspec.rev_lanes), dtype=torch.int8,
                            device=dev)
        fill_ms = graph_ms(lambda: table.fill_(0), 20)
        del table
        plain_ms = time_ms(lambda: cellblock.reverse_table_reference(
            cellblock.reverse_candidates(packs, layout, pspec), layout.window_starts,
            layout.tile_pack_base, layout.window_lims, spec=pspec).sum(dtype=torch.int32), 5)
        lanes, w_ = pspec.rev_lanes, pspec.window
        rows_ = (layout.window_starts.long()[:, :, None]
                 + torch.arange(w_, device=dev)).reshape(pspec.num_tiles, -1)  # [T, 9W]
        cand = cellblock.reverse_candidates(packs, layout, pspec).long()
        win = cand[rows_]  # [T, 9W, k + 1]
        starts_ = layout.window_starts.long().repeat_interleave(w_, dim=1)  # [T, 9W]
        main = win[..., -1]
        speaks = (main == rows_) | (main < starts_) | (main >= starts_ + w_)
        local = win[..., :-1] - (torch.arange(pspec.num_tiles, device=dev)
                                 * pspec.query_block)[:, None, None]
        ok = speaks[..., None] & (local >= 0) & (local < pspec.query_block)
        idx = torch.where(ok, local, lanes).reshape(-1, local.shape[-1])
        ones_ = torch.ones_like(idx, dtype=torch.int8)
        lib_ms = time_ms(lambda: torch.zeros((idx.shape[0], lanes + 1), dtype=torch.int8,
                                             device=dev).scatter_add_(1, idx, ones_), 20)
        del cand, win, local, ok, idx, ones_
        # In: the packs, pad_src, the window starts, the tile bases, the
        # window limits and main bases; out: S_rev and its total. Per (row,
        # sender): a subtraction and two compares.
        nb = nbytes(packs, layout.pad_src, layout.window_starts, layout.tile_pack_base,
                    layout.window_lims, layout.main_base) + 4 + (
            pspec.num_tiles * pspec.s_width * lanes)
        ops = 3 * pspec.num_tiles * pspec.s_width * packs.shape[1]
        return ms, gms, plain_ms, lib_ms, nb, ops, fill_ms

    k7_ms, k7_graph_ms, k7_plain_ms, k7_lib_ms, k7_bytes, k7_ops, k7_fill_ms = k7_timing(
        spec, k2_layout, k7_packs)
    report["reverse_table"] = kernel_entry(
        "reverse_table.cu", "cellblock.py:2431", 0.0, k7_ms, k7_plain_ms, k7_bytes, k7_ops,
        F32_FLOP_PER_S, k7_lib_ms)
    report["reverse_table"]["graph_ms"] = k7_graph_ms
    g_pad = torch.randn(spec.num_padded, 128, generator=gen).bfloat16().to(dev)
    out = cellblock.window_matmul_t(k7_s, g_pad, k4_starts, spec=spec)
    ref = cellblock.window_matmul_t_reference(k7_s, g_pad, k4_starts, spec=spec)
    err = (out - ref).abs()
    k4t_err, k4t_mean = float(err.max()), float(err.mean())
    if not (k4t_err <= K4_MAX_ABS_TOL and k4t_mean <= K4_MEAN_ABS_TOL):
        fail(f"K4^T max abs err {k4t_err} (tol {K4_MAX_ABS_TOL}), mean {k4t_mean} "
             f"(tol {K4_MEAN_ABS_TOL})")
    print(f"K4^T [{spec.num_tiles}, {width}, {spec.rev_lanes}] x [{spec.num_padded}, 128]: "
          f"max abs err {k4t_err:.3g} (tol {K4_MAX_ABS_TOL}), mean {k4t_mean:.3g} "
          f"(tol {K4_MEAN_ABS_TOL})")
    k4t_ms = time_ms(lambda: cellblock.window_matmul_t(k7_s, g_pad, k4_starts, spec=spec), 100)
    k4t_plain_ms = time_ms(lambda: cellblock.window_matmul_t_reference(
        k7_s, g_pad, k4_starts, spec=spec), 5)
    # Yardstick: one torch.bmm of S_rev^T (bf16) [T, QB, 9W] with the tiles'
    # gathered windows [T, 9W, H] (gather untimed, output bf16).
    s_rev_t = k7_s[:, :, :spec.query_block].transpose(1, 2).to(torch.bfloat16).contiguous()
    windows = g_pad[rows]
    k4t_lib_ms = time_ms(lambda: torch.bmm(s_rev_t, windows), 50)
    del s_rev_t, windows
    k4t_nnz = int((k7_s != 0).sum())
    report["window_matmul_t"] = kernel_entry(
        "window_matmul.cu", "cellblock.py:2607", k4t_err, k4t_ms, k4t_plain_ms,
        nbytes(k7_s, g_pad, k4_starts, out), 2 * k4t_nnz * 128, BF16_TENSOR_FLOP_PER_S,
        k4t_lib_ms)
    print(f"K7 time {k7_ms:.4f} ms (graph {k7_graph_ms:.4f}; bound "
          f"{report['reverse_table']['bound_ms']:.5f}), plain {k7_plain_ms:.4f} ms, scatter_add_ "
          f"{k7_lib_ms:.4f} ms, fill_ of the table {k7_fill_ms:.4f} ms (graph), {k7_bytes} bytes; "
          f"K4^T time {k4t_ms:.4f} ms, "
          f"plain {k4t_plain_ms:.4f} ms, bmm {k4t_lib_ms:.4f} ms, {k4t_nnz} nonzero S_rev "
          f"entries")
    report["window_matmul_t"]["kernels_ms"] = {
        "flagship": window_kernels("K4^T flagship", k7_s, g_pad, k4_starts, spec, True, 100)[0]}
    del out, ref, g_pad, k7_s

    # K4 and K4^T on the aux spec (grid 14: QB 224, W 384, S width 3,456),
    # from the plan of K1's neighbor ids with its reverse table; and each
    # mode's rate, registers and spills.
    aux_spec = cellblock.choose_cellblock_spec(N)
    aux_ids = pallas_knn.pallas_cell_list_knn(pos0, K, 1.0, grid)
    aux_plan = cellblock.build_cellblock(pos0, aux_ids, 1.0, aux_spec, with_reverse=True)
    if int(aux_plan.reverse_mismatch) != 0 or int(aux_plan.dropped_edges) != 0:
        fail(f"aux plan: reverse_mismatch {int(aux_plan.reverse_mismatch)}, dropped "
             f"{int(aux_plan.dropped_edges)}")
    # K7 on the aux spec (rev_lanes 256 over QB 224, W 384), from the aux
    # route's sender packs.
    aux_layout = cellblock.cellblock_layout(pos0, 1.0, aux_spec)
    aux_packs = (cellblock.aux_slot_senders(aux_layout, aux_ids, aux_spec)
                 // aux_spec.grid_size).to(torch.int32)
    a_rev, a_total = cellblock.reverse_table(aux_packs, aux_layout, aux_spec)
    a_ref = cellblock.reverse_table_reference(
        cellblock.reverse_candidates(aux_packs, aux_layout, aux_spec), aux_layout.window_starts,
        aux_layout.tile_pack_base, aux_layout.window_lims, spec=aux_spec)
    if not (torch.equal(a_rev, a_ref) and torch.equal(a_rev, aux_plan.s_rev_table)
            and int(a_total) == int(a_ref.sum(dtype=torch.int64))):
        fail("K7 aux spec: reverse table or its total differs from the plain version")
    ka_ms, ka_graph_ms, ka_plain_ms, ka_lib_ms, ka_bytes, _, ka_fill_ms = k7_timing(
        aux_spec, aux_layout, aux_packs)
    report["reverse_table"].update(aux_ms=ka_ms, aux_graph_ms=ka_graph_ms)
    print(f"K7 aux spec (G {aux_spec.grid_size}, QB {aux_spec.query_block}, W "
          f"{aux_spec.window}): S_rev and its total ({int(a_total)}) equal to the plain version; "
          f"time {ka_ms:.4f} ms (graph {ka_graph_ms:.4f}; bound "
          f"{ka_bytes / HBM_BYTES_PER_S * 1e3:.5f}), plain {ka_plain_ms:.4f} ms, scatter_add_ "
          f"{ka_lib_ms:.4f} ms, fill_ of the table {ka_fill_ms:.4f} ms (graph), {ka_bytes} bytes")
    del a_rev, a_ref, aux_layout, aux_packs, aux_ids
    a_pad = torch.randn(aux_spec.num_padded, 128, generator=gen).bfloat16().to(dev)
    aux_rows = (aux_plan.window_starts.long()[:, :, None]
                + torch.arange(aux_spec.window, device=dev)).reshape(aux_spec.num_tiles, -1)
    for label, fn, plain, table, s_b in (
            ("K4", cellblock.window_matmul, cellblock.window_matmul_reference, aux_plan.s_table,
             aux_plan.s_table.view(aux_spec.num_tiles, aux_spec.query_block, -1)),
            ("K4^T", cellblock.window_matmul_t, cellblock.window_matmul_t_reference,
             aux_plan.s_rev_table,
             aux_plan.s_rev_table[:, :, :aux_spec.query_block].transpose(1, 2))):
        out = fn(table, a_pad, aux_plan.window_starts, spec=aux_spec)
        ref = plain(table, a_pad, aux_plan.window_starts, spec=aux_spec)
        err = (out - ref).abs()
        e_max, e_mean = float(err.max()), float(err.mean())
        if not (e_max <= K4_MAX_ABS_TOL and e_mean <= K4_MEAN_ABS_TOL):
            fail(f"{label} aux: max abs err {e_max} (tol {K4_MAX_ABS_TOL}), mean {e_mean} "
                 f"(tol {K4_MEAN_ABS_TOL})")
        ms = time_ms(lambda: fn(table, a_pad, aux_plan.window_starts, spec=aux_spec), 100)
        plain_ms = time_ms(lambda: plain(table, a_pad, aux_plan.window_starts, spec=aux_spec), 3)
        s_bf16 = s_b.to(torch.bfloat16).contiguous()
        windows = a_pad[aux_rows]
        bmm_ms = time_ms(lambda: torch.bmm(s_bf16, windows), 50)
        del s_bf16, windows
        a_bytes = nbytes(table, a_pad, aux_plan.window_starts, out)
        print(f"{label} aux spec (G {aux_spec.grid_size}, QB {aux_spec.query_block}, W "
              f"{aux_spec.window}, table {tuple(table.shape)}): max abs err {e_max:.3g}, mean "
              f"{e_mean:.3g} (tol {K4_MAX_ABS_TOL}, {K4_MEAN_ABS_TOL}); time {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, bmm {bmm_ms:.4f} ms; {a_bytes} bytes, bound "
              f"{a_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms, {a_bytes / ms / 1e6:.1f} GB/s")
        del out, ref
        report["window_matmul_t" if label == "K4^T" else "window_matmul"]["kernels_ms"]["aux"] = \
            window_kernels(f"{label} aux", table, a_pad, aux_plan.window_starts, aux_spec,
                           label == "K4^T", 100)[0]
    for name in ("window_matmul", "window_matmul_t"):
        entry = report[name]
        rate = entry["bound_ms"] / 1e3 * HBM_BYTES_PER_S / (entry["ms"] / 1e3) / 1e9
        print(f"{name} flagship: {entry['ms']:.4f} ms, {rate:.1f} GB/s "
              f"({100 * entry['bound_ms'] / entry['ms']:.1f} % of its bytes bound); "
              f"bmm {entry['library_ms']:.4f} ms")
    print_ptxas(logs, "window_matmul")
    for name in ("s_decode", "reverse_table", "s_onehot"):
        print_ptxas(logs, name)
    del a_pad, aux_plan, aux_rows, table, s_b

    # K8 on the dense plan's inputs: the uniform frame, a frame whose search
    # windows truncate (300 particles in one cell: the windows of its tiles
    # outgrow w_eff), where the certificate must fail alike on the card and
    # on the CPU plain path, and the lattice frame (ties). K8 searches the
    # live rows of the plan's mask (padding rows get the no-pick lane and
    # 1e30).
    dspec = cellblock.choose_dense_search_spec(N, spec)
    truncating = pos0.clone()
    truncating[:300] = torch.tensor([0.41, 0.41, 0.41], device=dev) + 0.05 * truncating[:300]
    for label, pos in (("uniform", pos0), ("truncating", truncating), ("lattice", lattice)):
        layout = cellblock.cellblock_layout(pos, 1.0, spec)
        ds = cellblock.dense_search_inputs(layout, pos[layout.order], 1.0, spec, dspec)
        live = (torch.arange(dspec.query_block, device=dev) < ds.rows[:, None]).reshape(-1)
        for k in (K, K1_WIDE_K) if label != "truncating" else (K,):
            k8_args = dict(k=k, query_block=dspec.query_block, w_eff=ds.w_eff)
            lanes, kth = cellblock.dense_select(ds.table, ds.queries, ds.windows, 1.0, ds.rows,
                                                **k8_args)
            ref_lanes, ref_kth = cellblock.dense_select_reference(
                ds.table, ds.queries, ds.windows, 1.0, **k8_args)
            if not torch.equal(lanes[live], ref_lanes[live]):
                fail(f"K8 {label} k={k}: lanes differ from the plain version in "
                     f"{int((lanes[live] != ref_lanes[live]).any(1).sum())} live rows")
            if not torch.equal(kth[live].view(torch.int32), ref_kth[live].view(torch.int32)):
                fail(f"K8 {label} k={k}: kth not bit-equal to the plain version")
            if not (bool((lanes[~live] == 9 * ds.w_eff).all()) and bool((kth[~live] == 1e30).all())):
                fail(f"K8 {label} k={k}: padding rows not the no-pick lane and 1e30")
            if label == "uniform" and k == K:
                k8_ds, k8_args_u, k8_lanes, k8_kth = ds, k8_args, lanes, kth
                k8_err = float((kth[live] - ref_kth[live]).abs().max())
        print(f"K8 {label}: {ds.windows.shape[0]} tiles, {int(live.sum())} live rows of "
              f"{live.numel()}; k = {K}{'' if label == 'truncating' else f' and {K1_WIDE_K}'}: "
              f"live rows' lanes equal and kth bit-equal to the plain version, padding rows "
              f"the no-pick lane")
        if label == "lattice":
            continue
        # The dense train plan: with its reverse table (K7 from the dense
        # route's sender packs) and the certificate from the two counts.
        plan = cellblock.build_cellblock(pos, None, 1.0, spec, dense_search=dspec,
                                         num_neighbors=K, with_reverse=True)
        cpu_plan = cellblock.build_cellblock(pos.cpu(), None, 1.0, spec, dense_search=dspec,
                                             num_neighbors=K, with_reverse=True)
        for field in ("s_table", "s_rev_table", "overflow", "dropped_edges", "reverse_mismatch",
                      "search_window_overflow", "search_excess"):
            if not torch.equal(getattr(plan, field).cpu(), getattr(cpu_plan, field)):
                fail(f"K8 {label}: the dense plan's {field} differs from the CPU plain path")
        swo, excess = int(plan.search_window_overflow), float(plan.search_excess)
        if label == "uniform" and not (swo == 0 and excess <= 0 and int(plan.overflow) == 0
                                       and int(plan.dropped_edges) == 0
                                       and int(plan.reverse_mismatch) == 0):
            fail(f"K8 uniform: certificate false (search_window_overflow {swo}, "
                 f"search_excess {excess}, reverse_mismatch {int(plan.reverse_mismatch)})")
        if label == "truncating" and swo == 0:
            fail("K8 truncating: the search windows truncated nothing")
        print(f"K8 {label}: the dense train plan equal to the CPU plain path (S, S_rev, "
              f"overflow {int(plan.overflow)}, dropped {int(plan.dropped_edges)}, "
              f"reverse_mismatch {int(plan.reverse_mismatch)}, "
              f"search_window_overflow {swo}, search_excess {excess:.6g})")
        del plan, cpu_plan
    k8 = lambda: cellblock.dense_select(  # noqa: E731
        k8_ds.table, k8_ds.queries, k8_ds.windows, 1.0, k8_ds.rows, **k8_args_u)
    k8_ms = time_ms(k8, 50)
    k8_graph_ms = graph_ms(k8, 20)
    k8_plain_ms = time_ms(lambda: cellblock.dense_select_reference(
        k8_ds.table, k8_ds.queries, k8_ds.windows, 1.0, **k8_args_u), 3)
    # The work this data needs: every live query row against its 9 * w_eff
    # candidate lanes (3 sub, 3 mul, 2 add, 1 compare with the k-th each).
    live_rows = int(k8_ds.rows.sum())
    k8_pairs = live_rows * 9 * k8_ds.w_eff
    k8_bytes = nbytes(k8_ds.table, k8_ds.queries, k8_ds.windows, k8_ds.rows, k8_lanes, k8_kth)
    report["dense_select"] = kernel_entry(
        "dense_select.cu", "cellblock.py:765", k8_err, k8_ms, k8_plain_ms, k8_bytes,
        9 * k8_pairs, F32_FLOP_PER_S, None)
    report["dense_select"]["graph_ms"] = k8_graph_ms
    print(f"K8 time {k8_ms:.4f} ms (graph {k8_graph_ms:.4f}), plain {k8_plain_ms:.3f} ms; "
          f"{live_rows} live query rows of "
          f"{k8_ds.queries.shape[0]}, {k8_pairs} pairs, {k8_bytes} bytes")
    print_ptxas(logs, "dense_select")
    del k8_ds, k8_lanes, k8_kth
    print(f"phase 4 K2, K3, K7, K4, K4^T (flagship and aux), K8: "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- 4b. the uncertified regime ----------------------------------------
    # Frames where the certificate is false: the spill block overflows, rows
    # run short of k candidates (sentinel picks), columns overflow. Every
    # kernel is held bit-equal to its plain version there, and the plan's
    # counts to the CPU plain path's; the certificate is what the plain
    # path says (false), never asserted true.
    t0 = time.perf_counter()
    for label, share, sigma in CLUSTERED:
        pos = torch.as_tensor(clustered_frame(N, share, sigma, args.seed + 21), device=dev)
        table, spill, n_spilled = k1_inputs(pos)
        for name, select, plain in (
                ("K1", pallas_knn.knn_select, pallas_knn.knn_select_reference),
                ("K1'", pallas_knn.knn_codes, pallas_knn.knn_codes_reference),
                ("K1''", pallas_knn.knn_dual, pallas_knn.knn_dual_reference)):
            *picks, kth = select(table, spill, **k1_args)
            *ref_picks, ref_kth = plain(table, spill, **ref_args)
            if not (all(torch.equal(a, b) for a, b in zip(picks, ref_picks))
                    and torch.equal(kth.view(torch.int32), ref_kth.view(torch.int32))):
                fail(f"{name} {label}: differs from the plain version in "
                     f"{int((picks[0] != ref_picks[0]).any(1).sum())} rows")
        short_rows = int((kth >= 1e29).sum())
        nbr, diag = pallas_knn.pallas_cell_list_knn(pos, K, 1.0, grid, return_diagnostics=True)
        cpu_nbr, cpu_diag = pallas_knn.pallas_cell_list_knn(pos.cpu(), K, 1.0, grid,
                                                            return_diagnostics=True)
        if not (torch.equal(nbr.cpu(), cpu_nbr)
                and all(torch.equal(a.cpu(), b) for a, b in zip(diag, cpu_diag))):
            fail(f"K1 {label}: neighbors or diagnostics differ from the CPU plain path")
        overflow, excess = int(cpu_diag[0]), float(cpu_diag[2])
        if overflow == 0:
            fail(f"{label}: the CPU plain path certifies the frame (overflow 0)")
        layout = cellblock.cellblock_layout(pos, 1.0, spec)
        ds = cellblock.dense_search_inputs(layout, pos[layout.order], 1.0, spec, dspec)
        live = (torch.arange(dspec.query_block, device=dev) < ds.rows[:, None]).reshape(-1)
        k8_args = dict(k=K, query_block=dspec.query_block, w_eff=ds.w_eff)
        lanes, kth8 = cellblock.dense_select(ds.table, ds.queries, ds.windows, 1.0, ds.rows,
                                             **k8_args)
        ref_lanes, ref_kth8 = cellblock.dense_select_reference(ds.table, ds.queries, ds.windows,
                                                               1.0, **k8_args)
        if not (torch.equal(lanes[live], ref_lanes[live])
                and torch.equal(kth8[live].view(torch.int32), ref_kth8[live].view(torch.int32))):
            fail(f"K8 {label}: live rows differ from the plain version")
        out = plan_kernels(label, pos, certified=False)
        cpu_plan = cellblock.build_cellblock(
            pos.cpu(), None, 1.0, spec, with_reverse=True, neighbor_codes=out["codes"].cpu(),
            codes_cap=codes_cap, codes_spill=tuple(t.cpu() for t in out["spill"]))
        for field in ("s_table", "s_rev_table", "overflow", "dropped_edges",
                      "reverse_mismatch", "window_overflow"):
            mine, theirs = getattr(out["plan"], field), getattr(cpu_plan, field)
            if not (torch.equal(mine.cpu(), theirs) if mine.dim() else int(mine) == int(theirs)):
                fail(f"{label}: the plan's {field} differs from the CPU plain path")
        print(f"uncertified {label} ({share:.0%} in a sigma {sigma} ball): K1, K1', K1'' equal "
              f"to their plain versions ({n_spilled} spilled, {short_rows} rows short of k "
              f"candidates), K8 live rows equal; the CPU plain path's certificate false "
              f"(overflow {overflow}, max_excess {excess:.6g}), the card's equal; the plan's S, "
              f"S_rev, overflow {int(cpu_plan.overflow)}, dropped {int(cpu_plan.dropped_edges)}, "
              f"reverse_mismatch {int(cpu_plan.reverse_mismatch)} equal to the CPU plain path's")
        del out, cpu_plan, layout, ds
    print(f"phase 4b uncertified regime: {time.perf_counter() - t0:.1f} s")

    # ---- 5-8. the rollout slices -----------------------------------------
    stats = NormalizationStats.from_metadata(METADATA, device=dev)
    stats_cpu = NormalizationStats.from_metadata(METADATA, device="cpu")
    params_cpu = init_encode_process_decode(cfg, torch.Generator().manual_seed(args.seed),
                                            device="cpu")
    pos, temp = seed_window(N, args.seed)
    spos, stemp = seed_window(SMALL_N, args.seed + 2)
    mp = cfg.num_message_passing_steps
    zero = dict.fromkeys(kernels.KERNELS, 0)
    path_launches, path_ms, small_runs = {}, {}, {}
    hybrid = {"aggregation": "cellblock_hybrid"}
    # The aux route: the chooser's spec without k (grid 14 at N, 7 at
    # SMALL_N) is not on the k-NN grid (19, 9), so plans come from ids.
    aux_small_spec = cellblock.choose_cellblock_spec(SMALL_N)
    plan_launches = {"s_onehot": STEPS, "window_matmul": STEPS * mp, "fused_tail": STEPS * mp}
    paths = (
        ("gather", 5, {"aggregation": "gather"}, {}, {"knn_select": STEPS, "fused_tail": STEPS * mp}),
        ("cellblock_hybrid", 6, hybrid, {},
         {"knn_codes": STEPS, "s_decode": STEPS, **plan_launches}),
        ("cellblock_hybrid dense", 7, {**hybrid, "cellblock_search": "dense"}, {},
         {"dense_select": STEPS, **plan_launches}),
        ("cellblock_hybrid aux", 8, {**hybrid, "cellblock_spec": aux_spec},
         {"cellblock_spec": aux_small_spec}, {"knn_dual": STEPS, **plan_launches}),
    )
    for label, phase, path_kw, small_kw, expected in paths:
        t0 = time.perf_counter()
        kw = dict(num_neighbors=K, dtype=torch.bfloat16, exactness_guard="flag",
                  reneighbor_every=1, device=dev, **path_kw)
        rollout(params, cfg, pos, temp, stats, 1, **kw)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        result = rollout(params, cfg, pos, temp, stats, STEPS, **kw)
        end.record()
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        step_ms = start.elapsed_time(end) / STEPS
        coords_out, energy = result["Coordinates"], result["InternalEnergy"]
        if coords_out.shape != (WINDOW + STEPS, N, 3) or energy.shape != (WINDOW + STEPS, N, 1):
            fail(f"{label}: trajectory shapes {tuple(coords_out.shape)}, "
                 f"{tuple(energy.shape)}")
        if not (bool(torch.isfinite(coords_out).all()) and bool(torch.isfinite(energy).all())):
            fail(f"{label}: trajectory not finite")
        if not bool(result["neighbor_exactness"].all()):
            fail(f"{label}: certificate false on steps "
                 f"{result['neighbor_exactness'].tolist()}")
        if launches != {**zero, **expected}:
            fail(f"{label}: launches {launches}, expected {expected}")
        step = coords_out[-1] - coords_out[WINDOW - 1]
        moved = float((step - torch.round(step)).abs().max())  # min-image, box 1
        print(f"slice {label}: N={N} k={K} default model bf16, {STEPS} steps, "
              f"{step_ms:.3f} ms/step ({N / step_ms * 1e3:.0f} particle-steps/s), launches "
              f"{ {k: v for k, v in launches.items() if v} }, certificate true every step, "
              f"max displacement {moved:.3g}, peak memory {peak_gib:.3f} GiB")
        path_launches[label], path_ms[label] = launches, step_ms

        small_kw = {**kw, **small_kw}
        small_gpu = rollout(params, cfg, spos, stemp, stats, SMALL_STEPS, **small_kw)
        small_cpu = rollout(params_cpu, cfg, spos, stemp, stats_cpu, SMALL_STEPS,
                            **{**small_kw, "device": "cpu"}, fused_tail=True)
        small_err = float((small_gpu["Coordinates"].cpu() - small_cpu["Coordinates"]).abs().max())
        if not small_err <= SMALL_COORD_TOL:
            fail(f"{label}: N={SMALL_N} rollout differs from the CPU plain path "
                 f"by {small_err}")
        if not bool(small_gpu["neighbor_exactness"].all()):
            fail(f"{label}: N={SMALL_N} certificate false")
        small_runs[label] = small_gpu["Coordinates"]
        print(f"slice {label} check: N={SMALL_N}, {SMALL_STEPS} steps, card vs CPU plain "
              f"path max coordinate diff {small_err:.3g} (tol {SMALL_COORD_TOL})")
        if label != "gather":
            cross = float((small_runs[label] - small_runs["gather"]).abs().max())
            if not cross <= SMALL_COORD_TOL:
                fail(f"N={SMALL_N} {label} and gather rollouts on the card differ by {cross}")
            print(f"slice check: N={SMALL_N}, {label} vs gather on the card max coordinate "
                  f"diff {cross:.3g} (tol {SMALL_COORD_TOL})")
        print(f"phase {phase} slice {label}: {time.perf_counter() - t0:.1f} s")

    # ---- 9. one-step prediction ------------------------------------------
    t0 = time.perf_counter()
    for label, path_kw in (("gather", {"aggregation": "gather"}), ("cellblock_hybrid", hybrid),
                           ("cellblock_hybrid aux", {**hybrid, "cellblock_spec": aux_spec})):
        kw = dict(num_neighbors=K, dtype=torch.bfloat16, device=dev, **path_kw)
        new_pos, new_temp = one_step_prediction(params, cfg, pos, temp, stats, **kw)
        ref = rollout(params, cfg, pos, temp, stats, 1, **kw)
        if new_pos.shape != (N, 3) or new_temp.shape != (N, 1):
            fail(f"one-step {label}: shapes {tuple(new_pos.shape)}, {tuple(new_temp.shape)}")
        err = max(float((new_pos - ref["Coordinates"][-1]).abs().max()),
                  float((new_temp - ref["InternalEnergy"][-1]).abs().max()))
        if not err <= ONE_STEP_TOL:
            fail(f"one-step {label}: differs from a 1-step rollout by {err}")
        print(f"one-step {label}: N={N}, equal to the first frame of a 1-step rollout "
              f"(max diff {err:.3g}, tol {ONE_STEP_TOL})")
    print(f"phase 9 one-step: {time.perf_counter() - t0:.1f} s")

    # ---- 10, 11. the train slices ----------------------------------------
    tbatch = train_batch(N, args.seed)
    train_paths = (
        ("gather", 10, {"knn_select": 1, "fused_tail": mp, "fused_tail_bwd": mp}),
        ("cellblock_hybrid", 11, {"knn_codes": 1, "s_decode": 1, "s_onehot": 1,
                                 "reverse_table": 1, "window_matmul": mp,
                                 "window_matmul_t": mp, "fused_tail": mp,
                                 "fused_tail_bwd": mp}),
    )
    train_ms = {}
    for aggregation, phase, per_step in train_paths:
        t0 = time.perf_counter()
        tc = TrainConfig(aggregation=aggregation, num_neighbors=K, compute_dtype="bfloat16",
                         noise_std=TRAIN_NOISE)
        tparams = init_encode_process_decode(cfg, torch.Generator().manual_seed(args.seed),
                                             device=dev)
        optimizer = make_optimizer(tc, steps_per_epoch=TRAIN_STEPS + 1)
        state = optimizer.init(tparams)
        train_step = make_train_step(cfg, stats, tc, optimizer)
        tgen = torch.Generator(device=dev).manual_seed(args.seed)
        train_step(tparams, state, tbatch, tgen)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = [train_step(tparams, state, tbatch, tgen)[2] for _ in range(TRAIN_STEPS)]
        end.record()
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        step_ms = start.elapsed_time(end) / TRAIN_STEPS
        losses = [float(m["loss"]) for m in metrics]
        if not all(np.isfinite(losses)):
            fail(f"train {aggregation}: loss not finite: {losses}")
        if aggregation == "cellblock_hybrid":
            violations = [float(m["cellblock_violations"]) for m in metrics]
            if any(violations):
                fail(f"train {aggregation}: cellblock_violations {violations}")
        expected = {name: count * TRAIN_STEPS for name, count in per_step.items()}
        if launches != {**zero, **expected}:
            fail(f"train {aggregation}: launches {launches}, expected {expected}")
        print(f"train slice {aggregation}: N={N} k={K} default model bf16, noise "
              f"{TRAIN_NOISE}, batch 1, {TRAIN_STEPS} steps, {step_ms:.3f} ms/step, losses "
              f"{[float(f'{v:.6g}') for v in losses]}, launches "
              f"{ {k: v for k, v in launches.items() if v} }"
              + (", cellblock_violations 0 every step" if aggregation != "gather" else "")
              + f", peak memory {peak_gib:.3f} GiB")
        path_launches[f"train {aggregation}"], train_ms[aggregation] = launches, step_ms
        del tparams, state, optimizer, train_step, metrics
        print(f"phase {phase} train slice {aggregation}: {time.perf_counter() - t0:.1f} s")

    # One train step (noise 0, no augmentation, SGD with lr 1: the update
    # is the gradient) at N = 8,192 on the card and on the CPU plain path.
    t0 = time.perf_counter()
    sbatch = train_batch(SMALL_N, args.seed + 2)
    small_grads = {}
    for aggregation in ("gather", "cellblock_hybrid"):
        runs = {}
        for device in (dev, torch.device("cpu")):
            sgd = Optimizer(lambda leaves: torch.optim.SGD(leaves, lr=1.0))
            # The card resolves fused_tail=None to on; the CPU runs the
            # plain versions of K5 and K6.
            tc = TrainConfig(aggregation=aggregation, num_neighbors=K,
                             compute_dtype="bfloat16", noise_std=0.0, augment_prob=0.0,
                             fused_tail=True if device.type == "cpu" else None)
            sparams = init_encode_process_decode(cfg, torch.Generator().manual_seed(args.seed),
                                                 device=device)
            before = [t.detach().clone() for t in tree_leaves(sparams)]
            step = make_train_step(cfg, stats if device.type == "cuda" else stats_cpu, tc, sgd)
            sparams, _, m = step(sparams, sgd.init(sparams), sbatch,
                                 torch.Generator(device=device))
            grads = [(b - a.detach()).cpu() for b, a in zip(before, tree_leaves(sparams))]
            runs[device.type] = (float(m["loss"]), grads)
        (loss, grads), (cpu_loss, cpu_grads) = runs["cuda"], runs["cpu"]
        grad_err = max(float((a - b).abs().max()) / float(b.abs().max())
                       for a, b in zip(grads, cpu_grads) if float(b.abs().max()))
        loss_err = abs(loss - cpu_loss) / abs(cpu_loss)
        if not (loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_TOL):
            fail(f"train {aggregation}: N={SMALL_N} card vs CPU plain path: loss rel err "
                 f"{loss_err}, worst gradient rel err {grad_err}")
        print(f"train slice {aggregation} check: N={SMALL_N}, card vs CPU plain path: loss "
              f"{loss:.6g} vs {cpu_loss:.6g} (rel err {loss_err:.3g}, tol {TRAIN_LOSS_RTOL}), "
              f"worst gradient leaf rel err {grad_err:.3g} (tol {TRAIN_GRAD_TOL})")
        small_grads[aggregation] = grads
    cross = max(float((a - b).abs().max()) / float(b.abs().max())
                for a, b in zip(small_grads["cellblock_hybrid"], small_grads["gather"])
                if float(b.abs().max()))
    if not cross <= TRAIN_GRAD_TOL:
        fail(f"N={SMALL_N} hybrid and gather gradients on the card differ by {cross}")
    print(f"train slice check: N={SMALL_N}, hybrid vs gather gradients on the card: worst "
          f"leaf rel err {cross:.3g} (tol {TRAIN_GRAD_TOL})")
    print(f"phase 11 train check: {time.perf_counter() - t0:.1f} s")

    # ---- 12a. the Trainer slice ------------------------------------------
    t0 = time.perf_counter()
    # Kept for phase 18a, which refits the first epoch from the native feed.
    fit_sims = {"train": generate_synthetic_simulation(
        num_snapshots=FIT_TRAIN_SNAPSHOTS, num_particles=N, seed=args.seed + 10),
        "val": generate_synthetic_simulation(
        num_snapshots=FIT_VAL_SNAPSHOTS, num_particles=N, seed=args.seed + 11)}
    fit_train, fit_val = MemoryDataset([fit_sims["train"]]), MemoryDataset([fit_sims["val"]])
    train_steps, eval_steps = FIT_EPOCHS * len(fit_train), FIT_EPOCHS * len(fit_val)
    fit_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_fit_")  # removed after 12b
    fit_root = fit_tmp.name
    fit_tc = TrainConfig(aggregation="cellblock_hybrid", num_neighbors=K, batch_size=1,
                         compute_dtype="bfloat16", noise_std=TRAIN_NOISE, num_epochs=FIT_EPOCHS,
                         save_every=1, learning_rate=1e-4, final_learning_rate=1e-5,
                         seed=args.seed, output_dir=os.path.join(fit_root, "continuous"))

    def timed_steps(trainer):
        """Wrap the trainer's train step in CUDA events (no sync): each
        step's (start, end, metrics)."""
        steps, step = [], trainer.train_step

        def timed(*step_args):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            out = step(*step_args)
            end.record()
            steps.append((start, end, out[2]))
            return out

        trainer.train_step = timed
        return steps

    fitter = Trainer(cfg, stats, fit_tc, len(fit_train), device=dev)
    steps = timed_steps(fitter)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    fitter.fit(fit_train, fit_val)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    fit_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    expected = {"knn_codes": train_steps + eval_steps, "s_decode": train_steps + eval_steps,
                "s_onehot": train_steps + eval_steps, "reverse_table": train_steps,
                "window_matmul": mp * (train_steps + eval_steps),
                "window_matmul_t": mp * train_steps,
                "fused_tail": mp * (train_steps + eval_steps), "fused_tail_bwd": mp * train_steps}
    if launches != {**zero, **expected}:
        fail(f"Trainer.fit: launches {launches}, expected {expected}")
    h = fitter.history
    losses = h["train_loss"] + h["val_loss"]
    if len(h["train_loss"]) != FIT_EPOCHS or not all(np.isfinite(losses)):
        fail(f"Trainer.fit: losses {h['train_loss']}, {h['val_loss']}")
    violations = [float(m["cellblock_violations"]) for _, _, m in steps]
    if len(steps) != train_steps or any(violations):
        fail(f"Trainer.fit: {len(steps)} train steps, cellblock_violations {violations}")
    out_dir = fit_tc.output_dir
    artifacts = ["model_best", "model_final", "training_history.json",
                 *(f"model_epoch_{e}" for e in range(FIT_EPOCHS))]
    missing = [a for a in artifacts if not os.path.exists(os.path.join(out_dir, a))]
    with open(os.path.join(out_dir, "training_history.json")) as f:
        saved_history = json.load(f)
    if missing or sorted(saved_history) != HISTORY_KEYS or \
            sorted(saved_history["component_losses"]) != COMPONENT_KEYS:
        fail(f"Trainer.fit artifacts: missing {missing}, history keys {sorted(saved_history)}")
    per_epoch = len(fit_train)
    step_ms = [start.elapsed_time(end) for start, end, _ in steps]
    loop_ms = [steps[e * per_epoch][0].elapsed_time(steps[(e + 1) * per_epoch - 1][1]) / per_epoch
               for e in range(FIT_EPOCHS)]
    fit_step_ms = float(np.mean(step_ms[per_epoch:]))  # after the first epoch
    fit_first_epoch_ms = step_ms[:per_epoch]  # phase 18a's memory feed
    epoch_s = fitter.step_timer.summary()["train_epoch"]
    print(f"Trainer.fit cellblock_hybrid: N={N} k={K} default model bf16, noise {TRAIN_NOISE}, "
          f"batch 1, {FIT_EPOCHS} epochs of {per_epoch} train + {len(fit_val)} eval steps; "
          f"train losses {[float(f'{v:.6g}') for v in h['train_loss']]}, val losses "
          f"{[float(f'{v:.6g}') for v in h['val_loss']]}, cellblock_violations 0 every step; "
          f"launches { {k: v for k, v in launches.items() if v} }")
    print(f"Trainer.fit times: train loop per epoch (host clock, StepTimer) mean "
          f"{epoch_s['mean_s']:.4f} s, p50 {epoch_s['p50_s']:.4f} s, total "
          f"{epoch_s['total_s']:.4f} s; ms per train step inside fit (events around each "
          f"step, epochs 1-{FIT_EPOCHS - 1}) {fit_step_ms:.4f} against phase 11's bare step "
          f"{train_ms['cellblock_hybrid']:.4f}; ms per step of each epoch's loop (first step's "
          f"start to last step's end, over {per_epoch}) {[round(x, 4) for x in loop_ms]}; "
          f"peak memory {fit_peak_gib:.3f} GiB")
    path_launches["Trainer.fit"] = launches
    print(f"phase 12a Trainer slice: {time.perf_counter() - t0:.1f} s")

    # ---- 12b. resume equals continuous ------------------------------------
    t0 = time.perf_counter()
    resume_tc = dataclasses.replace(fit_tc, output_dir=os.path.join(fit_root, "resumed"))
    resumed = Trainer(cfg, stats, resume_tc, len(fit_train), device=dev)
    saved = ckpt_lib.load_state(os.path.join(out_dir, "model_epoch_0"))
    start_epoch = resumed.restore(os.path.join(out_dir, "model_epoch_0"))
    gamma = (fit_tc.final_learning_rate / fit_tc.learning_rate) ** (1 / FIT_EPOCHS)
    lr = resumed.opt_state.optimizer.param_groups[0]["lr"]
    if (start_epoch != 1 or resumed.opt_state.schedule.last_epoch != per_epoch
            or abs(lr - fit_tc.learning_rate * gamma) > 1e-12 * fit_tc.learning_rate
            or not torch.equal(resumed.generator.get_state(), saved["generator"])):
        fail(f"restore: start epoch {start_epoch}, schedule step "
             f"{resumed.opt_state.schedule.last_epoch}, lr {lr}, generator state restored "
             f"{torch.equal(resumed.generator.get_state(), saved['generator'])}")
    # The resumed fit runs with CUDA's sync debug mode on: every call that
    # makes the host wait for the device warns. The loop must make none
    # between two train steps of an epoch (its reads are once an epoch).
    marks, step = [], resumed.train_step

    def sync_calls():
        return [w for w in caught if "synchronizing CUDA operation" in str(w.message)]

    def marked(*step_args):
        first = len(sync_calls())
        out = step(*step_args)
        marks.append((first, len(sync_calls())))
        return out

    resumed.train_step = marked
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            resumed.fit(fit_train, fit_val, start_epoch=start_epoch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    in_step = [end - begin for begin, end in marks]
    sync_sites = collections.Counter(f"{os.path.relpath(w.filename)}:{w.lineno}"
                                     for w in sync_calls()[marks[0][0]:marks[0][1]])
    between = [marks[i + 1][0] - marks[i][1] for i in range(len(marks) - 1)
               if (i + 1) % per_epoch]
    if any(between):
        fail(f"Trainer.fit: synchronizing calls between train steps {between}")
    a = ckpt_lib.load_state(os.path.join(out_dir, f"model_epoch_{FIT_EPOCHS - 1}"))
    b = ckpt_lib.load_state(os.path.join(resume_tc.output_dir, f"model_epoch_{FIT_EPOCHS - 1}"))
    diffs = [float((x - y).abs().max()) for x, y in zip(tree_leaves(a["params"]),
                                                         tree_leaves(b["params"]))]
    for i, state in a["optimizer"]["state"].items():
        other = b["optimizer"]["state"][i]
        diffs += [float((state[key] - other[key]).abs().max())
                  for key in ("step", "exp_avg", "exp_avg_sq")]
    if max(diffs) != 0 or not torch.equal(a["generator"], b["generator"]) \
            or a["schedule"] != b["schedule"] or resumed.history != fitter.history:
        fail(f"resume differs from the continuous run: largest difference {max(diffs)} over "
             f"params and Adam state; generator equal "
             f"{torch.equal(a['generator'], b['generator'])}, schedule equal "
             f"{a['schedule'] == b['schedule']}")
    print(f"resume: model_epoch_0 restored (epoch 1 next, schedule step {per_epoch}, lr {lr:.6g}, "
          f"generator state equal); model_epoch_{FIT_EPOCHS - 1} params and Adam state "
          f"bit-equal to the continuous run's, history equal; synchronizing calls inside each "
          f"train step {in_step}, between the steps of an epoch {between}, "
          f"{len(sync_calls()) - sum(in_step)} in the fit outside its train steps; the first "
          f"step's at "
          f"{dict(sync_sites)}")
    fit_epoch0 = saved  # phase 18a's refit is held to it
    del fitter, resumed, saved, a, b
    fit_tmp.cleanup()
    print(f"phase 12b resume: {time.perf_counter() - t0:.1f} s")

    # ---- 12c. remat -------------------------------------------------------
    # One train step (noise 0, no augmentation, SGD with lr 1: the update is
    # the gradient) with remat, remat_chunk=5 and neither. The recomputation
    # runs each checkpointed step's forward again before its backward, and
    # each chunk's forward again up to its last step's input (torch's
    # early-stopping recomputation): K4 and K5 run M, 2M and
    # 2M + (M / c)(c - 1) times (tests/test_torch_remat.py).
    t0 = time.perf_counter()
    rbatch = train_batch(N, args.seed + 3)
    chunk = 5
    remat_paths = (
        ("cellblock_hybrid", "bf16, fused tail", dict(compute_dtype="bfloat16", fused_tail=None),
         {"knn_codes": 1, "s_decode": 1, "s_onehot": 1, "reverse_table": 1,
          "window_matmul_t": mp, "fused_tail_bwd": mp}, ("window_matmul", "fused_tail")),
        ("gather", "f32, no fused tail", dict(compute_dtype=None, fused_tail=False),
         {"knn_select": 1}, ()),
    )
    for aggregation, label, tc_kw, fixed, recomputed in remat_paths:
        runs = {}
        for name, model_kw, forwards in (
                ("none", {}, mp), ("remat", {"remat": True}, 2 * mp),
                (f"remat_chunk={chunk}", {"remat_chunk": chunk},
                 2 * mp + (mp // chunk) * (chunk - 1))):
            rcfg = cfg._replace(**model_kw)
            tc = TrainConfig(aggregation=aggregation, num_neighbors=K, noise_std=0.0,
                             augment_prob=0.0, **tc_kw)
            sgd = Optimizer(lambda leaves: torch.optim.SGD(leaves, lr=1.0))
            rparams = init_encode_process_decode(rcfg, torch.Generator().manual_seed(args.seed),
                                                 device=dev)
            before = [t.detach().clone() for t in tree_leaves(rparams)]
            step = make_train_step(rcfg, stats, tc, sgd)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            rparams, _, m = step(rparams, sgd.init(rparams), rbatch, torch.Generator(device=dev))
            torch.cuda.synchronize()
            launches = dict(kernels.launches)
            peak = torch.cuda.max_memory_allocated() / 2**30
            expected = {**fixed, **dict.fromkeys(recomputed, forwards)}
            if launches != {**zero, **expected}:
                fail(f"remat {aggregation} {name}: launches {launches}, expected {expected}")
            grads = [b - a.detach() for b, a in zip(before, tree_leaves(rparams))]
            runs[name] = (float(m["loss"]), grads, peak, forwards)
            del rparams, before, step, sgd
        loss, grads = runs["none"][:2]
        for name, (rloss, rgrads, _, _) in runs.items():
            err = max(float((a - b).abs().max()) for a, b in zip(rgrads, grads))
            if rloss != loss or err > REMAT_GRAD_TOL:
                fail(f"remat {aggregation} {name}: loss {rloss} vs {loss}, largest gradient "
                     f"difference {err}")
        peaks = ", ".join(f"{name} {run[2]:.3f} GiB" for name, run in runs.items())
        counts = (f"; K4 and K5 launches {', '.join(str(run[3]) for run in runs.values())}"
                  if recomputed else "")
        print(f"remat {aggregation} {label}: N={N}, loss and every gradient leaf bit-equal to "
              f"the run without remat; peak memory {peaks}{counts}")
    print(f"phase 12c remat: {time.perf_counter() - t0:.1f} s")

    # ---- 13a. K9 against its plain version --------------------------------
    # K9 (the brute-force k-NN that reads its gate on the device) against
    # knn_periodic_reference (512 queries a tile) on the uniform frame, the
    # clustered frame where the certificate fails (30 % in a sigma 0.05
    # ball), the lattice frame (ties) and 10,000 separate queries against
    # the uniform frame, at k = 16 and 48: ids equal, d2 bit-equal. The
    # plain version's stable sort of all N distances is computed once per
    # frame at k = 48; its first 16 columns are the k = 16 answer.
    t0 = time.perf_counter()
    clustered30 = torch.as_tensor(clustered_frame(N, 0.30, 0.05, args.seed + 21), device=dev)
    queries = torch.rand(BRUTE_QUERIES, 3,
                         generator=torch.Generator().manual_seed(args.seed + 5)).to(dev)
    brute_frames = (("uniform", pos0, None), ("clustered30", clustered30, None),
                    ("lattice", lattice, None), (f"{BRUTE_QUERIES} queries", pos0, queries))
    for label, pos, qs in brute_frames:
        ref_ids, ref_d2 = knn_periodic_reference(pos, K1_WIDE_K, 1.0, queries=qs,
                                                 query_tile=512, return_distances=True)
        for k in (K, K1_WIDE_K):
            ids, d2 = knn_periodic(pos, k, 1.0, queries=qs, return_distances=True)
            if not torch.equal(ids, ref_ids[:, :k]):
                fail(f"K9 {label} k={k}: ids differ from the plain version in "
                     f"{int((ids != ref_ids[:, :k]).any(1).sum())} rows")
            if not torch.equal(d2.view(torch.int32),
                               ref_d2[:, :k].contiguous().view(torch.int32)):
                fail(f"K9 {label} k={k}: d2 not bit-equal to the plain version")
        ties = int((ref_d2[:, 1:] == ref_d2[:, :-1]).sum())
        print(f"K9 {label}: ids equal and d2 bit-equal to the plain version at k = {K} and "
              f"{K1_WIDE_K} ({ties} tied neighbor pairs in the k = {K1_WIDE_K} rows)")
    # The gate: set, the buffers keep every bit; clear, they take the search.
    fill_ids = torch.full((N, K), -7, dtype=torch.int64, device=dev)
    fill_d2 = torch.full((N, K), -1.5, dtype=torch.float32, device=dev)
    held = torch.ones((), dtype=torch.bool, device=dev)
    cleared = torch.zeros((), dtype=torch.bool, device=dev)
    buf = (fill_ids.clone(), fill_d2.clone())
    knn_periodic(clustered30, K, 1.0, return_distances=True, skip_if=held, out=buf)
    if not (torch.equal(buf[0], fill_ids)
            and torch.equal(buf[1].view(torch.int32), fill_d2.view(torch.int32))):
        fail("K9 with the gate set changed its output buffer")
    knn_periodic(clustered30, K, 1.0, return_distances=True, skip_if=cleared, out=buf)
    ref_ids, ref_d2 = knn_periodic_reference(clustered30, K, 1.0, return_distances=True)
    if not (torch.equal(buf[0], ref_ids)
            and torch.equal(buf[1].view(torch.int32), ref_d2.view(torch.int32))):
        fail("K9 with the gate clear differs from the plain version")
    print("K9 gate: set, the output buffer is bit-equal to what it held; clear, it holds the "
          "plain version's ids and d2")
    k9_out = torch.empty((N, K), dtype=torch.int64, device=dev)
    k9_ms = time_ms(lambda: knn_periodic(pos0, K, 1.0, out=k9_out), 3)
    k9_graph_ms = graph_ms(lambda: knn_periodic(pos0, K, 1.0, out=k9_out), 3)
    k9_gated_ms = time_ms(lambda: knn_periodic(pos0, K, 1.0, skip_if=held, out=k9_out), 100)
    k9_gated_graph_ms = graph_ms(
        lambda: knn_periodic(pos0, K, 1.0, skip_if=held, out=k9_out), 100)
    k9_plain_ms = time_ms(lambda: knn_periodic_reference(pos0, K, 1.0, query_tile=512), 1)
    k9_48_ms = time_ms(lambda: knn_periodic(pos0, K1_WIDE_K, 1.0), 3)
    # In: the reference set (12 B a point); out: ids [N, k] int64. Per
    # (query, point) pair the code does 21 float32 operations: per axis a
    # subtraction, a division, a rint, a product and a subtraction, then
    # three squares, two sums and a compare with the k-th.
    k9_bytes = nbytes(pos0) + N * K * 8
    k9_ops = 21 * N * N
    report["knn_brute"] = kernel_entry(
        "knn_brute.cu", "neighbors.py:48", 0.0, k9_ms, k9_plain_ms, k9_bytes, k9_ops,
        F32_FLOP_PER_S, None)
    report["knn_brute"].update(
        graph_ms=k9_graph_ms, gated_ms=k9_gated_ms, gated_graph_ms=k9_gated_graph_ms,
        note="no Pallas counterpart: replaces names the JAX package's XLA brute force, "
             "gated there by lax.cond (rollout.py:295)")
    print(f"K9 N={N} k={K}: active {k9_ms:.4f} ms (graph {k9_graph_ms:.4f}), gated "
          f"{k9_gated_ms:.4f} ms (graph {k9_gated_graph_ms:.4f}), plain {k9_plain_ms:.3f} ms, "
          f"bound {report['knn_brute']['bound_ms']:.4f} ms ({k9_ops} operations); "
          f"k={K1_WIDE_K} active {k9_48_ms:.4f} ms")
    print_ptxas(logs, "knn_brute")
    print(f"phase 13a K9: {time.perf_counter() - t0:.1f} s")

    # ---- 13b. the brute-force fallback -----------------------------------
    # exactness_guard="fallback" on gather: at each step K1 searches and K9,
    # gated by K1's certificate on the device, overwrites K1's ids where it
    # fails. On a clustered seed window (the certificate fails every step)
    # the trajectory must equal the brute-force rollout's and differ from
    # the flag guard's; on the uniform window K9 runs gated every step and
    # the trajectory must equal the flag guard's. The fallback must add no
    # synchronizing call to a step.
    t0 = time.perf_counter()
    gather_kw = dict(num_neighbors=K, dtype=torch.bfloat16, aggregation="gather", device=dev)
    cpos, ctemp = (torch.as_tensor(a, device=dev) for a in clustered_window(N, args.seed + 21))
    upos, utemp = (torch.as_tensor(a, device=dev) for a in seed_window(N, args.seed))

    def counted_rollout(pos_w, temp_w, steps, **kw):
        rollout(params, cfg, pos_w, temp_w, stats, 1, **gather_kw, **kw)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = rollout(params, cfg, pos_w, temp_w, stats, steps, **gather_kw, **kw)
        end.record()
        torch.cuda.synchronize()
        return out, dict(kernels.launches), start.elapsed_time(end) / steps

    fallback_runs = (
        ("clustered fallback", cpos, ctemp, dict(exactness_guard="fallback"),
         {"knn_select": 1, "knn_brute": 1}),
        ("clustered bruteforce", cpos, ctemp, dict(neighbor_method="bruteforce"),
         {"knn_brute": 1}),
        ("clustered flag", cpos, ctemp, {}, {"knn_select": 1}),
        ("uniform fallback", upos, utemp, dict(exactness_guard="fallback"),
         {"knn_select": 1, "knn_brute": 1}),
        ("uniform flag", upos, utemp, {}, {"knn_select": 1}),
    )
    runs = {}
    for label, pos_w, temp_w, kw, searches in fallback_runs:
        out, launches, ms = runs[label] = counted_rollout(pos_w, temp_w, FALLBACK_STEPS, **kw)
        per_step = {**searches, "fused_tail": mp}
        expected = {name: c * FALLBACK_STEPS for name, c in per_step.items()}
        if launches != {**zero, **expected}:
            fail(f"{label}: launches {launches}, expected {expected}")
        if not (bool(torch.isfinite(out["Coordinates"]).all())
                and bool(torch.isfinite(out["InternalEnergy"]).all())):
            fail(f"{label}: trajectory not finite")
    flags = {label: run[0]["neighbor_exactness"].tolist() for label, run in runs.items()}
    if any(flags["clustered fallback"]) or flags["clustered fallback"] != flags["clustered flag"]:
        fail(f"clustered window: certificates {flags['clustered fallback']} (fallback), "
             f"{flags['clustered flag']} (flag): must be false every step on both")
    if not (all(flags["uniform fallback"]) and all(flags["uniform flag"])):
        fail(f"uniform window: certificates {flags['uniform fallback']}, {flags['uniform flag']}")

    def max_diff(a, b):
        """Largest difference of the two trajectories (coordinates min-imaged,
        box 1)."""
        d_pos = runs[a][0]["Coordinates"] - runs[b][0]["Coordinates"]
        d_temp = runs[a][0]["InternalEnergy"] - runs[b][0]["InternalEnergy"]
        return max(float((d_pos - torch.round(d_pos)).abs().max()),
                   float(d_temp.abs().max()))

    def bit_equal(a, b):
        return all(torch.equal(runs[a][0][key], runs[b][0][key])
                   for key in ("Coordinates", "InternalEnergy"))

    brute_diff = max_diff("clustered fallback", "clustered bruteforce")
    if not brute_diff <= FALLBACK_TOL:
        fail(f"clustered fallback differs from the brute-force rollout by {brute_diff}")
    flag_diff = min(max_diff("clustered flag", "clustered fallback"),
                    max_diff("clustered flag", "clustered bruteforce"))
    if not flag_diff > 0:
        fail("clustered window: the flag guard's trajectory equals the exact one")
    if not bit_equal("uniform fallback", "uniform flag"):
        fail(f"uniform fallback differs from the flag guard by "
             f"{max_diff('uniform fallback', 'uniform flag')}")
    brute_equal = bit_equal("clustered fallback", "clustered bruteforce")
    print(f"fallback clustered: N={N}, {FALLBACK_STEPS} steps, certificate false every step, "
          f"launches K1, K9 once and K5 {mp} times a step; trajectory "
          f"{'bit-equal' if brute_equal else f'within {FALLBACK_TOL}'} to "
          f"neighbor_method='bruteforce' (max diff {brute_diff:.3g}; K9 once, K1 never a "
          f"step); the flag guard's differs by {flag_diff:.3g}; ms per step fallback "
          f"{runs['clustered fallback'][2]:.4f}, bruteforce "
          f"{runs['clustered bruteforce'][2]:.4f}, flag {runs['clustered flag'][2]:.4f}")
    print(f"fallback uniform: certificate true every step, K9 launched gated every step, "
          f"trajectory bit-equal to the flag guard's; ms per step fallback "
          f"{runs['uniform fallback'][2]:.4f}, flag {runs['uniform flag'][2]:.4f}")
    path_launches["fallback clustered"] = runs["clustered fallback"][1]
    path_ms["gather fallback clustered"] = runs["clustered fallback"][2]
    path_ms["gather fallback uniform"] = runs["uniform fallback"][2]

    def sync_warnings(fn):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return [w for w in caught if "synchronizing CUDA operation" in str(w.message)]

    syncs = {}
    for guard in ("flag", "fallback"):
        counts = [len(sync_warnings(lambda s=steps: rollout(
            params, cfg, upos, utemp, stats, s, exactness_guard=guard, **gather_kw)))
            for steps in (2, 4)]
        syncs[guard] = (counts, (counts[1] - counts[0]) / 2)
    if syncs["fallback"] != syncs["flag"]:
        fail(f"synchronizing calls (2-step, 4-step rollouts; per step) flag {syncs['flag']}, "
             f"fallback {syncs['fallback']}: the fallback must add none")
    print(f"synchronizing calls in a gather rollout from device tensors (2 and 4 steps; per "
          f"step): flag {syncs['flag'][0]}, {syncs['flag'][1]:g}; fallback "
          f"{syncs['fallback'][0]}, {syncs['fallback'][1]:g}")
    # N = 8,192 on a clustered window: the card against the CPU plain path.
    spos_c, stemp_c = clustered_window(SMALL_N, args.seed + 22)
    small_kw = dict(num_neighbors=K, dtype=torch.bfloat16, exactness_guard="fallback")
    small_gpu = rollout(params, cfg, spos_c, stemp_c, stats, SMALL_STEPS, device=dev, **small_kw)
    small_cpu = rollout(params_cpu, cfg, spos_c, stemp_c, stats_cpu, SMALL_STEPS, device="cpu",
                        fused_tail=True, **small_kw)
    small_err = float((small_gpu["Coordinates"].cpu() - small_cpu["Coordinates"]).abs().max())
    if not small_err <= SMALL_COORD_TOL or not torch.equal(
            small_gpu["neighbor_exactness"].cpu(), small_cpu["neighbor_exactness"]):
        fail(f"N={SMALL_N} clustered fallback: card vs CPU plain path max diff {small_err}, "
             f"certificates {small_gpu['neighbor_exactness'].tolist()} vs "
             f"{small_cpu['neighbor_exactness'].tolist()}")
    print(f"fallback check: N={SMALL_N} clustered, {SMALL_STEPS} steps, certificates "
          f"{small_cpu['neighbor_exactness'].tolist()} on both, card vs CPU plain path max "
          f"coordinate diff {small_err:.3g} (tol {SMALL_COORD_TOL})")
    del runs, cpos, ctemp
    print(f"phase 13b fallback: {time.perf_counter() - t0:.1f} s")

    # ---- 13c. sorted_state="on" -------------------------------------------
    # The gather rollout with its window in cell-sorted order, re-sorted at
    # each re-neighboring: bit-equal to the unsorted rollout on the
    # (tie-free) seed window, at R = 1 and 2.
    t0 = time.perf_counter()
    sorted_ms = {}
    for r in (1, 2):
        expected = {"knn_select": STEPS // r, "fused_tail": STEPS * mp}
        pair = {}
        for state in ("on", "off"):
            out, launches, sorted_ms[(state, r)] = counted_rollout(
                upos, utemp, STEPS, sorted_state=state, reneighbor_every=r)
            if launches != {**zero, **expected}:
                fail(f"sorted_state={state} R={r}: launches {launches}, expected {expected}")
            pair[state] = out
        if not all(torch.equal(pair["on"][key], pair["off"][key]) for key in pair["on"]):
            fail(f"sorted_state on vs off at R={r}: max diff "
                 f"{float((pair['on']['Coordinates'] - pair['off']['Coordinates']).abs().max())}")
    print(f"sorted_state: N={N}, {STEPS} steps, on bit-equal to off at R = 1 and 2 (certificate "
          f"too); ms per step on {sorted_ms[('on', 1)]:.4f}, off {sorted_ms[('off', 1)]:.4f} "
          f"(R=1), on {sorted_ms[('on', 2)]:.4f}, off {sorted_ms[('off', 2)]:.4f} (R=2)")
    print(f"phase 13c sorted_state: {time.perf_counter() - t0:.1f} s")

    # ---- 13d. evaluation at full width -----------------------------------
    # validate_one_step on gather and hybrid over an in-memory synthetic
    # simulation (bf16, 4 windows): exact launch counts, and every error the
    # numpy MSE of a direct one_step_prediction of its window, bit for bit.
    # Then render_rollout's body (the CLI after its HDF5 read) for 6 steps
    # with --exactness_guard fallback into a temporary directory.
    t0 = time.perf_counter()
    eval_sim = generate_synthetic_simulation(num_snapshots=EVAL_SNAPSHOTS, num_particles=N,
                                             seed=args.seed + 12)
    eval_paths = (("gather", {"knn_select": 1, "fused_tail": mp}),
                  ("cellblock_hybrid", {"knn_codes": 1, "s_decode": 1, "s_onehot": 1,
                                        "window_matmul": mp, "fused_tail": mp}))
    for aggregation, per_window in eval_paths:
        kw = dict(num_neighbors=K, dtype=torch.bfloat16, aggregation=aggregation, device=dev)
        torch.cuda.synchronize()
        kernels.reset_launches()
        result = validate_one_step(params, cfg, eval_sim, stats, WINDOW,
                                   num_timesteps=EVAL_WINDOWS, seed=args.seed, **kw)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        expected = {name: c * EVAL_WINDOWS for name, c in per_window.items()}
        if launches != {**zero, **expected}:
            fail(f"validate_one_step {aggregation}: launches {launches}, expected {expected}")
        for i, t in enumerate(result["tested_timesteps"]):
            new_pos, new_temp = one_step_prediction(
                params, cfg, eval_sim["Coordinates"][t - WINDOW:t],
                eval_sim["InternalEnergy"][t - WINDOW:t], stats, **kw)
            pos_mse = float(np.mean((new_pos.cpu().numpy() - eval_sim["Coordinates"][t]) ** 2))
            temp_mse = float(np.mean((new_temp.cpu().numpy()
                                      - eval_sim["InternalEnergy"][t]) ** 2))
            if (result["position_errors"][i], result["temperature_errors"][i]) != (pos_mse,
                                                                                   temp_mse):
                fail(f"validate_one_step {aggregation}: timestep {t} errors "
                     f"{result['position_errors'][i]}, {result['temperature_errors'][i]} vs a "
                     f"direct one_step_prediction's {pos_mse}, {temp_mse}")
        if not (np.isfinite(result["position_error"])
                and np.isfinite(result["temperature_error"])):
            fail(f"validate_one_step {aggregation}: errors not finite: {result}")
        path_launches[f"validate_one_step {aggregation}"] = launches
        print(f"validate_one_step {aggregation}: N={N}, timesteps {result['tested_timesteps']}, "
              f"position MSE {result['position_error']:.6e}, temperature MSE "
              f"{result['temperature_error']:.6e}, each the MSE of a direct "
              f"one_step_prediction bit for bit; launches "
              f"{ {k: v for k, v in launches.items() if v} }")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_render_") as render_dir:
        render_args = render_rollout.parse_args([
            "--model_path", "in-memory", "--test_data", "in-memory", "--metadata_path",
            "in-memory", "--output_dir", render_dir, "--num_steps", str(RENDER_STEPS),
            "--num_neighbors", str(K), "--exactness_guard", "fallback", "--device", "cuda"])
        ground_truth = {key: eval_sim[key] for key in ("Coordinates", "InternalEnergy")}
        printed = io.StringIO()
        torch.cuda.synchronize()
        kernels.reset_launches()
        with contextlib.redirect_stdout(printed):
            errors = render_rollout.render(render_args, params, cfg, stats, ground_truth)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        printed = printed.getvalue()
        files = sorted(os.listdir(render_dir))
        coords_npy = np.load(os.path.join(render_dir, "rollout_coordinates.npy"))
        temps_npy = np.load(os.path.join(render_dir, "rollout_temperatures.npy"))
        with open(os.path.join(render_dir, "rollout_summary.txt")) as f:
            summary = f.read()
    # The CLI's own default: float32, so no fused tail (K5 takes bf16 only);
    # the exactness check of the seed frame runs the plain cell list. The
    # random weights bunch the particles within a few steps, so the
    # certificate may fail: the fallback's K9 runs, gated or not, every step.
    expected = {"knn_select": RENDER_STEPS, "knn_brute": RENDER_STEPS}
    if launches != {**zero, **expected}:
        fail(f"render_rollout: launches {launches}, expected {expected}")
    frames = WINDOW + RENDER_STEPS
    plotted = "errors.png" in files
    summary_lines = ("Rollout Summary", "Model: in-memory", f"Number of particles: {N}",
                     f"Window size: {WINDOW}", f"Time steps simulated: {RENDER_STEPS}",
                     "Mean position MSE: ", "Mean temperature MSE: ")
    if (coords_npy.shape != (frames, N, 3) or temps_npy.shape != (frames, N, 1)
            or not np.isfinite(coords_npy).all() or not np.isfinite(temps_npy).all()
            or not all(line in summary for line in summary_lines)
            or not np.isfinite(errors["position_errors"]).all()
            or len(errors["position_errors"]) != frames
            or not re.search(r"kNN exactness certificate held for every rollout step|"
                             r"NOTE: \d+/\d+ steps failed the bucketed-kNN certificate and "
                             r"were rerun with exact brute force", printed)
            or (not plotted and "plotting skipped" not in printed)):
        fail(f"render_rollout: files {files}, shapes {coords_npy.shape}, {temps_npy.shape}, "
             f"summary {summary!r}, printed {printed!r}")
    guard_line = next(line for line in printed.splitlines()
                      if "certificate" in line)
    print(f"render_rollout body: N={N}, {RENDER_STEPS} steps, --exactness_guard fallback "
          f"('{guard_line}'), files {files}, trajectories "
          f"{coords_npy.shape} and {temps_npy.shape} finite, summary with the JAX CLI's lines, "
          f"mean position MSE {errors['mean_position_error']:.6e}, "
          f"{'errors.png written' if plotted else 'plotting skipped (no matplotlib)'}; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    path_launches["render_rollout"] = launches
    print(f"phase 13d evaluation: {time.perf_counter() - t0:.1f} s")

    c4_rollout_ms, c4_train_ms = config4_phases(args, dev, report, path_launches, zero)
    table_ms = table_phase(args, dev, report, path_launches, zero)
    sharded_ms = sharded_phase(args, dev, report, path_launches, zero)
    slab, gid_ms = halo_phase(args, dev, report, path_launches, zero, cfg, stats, train_ms)
    halo_ms = halo_ranks_phase(args, dev, zero)
    entry_ms = entry_points_phase(args, dev, zero, cfg, stats, fit_sims, fit_tc, fit_epoch0,
                                  fit_first_epoch_ms)

    # ---- 12. kernels line ------------------------------------------------
    kernels_line = []
    for name, entry in report.items():
        launches = next((counts[name] for counts in path_launches.values() if counts[name]), 0)
        kernels_line.append({"name": name, **entry, "launches": launches})
    rollout_ms = ", ".join(f"{label} {ms:.4f}" for label, ms in path_ms.items())
    print(f"total: {time.perf_counter() - t_all:.1f} s, ms per rollout step {rollout_ms}; ms "
          f"per train step gather {train_ms['gather']:.4f}, cellblock_hybrid "
          f"{train_ms['cellblock_hybrid']:.4f}; config 4 ms per rollout step "
          + ", ".join(f"{label} {ms:.4f}" for label, ms in c4_rollout_ms.items())
          + f", per train step {c4_train_ms:.4f}; table layout plan build ms (particle, "
          f"table) " + ", ".join(f"{name} {r['particle']:.4f} {r['table']:.4f}"
                                 for name, r in table_ms.items())
          + "; sharded (1,1) ms " + ", ".join(f"{name} {v:.4f}" for name, v in sharded_ms.items())
          + f"; config-5 slab plan build {slab['build_ms']:.4f} ms (peak "
          f"{slab['build_peak_gib']:.3f} GiB), gid-keyed train step {gid_ms:.4f} ms; halo ms "
          f"per rank " + ", ".join(f"{name} {[round(v, 3) for v in values]}"
                                   for name, values in halo_ms.items())
          + f"; entry points: native feed ms per train step "
          f"{[round(v, 4) for v in entry_ms['18a']['step_ms']]}, halo Trainer (cli.train, P "
          f"= {ENTRY_WORLD}) ms per step per rank {[round(v, 1) for v in entry_ms['18b']]}, "
          f"halo render ms per step per rank " + ", ".join(
              f"P={p} {[round(v, 1) for v in values]}" for p, values in entry_ms["18c"].items())
          + f"; phase 18 {entry_ms['s']:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
