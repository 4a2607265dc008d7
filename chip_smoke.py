#!/usr/bin/env python3
"""Drive the PyTorch port (``rec_now_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which ends the script with a non-zero exit on failure:

1. print the card (``nvidia-smi`` name and power limit); f32 matmuls and
   convolutions in full f32 (TF32 off);
2. build the package's CUDA sources, one nvcc each, all at once (timed,
   with ptxas's register and spill report);
3. hold each kernel against its plain PyTorch version on the card at the
   xDeepFM config-3 shapes (B = 8192, D = 16, F = 26, CIN (64, 64);
   the pair loss on a ``SyntheticCriteo`` batch; the Adagrad pass over
   the 2.6M x 16 table), at config 4's (the multi-expert dense at its
   four distinct banks, B = 8192; the listwise loss on the same batch
   on its one-block sort path and forced onto its sweep, at B = 8193 (the
   sweep), on ids at the int32 ends, one group and singletons at 8192, a
   {+1, -1} group and degenerate batches, graded labels at thresholds 0.3
   and -0.25 on both paths, each repeated bit for bit, and
   its device time by kernel on each path, the sort path failing unless
   it is one launch), at config 2's (lazy Adam over the 2.6M x 16 table
   with the touched rows of a B = 8192 batch, t = 1 and 1000, ragged
   tables with rows touched only in a partial last flag chunk, each
   repeated bit for bit, and its device time; the
   pair counts and the general pair loss on a B = 8192 batch with graded
   labels, two groups and a 0/1 mask: B7a and B7c on each path (auto,
   the sort, the sweep), B7b's hash (exact on counts; on f32 vec 1e-6
   of the largest sum), B7c also on
   graded labels with a fractional mask (1e-6 of the largest count), the
   general loss in one call on each path (the one sort, the composition
   of sweeps) against its plain version and the B7a -> B7b -> B3
   composition (loss 1e-5, dlogits 1e-4, the count exact), each repeated
   bit for bit, and B7a/b/c's paths and the general loss, one call and
   composed, by events and by kernel on the device (B7b also at B =
   8,193), auto failing unless it takes the sort (B7b: unless it runs
   its memset and two hash kernels) and the general call unless it
   runs the sort, B7a's count sweep, B3's sweep and B3's merge once
   each), the row gather (B11, bit-exact)
   and the row scatter-add (B12, within 1e-6 of each output's summed
   scale) on the 2.6M x 16 table with a B = 8192 batch's 212,992 ids (the
   dense buffer, the sparse path's dedup and its sentinel-heavy
   write-backs, ragged, empty and out-of-range ids, vals off the 16-byte
   grid), B9-B12 at config 5's CAN table (100,000 x 272: B9 within 1e-6
   of each output's scale; B10 with the CAN ids of a B = 8192 batch
   touched, t = 1 and 1000; B11 and B12 with those 8,192 ids), and at
   ragged tables of widths 45 and 72 (a warp a row, on floats and on
   float4s), each repeated bit for bit and timed by events and on the
   device beside its bound; the pooled multi-hot lookup
   (``gather_pool_rows``, bit-exact) on MLPerf DLRM-DCNv2's 26 fields
   capped at 2^22 rows (25.2M rows of 128, rows past 2^31 floats) at B =
   8192 with 214 ids an example, int64 and int32 ids, ragged, out of
   range, a table off the 16-byte grid and D = 5 (the scalar loop), no
   example launching nothing, timed beside its bound and
   ``F.embedding_bag``; and at ragged shapes and the multi-expert
   dense's dispatch
   edges (N * U = 16 and 17, a small per-expert bank, W too deep for the
   gate kernel, x off the 16-byte grid), and time kernel, plain version
   and, where one exists, a single PyTorch call computing the same
   function (CUDA events, median of 20; each multi-expert dense bank
   and each CIN layer beside its bound on the unit that runs it: split
   TF32 on the tensor cores (the CIN layer also at the f32 rate), or f32
   for the gate kernel); B8's wgmma kernel (``linear_wg``) at the main
   paths' tower layers at B = 8192 (DLRM-DCNv2's over arch 3,456 ->
   1,024 -> 1,024 -> 512 -> 256 and dense arch 512 -> 256 -> 128, the
   benchmark's xDeepFM 400 -> 400; nn.Linear's weights, bias and ReLU
   fused), each one launch, against float64 (2e-6 of the largest
   output), beside its bound, the plain version and F.linear + ReLU in
   float32, and wgmma_plan's crossover (400 -> 400 and 512 -> 256 at B =
   1,024-8,192, both ways); ptxas's C7520 (a serialized wgmma) fails
   the build phase;
   the CIN backwards' device time by part
   (``torch.profiler``: B5's row and weight-gradient kernels per layer;
   B4's recompute, row kernel, weight gradients and collapsed layer),
   each beside its least work; the wrappers' host microseconds
   per launch (``rec_now_tpu_torch.profile_launch``); then time the
   table's dense and sparse update paths (the median of interleaved
   rounds), which sets ``auto``;
Phases 4-6 go through one table of runs, the port's paths: config 3
(xDeepFM: 26 x 100,000 x 16 table on the card, CIN (64, 64), deep
(256, 128), ``TrainerConfig(pairwise_weight=1.0,
click_occurance_power=-0.5)``) with the channel-summed CIN
(``cin_stack_sum``) and with ``cin_sum_channel=False`` (``cin_flat``),
config 4 (``MultiTaskModel()``, MMoE + PLE + STAR towers,
``TrainerConfig(pointwise_weight=1.0, listwise_weight=0.5,
num_tasks=2)``), then config 2 (``DCNv2Model()``, SENET + DCN-mix +
deep (256, 128), ``TrainerConfig(pointwise_weight=1.0,
pairwise_weight=0.5, click_occurance_power=-0.5,
sparse_optimizer="adam", sparse_lr=1e-3)``), then config 5
(``CANDCNModel()``: CAN over fields 0-7 with per-item parameters from a
second table of 100,000 x 272 rows looked up by field 8, beside SENET +
DCN-mix + deep (256, 128); ``TrainerConfig(pointwise_weight=1.0,
pairwise_weight=0.5, can_param_field=8, can_dnn_dims=(16,))``: two
lookups a request, two lookups, scatters and Adagrad passes a step), and
its first step once more under lazy Adam (two Adam passes; not served or
trained further).  Each run names its model,
trainer config, loss keys, the launches it expects per request and per
step, and its own kernel checks.  Every serving or training loop sets all
sixteen launch counts to 0 just before it and reads them just after, and
fails unless each is exact (0 for a kernel the run does not name): every
request and step looks its rows up once (B11), every step scatters their
gradients once (B12); the pooled lookup (``gather_pool_rows``) launches
only for the DLRM-DCNv2 requests of phase 4; a forward with no gradient
recorded (serving, eval) launches B8's wgmma kernel once for each
``DNNTower`` layer that ``wgmma_plan`` takes at its batch
(``tower_launches``), training steps never.

4. serve each run at full width through ``build_scorer`` and
   ``WireScorer`` (u8, f16): logits of the expected shape ((B,), or
   (2, B) for config 4), finite, wire against raw; then the model's own
   check (xDeepFM: the CIN layer on the run's own embeddings against its
   plain version, relative to that output's scale, failing if it could
   not see any one layer -- the table's +-1e-3 rows make the CIN terms
   too small to show in the logits; config 5: the CAN layer against a
   float64 evaluation, failing unless its products and its share of the
   logits are each visible), and the card against the same model and
   tables on the CPU through the plain versions; then DLRM-DCNv2 at
   MLPerf's widths on phase 3's pooled layout through ``build_scorer``
   at B = 8192: one ``gather_pool_rows`` launch and six B8 wgmma
   launches a request (the dense arch's last two layers, the over
   arch's four) and no other counted kernel, the logits against its
   forward on the plain pooled lookup with its towers on nn.Linear;
5. each run's first training step (B = 2048, full-width model and
   tables, its launches exact) on the card against the same step on the
   CPU: the losses, every gradient and every param after Adam, each
   table's touched rows and accumulators (under Adam: m, v and the
   count); then each kernel on that
   step's own tensors against its plain version, relative to that
   output's scale, failing unless each compared quantity is larger than
   its tolerance: the CIN backward's dx0 and dW of every layer, or the six
   multi-expert dense calls (each also with x off the 16-byte grid, and
   a shared input as one copy per expert); the ranking loss's dlogits
   (pair or
   listwise); each table's updated rows (and m, v); under Adam, the same
   step with ``sparse_update_mode="sparse"`` against the dense one;
6. train each run at full width (B = 8192): warm-up steps, then timed
   steps (host clock, each ending in ``torch.cuda.synchronize()``);
   every loss finite and > 0; the step is split into each kernel's time
   as phase 3 measured it (an estimate: ``profile_training`` gives the
   step's own device times);
7. the public ``pairwise_loss`` as an entry point at B = 8192 on the card
   against the CPU's blocked form (what B >= 4,096 takes there) and its
   dense (B, B) form, whose dlogits are autograd's (loss, pair count,
   dlogits): graded
   labels with two groups, a mask and power -0.5 (``pair_loss_sum``
   once: the general loss in one call, no ``pair_row_counts`` or
   ``same_group_matvec``), the same with the wrong-order filter, binary
   labels with one group and ``binary_labels=True`` (``pair_loss_sum``
   alone); then ``group_pair_counts_binary`` once, against
   ``pair_row_counts`` -> ``same_group_matvec`` (once each);
8. the training entry point as users start it: ``main`` of
   ``rec_now_tpu_torch.train`` (what ``python -m
   rec_now_tpu_torch.train`` runs), in this process, at full width on
   the flagship setting (``bench.py:38-57``: config 2, B = 8192,
   pairwise 0.5 at power -0.5, u8 dense wire, windows of 5 steps), 60
   steps: first the CLI's first window, its C++ pack against the numpy
   pack (byte-equal), the windowed loop against put + train_step on the
   same batches (losses 1e-4 relative: atomics add in another order);
   then the CLI's two loops, with their prefetch
   threads, on batches drawn beforehand, and the windowed loop on windows
   placed beforehand, in turns (the loops' own cost; ms per step whole
   and from the first batch's arrival), and a
   checkpoint restored equal; then ``main`` four times: with device eval
   and checkpoints every 20 steps, again with exact eval (device AUC
   within 1e-3 of exact, GAUC 2e-3), stepwise (``--scan-window 0``), and
   FM (config 1) for 10 steps; each run's launches exact (each step's,
   and one row gather for each eval batch), its losses finite and > 0 and
   its final eval's auc and gauc finite; the CLI's last checkpoint
   evaluated again gives the CLI's eval; ms per step and examples/s of
   the windowed and the stepwise loop through the CLI, which draws each
   synthetic batch as it runs;
9. the training entry point on a data file: a full-width Criteo TSV
   written by the port's ``write_synthetic_tsv`` (34 batches of 8,192:
   26 fields of 100,000 ids, 13 dense) and a 4-batch eval file; the
   native parser (``io/native/criteo_parser.cpp``, built by g++) against
   its plain version on the first 2,000 lines (ids, labels and groups
   exact, dense 1e-6 relative) and its time per 8,192 rows; on the
   file's first window, the C++ pack against the numpy pack, byte-equal,
   in both id modes (packed and hot8), with their times and bytes per
   example (``wire_cost`` and as packed); then ``main`` four times on the
   flagship setting from the file, device eval: with ``--eval-file`` and
   ``--wire-id-mode hot8``, the same with packed ids (the first window's
   losses within 1e-4 relative of the hot8 run's), the held-out eval
   (no ``eval_on_train``), and ``--steps`` past the file's end (the
   ``warning`` line, then ``eval_on_train`` on the final line); each
   run's launches exact, losses finite and > 0, final auc and gauc
   finite, and every window it packed decoded on the card to the host
   ids it was packed from; ms per step of the hot8 and packed runs
   beside phase 8's synthetic stream; the CLI's windowed loop in
   process, fed from the file (the parse and the pack on their own
   threads, as the CLI runs them) and on windows placed beforehand, in
   both id modes and with the parser on fewer threads, in turns; then
   the stale-table check: hot8 windows whose ids shift mid-stream
   through the prefetch thread, which relearns the table while windows
   packed with the first one wait in its queue, each decoding to its own
   ids;
10. the multi-process path (``--multihost``, ``Trainer(..., mesh=)``,
    the mod-sharded tables) in a NCCL group of one on the card, every
    collective it calls counted by wrapping ``torch.distributed``'s
    functions (NCCL may run a group of one without a kernel of its own,
    so kernel names prove nothing) and held to its count, each run's
    kernel launches exact: (b) configs 4 and 5 for 3 steps at B = 8192
    with a mesh, without, and without again: every metric of the mesh's
    within 1e-5 relative of the one-device run's; after step 1 its
    parameters bit-equal and its tables within ``SUM_TOL`` of their
    largest value (B12's atomics); after 3 steps its parameters and
    tables within 1e-3 of their largest value, printed beside the
    one-device run's own repeat (which spreads: B12 adds a hot row's
    terms in no fixed order); (d)
    the step of config 2 (the CLI's flagship trainer), 4 and 5 with a
    mesh and without, in turns, wall ms by the host clock (each step
    synchronized, and steps back to back) and busy ms by
    ``torch.profiler``; (a) ``main``
    with phase 8's run B flags and ``--multihost --sparse-route-mode
    routed --checkpoint-dir`` (a group of one resolves routed to
    allgather, as JAX does), its logged losses within 1e-5 relative of
    run B's (and the log's rounding to 5 decimals) and its final eval
    within 1e-5 relative; its last checkpoint, restored into a fresh
    state, bit-equal to the live state at that save; (e) the routed
    exchange's lookup and update bodies, called directly on config 2's
    table (2.6M x 16, dense Adagrad, then lazy Adam) and config 5's CAN
    table (100,000 x 272) with one B = 8192 batch's ids: at the default
    caps the rows bit-equal to the allgather lookup's with none dropped,
    one update on dyadic gradients (exact sums in any order) bit-equal to
    the allgather update's, and on random ones the summed gradients
    within ``SUM_TOL`` of their terms' summed |values|; at a cap factor
    of 0.1 the buckets and the overflow lane full, the card's plan equal
    to the CPU's from the same ids, the dropped count exact and the
    distinct ids that read zero exactly that many; a routed lookup 2
    ``all_to_all_single``, 1 ``all_gather_into_tensor`` and 1
    ``reduce_scatter_tensor``, a routed update 2 and 2
    ``all_to_all_single`` / ``all_gather_into_tensor``; each way's ms by
    events, device operations and busy ms a call, and the routed calls'
    largest kernels; the group is left at the end.  If NCCL cannot form the group, the phase fails;
11. the layer and loss library at B = 8,192: one ``SyntheticCriteo``
    batch, its 26 x 16 embeddings looked up through the table (B11), each
    module forward and backward on the card and on the CPU from one set
    of weights (outputs within 1e-4 of max(1, max|out|), gradients 1e-3
    of their scale, hashes bit-equal), each with its ms a call (events,
    forward + backward, median of 20) and its device operations a call:
    ``pairwise_loss_blocked`` (BPR, power -0.5, a mask) against the kernel
    path (B3's general entry; loss 1e-5 relative, dlogits 1e-4 of scale,
    the count exact), ``listwise_loss_blocked`` against B6 (each also
    against ``torch.utils.checkpoint`` a block in place of its hand-written
    backward: the same numbers, ms and peak memory), a weight
    function on graded labels with a custom tile-contract pair loss
    (the blocked route taken, counted) and ``listwise_loss`` at mask value
    -1e4, each blocked against the dense form on the card, with the peak
    device memory of each, forward + backward (fails unless blocked is
    lower); ``listwise_loss`` at threshold 0.3 (B6 once, with that
    threshold, against the CPU); the trainer's pairwise call (B3 once,
    the blocked form never);
    the focal loss; ``salted_hash`` / ``combine_hash`` on the batch's
    212,992 ids; ``CartesianProductLayer`` into ``FastMultiHashLayer``
    (2^21 x 16 rows), ``MultiHashLayer`` pooling the 26 fields; DCN (3
    layers) on the (B, 429) concat; the sparse GNN over a chain of the 26
    fields (2 layers, shared and not); STAR and stacked dense (units 32,
    two 2,080-wide nets by scene id), the parasitic stacked layer on 4
    domains; SENET's list path (13 fields of 16, 13 of 8); fix-length to
    64 and 32; dot-product and DNN attention over a (B, 50, 16) history
    with a mask;
12. slot features and the table's leftovers at B = 8,192 on the 2.6M x
    16 table: one ``SyntheticCriteo`` batch as (slot, id, weight)
    triples (the 26 fields as slots 0-25 of one global id each, a
    50-long history as slot 26, place j an id of field j % 26 drawn as
    the batch draws that field's, 0-20 multi-valued ids as slot 27
    padded with slot -1: 96 columns, 786,432 ids, weights U(0, 1));
    through ``EmbeddingTable.embedding_func`` (one B11 launch a call,
    counted), ``embedding_using_batch_segment_ids`` over the 27 field
    and history slots by sum and by mean, ``embedding_single_slot`` on
    the history (ncols 50) and the multi-valued slot (ncols 16, the
    longer rows cut off), ``pool_slots`` (mean, ``drop_duplicate_slot``)
    and ``fetch_single_slot``, each on the card against the CPU (outputs
    1e-4 of max(1, max|out|), integers exact); a loss's gradient with
    respect to the four lookups' rows (1e-3 of scale; nonnegative, so no
    sum cancels); then updates from that gradient with the padding
    masked: ``EmbeddingTable.apply_grads`` (B12 twice, no B9), the
    sharded table under Adagrad per occurrence (``dedup=False``, one B12)
    and deduped in both update modes, and under lazy Adam in both, each
    state's touched rows within ``SUM_TOL`` of each element's summed
    scale of the CPU's (B12's atomics), untouched rows unmoved, every
    launch count exact; ``export_table_rows`` (one B11); each call timed
    (events, median of 20) with its device operations and B11's share of
    its device time;
13. print one JSON line for the kernels, the card again, and finally
    ``{"ok": true, "device": {...}}``.

Without CUDA, or outside a checkout, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, TF32
# on the tensor cores (dense), HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# f32 kernel vs plain f32 einsum: the same products summed in another
# order over up to F * H = 1,664 terms per channel (and, for the weight
# gradients, over M = 131,072 rows in 1,024-row slices).
REL_TOL = 1e-4
# auto's dense/sparse limit is printed beside each run's crossing of the
# two timed paths, a measurement with no pass/fail line: the sparse path
# is ~30 launches whose time moves with the host, and over nine runs on
# the H100 it took 0.91-1.88 ms, its crossing with the dense path moving
# over 532-911 MiB (Adagrad) and 1,340-3,908 MiB (Adam).  Each path is
# read as the median of this many interleaved rounds
UPDATE_ROUNDS = 7
CIN_TPU = "rec_now_tpu/ops/pallas/cin_kernel.py"
PAIR_TPU = "rec_now_tpu/ops/pallas/pairwise_kernel.py"
TABLE_TPU = "rec_now_tpu/ops/pallas/table_update_kernel.py"
MD_TPU = "rec_now_tpu/ops/pallas/multi_dense_kernel.py"
LW_TPU = "rec_now_tpu/ops/pallas/listwise_kernel.py"
GATHER_TPU = "rec_now_tpu/ops/pallas/gather_kernel.py"
EXPAND_TPU = "rec_now_tpu/ops/pallas/expand_kernel.py"
# B12 against its plain version: atomics add a row's terms in no fixed
# order, so a sum differs by up to ~n eps of the terms' absolute sum (a
# hot row of a B = 8192 zipf batch takes ~2,000 adds)
SUM_TOL = 1e-6
# MLPerf's DLRM-DCNv2 on Criteo 1TB (TorchRec's examples/dlrm flags): each
# field's rows and multi-hot ids an example.  The pooled lookup is held
# to its plain version on these fields capped at POOL_ROW_CAP rows of
# POOL_DIM: 25.2M rows (12.9 GB), past 2^24 rows, so that row offsets
# pass 2^31 floats
DLRM_ROWS = (40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63,
             40000000, 3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14,
             40000000, 40000000, 40000000, 590152, 12973, 108, 36)
DLRM_HOTNESS = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1,
                12, 100, 27, 10, 3, 1, 1)
POOL_ROW_CAP = 1 << 22
POOL_DIM = 128
# phase 8: the flagship training setting (bench.py:38-57) through the CLI
CLI_FLAGSHIP = ["--model", "dcnv2", "--batch-size", "8192",
                "--pairwise-weight", "0.5", "--occurance-power", "-0.5",
                "--wire-dense-mode", "u8", "--scan-window", "5"]
CLI_COMMON = ["--steps", "60", "--log-every", "5", "--eval-batches", "8"]
# the FM run's steps and eval batches
FM_STEPS, FM_EVAL = 10, 4
# phase 9: the data file's batches (30 to train, 4 held out), and the lines
# the native parser is held to its plain version on
FILE_STEPS, FILE_EVAL = 30, 4
PARSE_CHECK_LINES = 2000
# parser threads of the extra file-fed loops (the default takes every core)
PARSE_THREADS = (4, 2)
# steps of each in-process loop timing (after the first window)
LOOP_STEPS = 30
# config 4's six multi-expert dense launches per forward at B = 8192:
# (name, inputs' leading dim, experts, D, U, ReLU, launches); then, at
# 0 launches per forward (checked and timed, not summed), the dispatch
# edges of csrc/multi_dense.cu at the same B: a shared input with N * U =
# 16 (the gate kernel) and 17 (the split-TF32 tile), and the gate bank's
# shape as a per-expert input (the tile)
MD_BANKS = (("MMoE experts layer 0", 1, 4, 429, 128, True, 1),
            ("MMoE experts layer 1", 4, 4, 128, 64, False, 1),
            ("MMoE gates", 1, 2, 429, 4, False, 1),
            ("PLE experts", 1, 2, 128, 64, False, 3),
            ("edge: shared, N*U = 16", 1, 4, 429, 4, False, 0),
            ("edge: shared, N*U = 17", 1, 1, 429, 17, False, 0),
            ("edge: per-expert, N*U = 8", 2, 2, 429, 4, False, 0))
# the main paths' DNNTower layers (what, in, out) at B = 8192, each one
# launch of B8's wgmma kernel (linear_wg) on nn.Linear's weights, bias and
# ReLU in its epilogue: DLRM-DCNv2's over arch (passes of 128 units), its
# dense arch's last two layers, the benchmark's xDeepFM 400 -> 400
# (passes of 200)
TOWER_LAYERS = (("DLRM-DCNv2 over arch", 3456, 1024),
                ("DLRM-DCNv2 over arch", 1024, 1024),
                ("DLRM-DCNv2 over arch", 1024, 512),
                ("DLRM-DCNv2 over arch", 512, 256),
                ("DLRM-DCNv2 dense arch", 512, 256),
                ("DLRM-DCNv2 dense arch", 256, 128),
                ("xDeepFM DNN", 400, 400))
# wgmma_plan's crossover: layers (in, out) timed on the wgmma kernel
# (forced) and on F.linear + ReLU at each batch
CROSSOVER = ((400, 400), (512, 256))
CROSSOVER_B = (1024, 2048, 4096, 8192)
# the stack forward's paths (csrc/cin.cu, stack_rows), each forced: rows a
# block, or layer-by-layer launches (config 3's stack takes the first)
STACK_PATHS = {128: "128-row blocks", 64: "64-row blocks",
               -1: "layer by layer"}
# pair_loss_sum's three launches a call at B <= 8,192, by part
B3_PARTS = {"sort_segments_kernel": "sort and segments",
            "segment_sweep": "sweep", "merge_segments": "merge"}
# the general loss's four launches a call at B <= 8,192 (one sort), by part
GENERAL_PARTS = {"sort_segments_kernel": "sort and segments",
                 "segment_sweep<true>": "count sweep",
                 "segment_sweep<false>": "loss sweep",
                 "merge_segments": "merge"}
# same_group_matvec's device operations a call (its hash), by part
B7B_PARTS = {"Memset": "zero", "hash_insert_kernel": "insert",
             "hash_read_kernel": "read"}
# launches that phase 3's "ms" of a kernel covers: one forward's
MS_COVERS = {"cin_flat": 2, "cin_flat_bwd": 2, "multi_dense": 6}
# config 5's CAN table (bench_all.py:132-135): rows_per_field rows of the
# CAN layer's 16 x 16 kernel and 16 biases, looked up by field 8
CAN_ROWS, CAN_DIM, CAN_FIELD = 100_000, 272, 8
# phase 10: the torch.distributed functions the multi-process path calls
# (counted by wrapping them: NCCL may run a group of one without a kernel
# of its own, so kernel names prove nothing), the steps each config runs
# with a mesh and without, and the steps of each timed round
COLLECTIVES = ("all_gather_into_tensor", "reduce_scatter_tensor",
               "all_reduce", "broadcast", "all_gather_object",
               "all_to_all_single")
# phase 10 (e): the collectives of one routed lookup and one routed update
# (embedding/sharded.py: the buckets' ids out and rows back, the overflow
# lane gathered and reduce-scattered; ids and gradients out, the lane's
# ids and gradients gathered), and the launches of each beside the
# allgather exchange's
ROUTED_LOOKUP = {"all_to_all_single": 2, "all_gather_into_tensor": 1,
                 "reduce_scatter_tensor": 1}
ROUTED_UPDATE = {"all_to_all_single": 2, "all_gather_into_tensor": 2}
AG_LOOKUP = {"all_gather_into_tensor": 1, "reduce_scatter_tensor": 1}
AG_UPDATE = {"all_gather_into_tensor": 2}
# the forced cap of (e): a tenth of the uniform share fills the buckets and
# the overflow lane of a B = 8192 batch's 212,992 ids and drops the rest
FORCED_CAP = 0.1
MESH_STEPS, MESH_TIMED = 3, 5
# a mesh run against the one-device run: its metrics; its parameters and
# tables after MESH_STEPS steps, over each one's largest value (the
# one-device run repeated moves config 5's by up to 2.28e-4 on the card:
# B12 adds a hot row's terms in no fixed order, and one sample of step 3
# is a near-tie that such a change flips)
MESH_TOL, STATE_TOL = 1e-5, 1e-3
# phase 11: a blocked loss against the kernel path, the dense form and the
# CPU (relative; dlogits 1e-4 of their scale); the history length, the
# scenes the STAR parameters are taken by, and the profiled calls a module
LIB_LOSS_TOL = 1e-5
LIB_HISTORY, LIB_SCENES, LIB_PROFILE_REPS = 50, 1000, 3
# phase 12: the history slot's length, the multi-valued slot's most ids a
# row and the columns it is padded to (rows past them are cut off), and
# the table updates' learning rate
SLOT_HISTORY, SLOT_MULTI, SLOT_MULTI_COLS = 50, 20, 16
UPDATE_LR = 0.05


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def losses_of(what: str, metrics: dict) -> dict:
    """A step's metrics as floats, less ``sparse_dropped``, which must be
    there and 0: one device and the allgather exchange drop no id."""
    vals = {k: float(v) for k, v in metrics.items()}
    if vals.pop("sparse_dropped", None) != 0.0:
        fail(f"{what}: sparse_dropped missing or not 0 in {metrics}")
    return vals


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device ms of ``fn()`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def profiled_ms(torch, fn, reps: int = 20) -> float:
    """Device ms of one ``fn()``: the kernels and copies it runs on the
    card, summed by ``torch.profiler`` over ``reps`` calls.  cuda_ms's
    events also time the host's launch path, which a kernel of a few
    microseconds does not hide."""
    return sum(profiled_by_name(torch, fn, reps).values())


def profiled_sequence(torch, fn, reps: int = 20) -> list:
    """(name, device ms) of each kernel or copy that ``reps`` calls of
    ``fn()`` run on the card, in the order they started
    (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the tracer can miss the kernels launched as it starts (a run
        # lost the first seven of a window): a spin kernel and a pause
        # come first, and the spin kernel and all before it are dropped
        torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        time.sleep(0.05)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)),
                    key=lambda e: e.time_range.start)
    spins = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
    events = events[spins[-1] + 1:] if spins else events
    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in events]


def kernel_name(name: str) -> str:
    """A profiler event's kernel name without its namespace and
    arguments."""
    m = re.search(r"::(\w+(?:<\w+>)?)\(", name)
    return m.group(1) if m else name[:40]


def profiled_by_name(torch, fn, reps: int = 20) -> dict:
    """Device ms of one ``fn()`` by the name of each kernel or copy it
    runs on the card (profiled_sequence summed by name)."""
    ms = {}
    for name, t in profiled_sequence(torch, fn, reps):
        ms[name] = ms.get(name, 0.0) + t / reps
    return ms


def cin_flops(m: int, f: int, h: int, k: int, prev_is_x0: bool) -> int:
    """Least FLOPs of one CIN layer out[m,k] = sum_{f,h} W[k,f,h] x0[m,f]
    prev[m,h]: the products x0[f] prev[h] once per row, then one
    multiply-add per (k, product) -- or W first, whichever is less.  When
    prev is x0 the products are symmetric, F(F+1)/2 per row."""
    terms = f * (f + 1) // 2 if prev_is_x0 else f * h
    return min(m * terms + 2 * m * k * terms, 2 * m * k * f * (h + 1))


def cin_flat_bwd_flops(m: int, f: int, h: int, k: int,
                       prev_is_x0: bool) -> int:
    """Least FLOPs of one CIN layer's backward for g (M, K): dW forms the
    products x0[f] prev[h] once per row (F(F+1)/2 when prev is x0) and
    does one multiply-add per (channel, product); A[f, h] = sum_k g[k]
    W[k, f, h] one multiply-add per (channel, f, h); then dx0 = sum_h A
    prev and dprev = sum_f A x0, one multiply-add per (f, h) each."""
    terms = f * (f + 1) // 2 if prev_is_x0 else f * h
    return m * terms + 2 * m * k * terms + 2 * m * k * f * h + 4 * m * f * h


def cin_stack_bwd_parts(m: int, f: int, ks) -> dict:
    """Least device ms of the stack's backward for g (M,), by the part of
    the kernel that does the work, each part's FLOPs at the peak rate of
    the unit that runs them.  On the tensor cores in split TF32 (three
    products per multiply-add): the non-last layers recomputed
    (cin_flops) and the collapsed last layer's two contractions,
    z = h_{n-1} Wc^T and dh_{n-1} = x0 Wc, at 2 M F H each.  In f32 FMAs:
    dWc = (g x0)^T h_{n-1} (2 M F H) and the g scalings (3 M F + M H);
    then each non-last layer's input gradients (the row kernel), g added
    to its hidden gradient (M K), and its weight gradient
    (cin_flat_bwd_flops split so).  Layer 1's prev is x0 and the stack
    returns dx0 alone, so its two input terms merge: dx0 = (A + A^T) x0
    with A = sum_k g W1 -- W1 + W1^T formed once per call (K F^2), A on
    the F(F+1)/2 symmetric pairs, then one multiply-add per (f, h); dW1 on
    the symmetric products."""
    def tc(flops):
        return bound_ms(3 * flops, 0, PEAK_TF32_FLOPS)[0]

    def fma(flops):
        return bound_ms(flops, 0)[0]

    hs = [f] + list(ks[:-1])
    mid = range(len(ks) - 1)
    sym = f * (f + 1) // 2
    rows = dw = 0
    for i in mid:
        k, h = ks[i], hs[i]
        if i:
            rows += 2 * m * k * f * h + 4 * m * f * h + m * k
            dw += m * f * h + 2 * m * k * f * h
        else:
            rows += k * f * f + 2 * m * k * sym + 2 * m * f * f + m * k
            dw += m * sym + 2 * m * k * sym
    return {"recompute": tc(sum(cin_flops(m, f, hs[i], ks[i], i == 0)
                                for i in mid)),
            "rows": fma(rows), "dw": fma(dw),
            "collapsed": tc(4 * m * f * hs[-1])
            + fma(2 * m * f * hs[-1] + 3 * m * f + m * hs[-1])}


def cin_stack_fwd_parts(m: int, f: int, ks) -> dict:
    """Least device ms of the stack forward by the unit that runs each
    part: the non-last layers on the tensor cores in split TF32 (three
    products a multiply-add; layer 1 on its F(F+1)/2 symmetric products,
    cin_flops); in f32 FMAs the collapsed last layer, z = sum_f x0[f]
    sum_h Wc[f,h] h_{n-1}[h] (2 M F (H + 1)), and the sums (M (F + sum K
    + 1))."""
    hs = [f] + list(ks[:-1])
    tc = sum(cin_flops(m, f, hs[i], ks[i], i == 0)
             for i in range(len(ks) - 1))
    f32 = 2 * m * f * (hs[-1] + 1) + m * (f + sum(ks[:-1]) + 1)
    return {"layers": bound_ms(3 * tc, 0, PEAK_TF32_FLOPS)[0],
            "collapse": bound_ms(f32, 0)[0]}


def kernel_split(seq, calls: int, parts: dict, what: str) -> dict:
    """Device ms of ``what``'s launches over ``calls`` calls by part, from
    the kernels they ran (profiled_sequence): ``parts`` maps a kernel's
    name to its part, each launched once a call.  Any other kernel, or
    another count, fails."""
    out = dict.fromkeys(parts.values(), 0.0)
    seen = dict.fromkeys(parts.values(), 0)
    for name, ms in seq:
        part = [p for n, p in parts.items() if n in name]
        if len(part) != 1:
            fail(f"{what} ran an unexpected kernel: {name}")
        out[part[0]] += ms
        seen[part[0]] += 1
    if seen != dict.fromkeys(parts.values(), calls):
        fail(f"{what} launched {seen} in {calls} calls")
    return out


def b4_split(seq, n_mid: int, calls: int) -> dict:
    """Device ms of cin_stack_sum_bwd's parts from the kernels of
    ``calls`` calls in the order they ran (profiled_sequence).  A call
    launches, by name: collapse_kernel once; cin_layer_mma_kernel n_mid
    times for the recompute, then twice for the collapsed layer (the
    shapes here fit one launch a layer); cin_wgrad_kernel n_mid + 1
    times, dWc first, each followed by the reduce_kernel of its partial
    sums; cin_bwd_rows_kernel n_mid times.  Any other kernel, or another
    count, fails."""
    out = dict(recompute=0.0, rows=0.0, dw=0.0, collapsed=0.0)
    per_call = {"collapse_kernel": 1, "cin_layer_mma_kernel": n_mid + 2,
                "cin_wgrad_kernel": n_mid + 1, "reduce_kernel": n_mid + 1,
                "cin_bwd_rows_kernel": n_mid}
    seen = dict.fromkeys(per_call, 0)
    layers = grads = 0
    part = "collapsed"
    for name, ms in seq:
        kind = [k for k in per_call if k in name]
        if len(kind) != 1:
            fail(f"cin_stack_sum_bwd ran an unexpected kernel: {name}")
        kind = kind[0]
        seen[kind] += 1
        if kind == "collapse_kernel":
            layers = grads = 0
            part = "collapsed"
        elif kind == "cin_layer_mma_kernel":
            part = "recompute" if layers < n_mid else "collapsed"
            layers += 1
        elif kind == "cin_wgrad_kernel":
            part = "dw" if grads else "collapsed"
            grads += 1
        elif kind == "cin_bwd_rows_kernel":
            part = "rows"
        out[part] += ms        # reduce_kernel: with its weight gradient
    want = {k: calls * n for k, n in per_call.items()}
    if seen != want:
        fail(f"cin_stack_sum_bwd launched {seen} in {calls} calls, "
             f"expected {want}")
    return out


def sort_ops(b: int, keys: int = 1) -> float:
    """Compares of a sort of b samples on ``keys`` keys: the least work
    that brings each group (or each (group, label) run) together, where
    the kernels test every (i, j) instead."""
    return keys * b * math.log2(max(b, 2))


def pair_ops(labels, groups) -> int:
    """Least operations of the fused pair loss on this batch: a sort by
    group, one pass over each group for the occurrence weight (pos and
    tot adds, pos * (tot - pos), its power, the row's weight: 5 a sample),
    and per valid pair the gap, softplus (exp, log1p, max, add), sigmoid
    (exp, add, divide) and four weighted sums: 12."""
    import numpy as np
    _, inv = np.unique(groups, return_inverse=True)
    tot = np.bincount(inv)
    pos = np.bincount(inv, weights=labels)
    b = len(labels)
    return int(sort_ops(b) + 5 * b + 12 * (pos * (tot - pos)).sum())


def multi_dense_work(nx: int, n: int, b: int, d: int, u: int):
    """(FLOPs, bytes) of one multi-expert dense launch: a multiply-add per
    (expert, row, d, unit), the bias add; x read once (a shared input
    once for all experts), W and bias read, the output written."""
    return (2 * n * b * d * u + n * b * u,
            (nx * b * d + n * d * u + n * u + n * b * u) * 4)


def listwise_ops(labels) -> int:
    """Least operations of the fused listwise loss on this batch: a sort
    by group; per sample, once in its group's softmax, the running max's
    compare, the exp, the exp-sum add, the label-sum add, the label *
    logit multiply-add and the two flag tests (7), its share of its
    group's log and loss (at most 1), and its gradient (the softmax's exp
    and divide, p's divide, the subtract: 4): 12."""
    b = len(labels)
    return int(sort_ops(b) + 12 * b)


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def compare(name: str, got, want, floor: float = 1.0,
            rel: float = REL_TOL) -> float:
    """Max |got - want|; fails above rel * max(floor, max|want|)."""
    err = float((got - want).abs().max()) if want.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    ok = got.shape == want.shape and err <= rel * max(scale, floor)
    print(f"  {name}: shape {tuple(got.shape)} max_abs_err {err:.3e} "
          f"max|plain| {scale:.3e} max_rel_err {err / max(scale, 1e-30):.3e}"
          f" (tol {rel:g} of max({floor:g}, max|plain|)) -> "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def compare_all(name: str, got, want) -> float:
    """compare() each output of a multi-output kernel at its own scale."""
    return max(compare(f"{name} [{i}]", a, b, floor=0.0)
               for i, (a, b) in enumerate(zip(got, want)))


def visible(name: str, part, scale: float, rel: float = REL_TOL) -> None:
    """Fail unless ``part`` moves the compared output by more than the
    tolerance (rel * scale), so that a kernel which got it wrong would be
    caught."""
    tol = rel * scale
    seen = float(part.abs().max())
    print(f"    {name}: max {seen:.3e} = {seen / max(tol, 1e-30):.1f} x tol")
    if seen <= tol:
        fail(f"the check cannot see {name}")


def compare_sum(name: str, got, want, scale: float,
                rel: float = SUM_TOL) -> float:
    """Max |got - want| of a scatter-add; fails above rel * scale, where
    scale is the largest |start| + sum |vals| an element adds up."""
    err = float((got - want).abs().max()) if want.numel() else 0.0
    ok = got.shape == want.shape and err <= rel * scale
    print(f"  {name}: shape {tuple(got.shape)} max_abs_err {err:.3e} "
          f"summed scale {scale:.3e} rel {err / max(scale, 1e-30):.3e} "
          f"(tol {rel:g}) -> {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def misaligned(t):
    """A copy of ``t`` whose storage starts 4 bytes off the 16-byte grid:
    the kernels' 4-byte paths."""
    import torch
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return out.view(t.shape).copy_(t)


def check_gather_scatter(torch, kern, rand, ids8k, grads8k, vfull, gk, ek,
                         table_cls, dev, card) -> None:
    """B11 bit-exact and B12 within SUM_TOL of each output's summed scale
    against their plain versions, on the full-width table with a B = 8192
    batch's ids (the dense buffer, the sparse path's dedup and its
    sentinel-heavy write-backs), ragged, empty and out-of-range ids; then
    kernel, plain version and the library call timed."""
    from rec_now_tpu_torch.embedding.table import dedup_rows
    n = ids8k.numel()
    tfull = rand(vfull, 16, scale=1e-3)
    sparse = table_cls(vfull, 16, device=dev, update_mode="sparse")
    rep, _, valid = dedup_rows(ids8k, grads8k, sparse.local_rows)
    order = torch.argsort(ids8k, stable=True)
    sid = ids8k[order]
    seg = torch.cumsum(torch.cat([torch.ones(1, dtype=torch.bool,
                                             device=dev),
                                  sid[1:] != sid[:-1]]), 0) - 1
    distinct = int(valid.sum())
    print(f"  a B=8192 batch: {n} ids, {distinct} distinct rows, "
          f"{n - distinct} sentinel segments (row V, dropped by B12)")
    wild = torch.tensor([-5, -1, 0, vfull - 1, vfull, vfull + 100, 2 ** 40],
                        device=dev)
    small = rand(777, 5)
    print("gather_rows vs plain (bit-exact):")
    g_cases = (("B=8192 batch", tfull, ids8k),
               ("ragged N=1500 int32", tfull, ids8k[:1500].int()),
               ("ids out of range (clamped)", tfull, wild),
               ("the sparse path's rows with sentinels", tfull, rep),
               ("D=5 scalar loop", small, ids8k[:333] % 800),
               ("B=8192 batch (B, F) shape", tfull, ids8k.reshape(-1, 26)))
    for what, table, ids in g_cases:
        got = gk.gather_rows(table, ids)
        want = gk.gather_rows_plain(table, ids)
        ok = got.shape == want.shape and torch.equal(got, want)
        # exact: the check sees any row that is not all zeros
        seen = float(got.abs().max())
        print(f"  {what}: shape {tuple(got.shape)} "
              f"{'equal' if ok else 'MISMATCH'}, max|row| {seen:.3e}")
        if not ok:
            fail(f"gather_rows {what} differs from its plain version")
        if not seen > 0:
            fail(f"the check cannot see gather_rows {what}")
    before = gk.gather_rows.launches
    if gk.gather_rows(tfull, ids8k[:0]).shape != (0, 16) or \
            gk.gather_rows.launches != before:
        fail("gather_rows of no ids launched or gave a wrong shape")
    # bytes this batch needs: its distinct rows read once, the (N, D)
    # rows written, the ids read; no arithmetic
    b_ms, b_by = bound_ms(0, distinct * 64 + n * 64 + n * 8)
    kern["gather_rows"] = dict(
        name="gather_rows", route="cuda",
        source="rec_now_tpu_torch/csrc/gather.cu",
        replaces=f"{GATHER_TPU}:136", max_abs_err=0.0,
        ms=cuda_ms(torch, lambda: gk.gather_rows(tfull, ids8k)),
        plain_ms=cuda_ms(torch, lambda: gk.gather_rows_plain(tfull, ids8k)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(torch, lambda: torch.index_select(tfull, 0,
                                                             ids8k)))

    print(f"scatter_add_rows vs plain (tol {SUM_TOL:g} of each output's "
          f"summed scale):")
    vals = rand(n, 16, scale=1e-3)
    s_cases = (("dense buffer, B=8192 batch", torch.zeros_like(tfull), ids8k,
                grads8k),
               ("dedup segment sum", torch.zeros_like(grads8k), seg,
                grads8k[order]),
               ("sparse write-back with sentinels", tfull, rep,
                vals * valid),
               ("ragged N=1500 int32", tfull, ids8k[:1500].int(),
                vals[:1500]),
               ("ids out of range (dropped)", tfull, wild, vals[:7] + 1.0),
               ("D=5", small, ids8k[:333] % 800, rand(333, 5)),
               ("vals off the 16-byte grid (scalar loop), B=8192 batch",
                torch.zeros_like(tfull), ids8k, misaligned(grads8k)))
    err = 0.0
    for what, start, ids, v in s_cases:
        got, want = start.clone(), start.clone()
        ek.scatter_add_rows(got, ids, v)
        ek.scatter_add_rows_plain(want, ids, v)
        keep = (ids >= 0) & (ids < start.shape[0])
        scale = start.abs().index_add_(0, ids[keep], v[keep].abs())
        scale = float(scale.max())
        err = max(err, compare_sum(what, got, want, scale))
        visible(f"{what}: the added rows", want - start, scale, rel=SUM_TOL)
    before = ek.scatter_add_rows.launches
    ek.scatter_add_rows(tfull, ids8k[:0], vals[:0])
    if ek.scatter_add_rows.launches != before:
        fail("scatter_add_rows of no ids launched")
    buf = torch.zeros_like(tfull)
    b_ms, b_by = bound_ms(n * 16, n * 64 + n * 8 + 2 * distinct * 64)
    kern["scatter_add_rows"] = dict(
        name="scatter_add_rows", route="cuda",
        source="rec_now_tpu_torch/csrc/gather.cu",
        replaces=f"{EXPAND_TPU}:64", max_abs_err=err,
        ms=cuda_ms(torch, lambda: ek.scatter_add_rows(buf, ids8k, grads8k)),
        plain_ms=cuda_ms(torch, lambda: ek.scatter_add_rows_plain(
            buf, ids8k, grads8k)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(torch, lambda: buf.index_add_(0, ids8k,
                                                         grads8k)))
    # the sparse path's write-back: sentinels dropped by B12, against the
    # library call sending them to row V - 1 as zeros
    wb = vals * valid
    clamped = rep.clamp_max(vfull - 1)
    sent_ms = cuda_ms(torch, lambda: ek.scatter_add_rows(buf, rep, wb))
    sent_lib = cuda_ms(torch, lambda: buf.index_add_(0, clamped, wb))
    print(f"  sparse write-back, {n - distinct} sentinels: B12 {sent_ms:.4f}"
          f" ms (dropped), index_add_ {sent_lib:.4f} ms (to row V - 1) "
          f"[{card}]")
    # the same calls' device time alone (the first profiled window of a
    # process pays the tracer's start-up: one is run and dropped)
    profiled_ms(torch, lambda: gk.gather_rows(tfull, ids8k), reps=2)
    dev_ms = {
        "gather_rows": profiled_ms(torch, lambda: gk.gather_rows(tfull,
                                                                 ids8k)),
        "index_select": profiled_ms(torch, lambda: torch.index_select(
            tfull, 0, ids8k)),
        "scatter_add_rows": profiled_ms(
            torch, lambda: ek.scatter_add_rows(buf, ids8k, grads8k)),
        "index_add_": profiled_ms(torch, lambda: buf.index_add_(
            0, ids8k, grads8k)),
        "scatter_add_rows, sentinels": profiled_ms(
            torch, lambda: ek.scatter_add_rows(buf, rep, wb)),
        "index_add_, sentinels to row V - 1": profiled_ms(
            torch, lambda: buf.index_add_(0, clamped, wb))}
    print("  device time by torch.profiler, B=8192 batch: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in dev_ms.items()) + f" [{card}]")
    # the wrappers' host path (B8, B11, B12 and their library calls; B5)
    from rec_now_tpu_torch.profile_launch import wrapper_host_us
    print("host path, us per call at a tiny size, the median of 5 rounds "
          "of 2,000 (rec_now_tpu_torch.profile_launch): " + ", ".join(
              f"{k} {v:.3f}" for k, v in wrapper_host_us().items())
          + f" [{card}]")


def pooled_layout(torch, dev):
    """The multi-hot layout the pooled lookup is checked and served on
    (DLRM_ROWS capped at POOL_ROW_CAP, DLRM_HOTNESS, POOL_DIM wide) and
    its table on the card, U(-0.5, 0.5) from a seed."""
    from rec_now_tpu_torch.models import FeatureConfig
    fc = FeatureConfig(num_dense=13, num_sparse=len(DLRM_ROWS),
                       embedding_dim=POOL_DIM,
                       field_rows=tuple(min(r, POOL_ROW_CAP)
                                        for r in DLRM_ROWS),
                       hotness=DLRM_HOTNESS)
    gen = torch.Generator(device=dev).manual_seed(25)
    table = torch.rand(fc.total_rows, POOL_DIM, generator=gen, device=dev)
    return fc, table.sub_(0.5)


def pooled_requests(np, fc, b: int, n: int, seed: int) -> list:
    """``n`` requests of ``b`` examples: dense floats log(1 + Exp(8)) and
    raw ids uniform over [0, 2^31), (B, sum(hotness)) int32, as numpy
    arrays."""
    rng = np.random.default_rng(seed)
    return [(np.log1p(rng.exponential(8.0, (b, fc.num_dense))
                      ).astype(np.float32),
             rng.integers(0, 2 ** 31 - 1, (b, sum(fc.hotness)),
                          dtype=np.int32)) for _ in range(n)]


def check_gather_pool(torch, np, kern, gk, dev, card) -> None:
    """The pooled lookup bit-exact against its plain version (the same
    adds in the same order) on the DLRM layout at B = 8192, int64 and
    int32 ids, ragged, out-of-range ids, a table 4 bytes off the 16-byte
    grid and D = 5 (the scalar loop); no example launches nothing; then
    kernel, plain version and ``F.embedding_bag`` timed beside the bound
    of this batch's bytes."""
    fc, table = pooled_layout(torch, dev)
    hot, v = fc.hotness, table.shape[0]
    _, raw = pooled_requests(np, fc, 8192, 1, 7)[0]
    ids = fc.global_ids(torch.from_numpy(raw).to(dev))
    b, cols = ids.shape
    n = ids.numel()
    distinct = int(torch.unique(ids).numel())
    far = int(ids.max()) * POOL_DIM
    print(f"gather_pool_rows vs plain (bit-exact): table {tuple(table.shape)}"
          f" ({table.numel() * 4 / 1e9:.1f} GB), B={b}, {cols} ids an "
          f"example, {distinct} distinct rows of {n}, the farthest starting "
          f"at float {far}")
    if far < 2 ** 31:
        fail("the pooled lookup's check reads no row past 2^31 floats")
    wild = ids[:4].clone()
    wild[0, :4] = torch.tensor([-5, -1, v, 2 ** 40], device=dev)
    # the table's floats from the second on, as (V - 1, D) rows: off grid
    off = table.view(-1)[1:1 + (v - 1) * POOL_DIM].view(v - 1, POOL_DIM)
    small = torch.randn(777, 5, device=dev)
    cases = (("B=8192, int64 ids", table, ids),
             ("B=8192, int32 ids", table, ids.int()),
             ("ragged B=1500", table, ids[:1500]),
             ("ids out of range (clamped)", table, wild),
             ("table off the 16-byte grid (scalar loop), B=8192", off, ids),
             ("D=5 (scalar loop)", small, ids[:333] % 800))
    for what, t, i in cases:
        before = gk.gather_pool_rows.launches
        got = gk.gather_pool_rows(t, i, hot)
        launched = gk.gather_pool_rows.launches - before
        want = gk.gather_pool_rows_plain(t, i, hot)
        ok = got.shape == want.shape and torch.equal(got, want)
        seen = float(got.abs().max())
        print(f"  {what}: shape {tuple(got.shape)} "
              f"{'equal' if ok else 'MISMATCH'}, max|pooled| {seen:.3e}, "
              f"{launched} launch")
        if not ok:
            fail(f"gather_pool_rows {what} differs from its plain version")
        if not seen > 0 or launched != 1:
            fail(f"gather_pool_rows {what}: nothing seen or not one launch")
        del got, want
    before = gk.gather_pool_rows.launches
    if gk.gather_pool_rows(table, ids[:0], hot).shape != (0, len(hot),
                                                          POOL_DIM) or \
            gk.gather_pool_rows.launches != before:
        fail("gather_pool_rows of no example launched or gave a wrong shape")
    # bytes this batch needs: its distinct rows read once, the (B, F, D)
    # pooled rows written, the int64 ids read; its adds are never the bound
    b_ms, b_by = bound_ms(0, distinct * POOL_DIM * 4
                          + b * len(hot) * POOL_DIM * 4 + n * 8)
    starts = [sum(hot[:f]) for f in range(len(hot))]
    offsets = (torch.arange(b, device=dev)[:, None] * cols
               + torch.tensor(starts, device=dev)).reshape(-1)
    flat = ids.reshape(-1)

    def library():
        return torch.nn.functional.embedding_bag(flat, table, offsets,
                                                 mode="sum")

    same = torch.equal(library().view(b, len(hot), POOL_DIM),
                       gk.gather_pool_rows(table, ids, hot))
    kern["gather_pool_rows"] = dict(
        name="gather_pool_rows", route="cuda",
        source="rec_now_tpu_torch/csrc/gather.cu",
        replaces="none: the JAX package has one id a field",
        max_abs_err=0.0,
        ms=cuda_ms(torch, lambda: gk.gather_pool_rows(table, ids, hot)),
        plain_ms=cuda_ms(torch, lambda: gk.gather_pool_rows_plain(
            table, ids, hot)),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(torch, library))
    profiled_ms(torch, library, reps=2)
    dev_ms = profiled_ms(torch, lambda: gk.gather_pool_rows(table, ids, hot))
    lib_dev = profiled_ms(torch, library)
    k = kern["gather_pool_rows"]
    print(f"  B=8192: kernel {k['ms']:.4f} ms ({b_ms / k['ms']:.1%} of its "
          f"bound {b_ms:.4f} ms, {b_by}), device {dev_ms:.4f} "
          f"({b_ms / dev_ms:.1%}); plain {k['plain_ms']:.4f}; "
          f"F.embedding_bag (sum) {k['library_ms']:.4f}, device "
          f"{lib_dev:.4f}, {'bit-equal to' if same else 'other bits than'}"
          f" the kernel [{card}]")
    del table, off
    torch.cuda.empty_cache()


def tower_rows(torch, mk, rand, b: int, card: str) -> dict:
    """B8's wgmma kernel (``linear_wg``) at the main paths' tower layers
    (TOWER_LAYERS) at batch ``b``: each taken by wgmma_plan, one launch
    counted in ``multi_dense.wgmma``, within 2e-6 of the largest output
    from float64, timed by events and on the device beside its bound
    (three TF32 products a multiply-add at 495 TFLOP/s), the plain version
    and F.linear + ReLU in float32 (TF32 off); then wgmma_plan's crossover
    (CROSSOVER at CROSSOVER_B), device ms both ways beside the plan's
    choice.  -> the kernel's row of the ``kernels`` line, summed over the
    layers."""
    from rec_now_tpu_torch.core import profiling
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: the library's time would not be float32's")

    def wgmma_count():
        return profiling.span_report()["counters"].get("multi_dense.wgmma",
                                                       0)

    print(f"linear_wg (B8's wgmma kernel) at the tower layers, B={b}:")
    tot = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0,
               bound_ms=0.0, err=0.0, rel=0.0, bound_by=set())
    over = dict(ms=0.0, device_ms=0.0, library_ms=0.0, bound_ms=0.0)
    for what, d, u in TOWER_LAYERS:
        x, w, bias = rand(b, d), rand(u, d, scale=d ** -0.5), rand(u)
        if not mk.wgmma_plan(b, d, u, x.data_ptr() % 16 == 0):
            fail(f"{what} {d} -> {u}: wgmma_plan refuses it at B={b}")
        before, launches = wgmma_count(), mk.linear_wg.launches
        got = mk.linear_wg(x, w, bias, True)
        if (got is None or wgmma_count() != before + 1
                or mk.linear_wg.launches != launches + 1):
            fail(f"{what} {d} -> {u}: not one wgmma launch")
        want = torch.relu(x.double() @ w.double().t() + bias.double())
        err = float((got.double() - want).abs().max())
        rel = err / float(want.abs().max())
        ms = cuda_ms(torch, lambda: mk.linear_wg(x, w, bias, True))
        dms = profiled_ms(torch, lambda: mk.linear_wg(x, w, bias, True))
        pms = cuda_ms(torch, lambda: mk.multi_dense_xla(
            x[None], w.t()[None], bias[None, None], "relu"))
        lms = cuda_ms(torch, lambda: torch.relu(
            torch.nn.functional.linear(x, w, bias)))
        ldms = profiled_ms(torch, lambda: torch.relu(
            torch.nn.functional.linear(x, w, bias)))
        fl, nb = multi_dense_work(1, 1, b, d, u)
        b_ms, b_by = bound_ms(3 * fl, nb, PEAK_TF32_FLOPS)
        print(f"  {what} {d} -> {u}: kernel {ms:.4f} ms (device "
              f"{dms:.4f}), plain {pms:.4f} ms, F.linear + ReLU {lms:.4f} "
              f"ms (device {ldms:.4f}); bound {b_ms:.4f} ms "
              f"({'ops, split TF32' if b_by == 'operations' else b_by}) "
              f"= {b_ms / dms:.1%} of the kernel's device time; "
              f"max|kernel - f64| / max|f64| {rel:.2e} [{card}]")
        if rel > 2e-6:
            fail(f"{what} {d} -> {u}: {rel:.2e} of max|f64| off")
        if b_ms > dms:
            fail(f"{what} {d} -> {u} ran under its bound")
        for key, v in (("ms", ms), ("device_ms", dms), ("plain_ms", pms),
                       ("library_ms", lms), ("bound_ms", b_ms)):
            tot[key] += v
        if what.endswith("over arch"):
            for key, v in (("ms", ms), ("device_ms", dms),
                           ("library_ms", ldms), ("bound_ms", b_ms)):
                over[key] += v
        tot["err"], tot["rel"] = max(tot["err"], err), max(tot["rel"], rel)
        tot["bound_by"].add(b_by)
    print(f"  the over arch's four layers: kernel {over['ms']:.4f} ms by "
          f"events, device {over['device_ms']:.4f}, F.linear + ReLU device "
          f"{over['library_ms']:.4f}; bound {over['bound_ms']:.4f} ms = "
          f"{over['bound_ms'] / over['device_ms']:.1%} of the device time "
          f"[{card}]")
    print(f"  all {len(TOWER_LAYERS)} layers: kernel {tot['ms']:.4f} ms, "
          f"device {tot['device_ms']:.4f}, F.linear + ReLU "
          f"{tot['library_ms']:.4f}; bound {tot['bound_ms']:.4f} ms = "
          f"{tot['bound_ms'] / tot['device_ms']:.1%} of the device time; "
          f"max rel err {tot['rel']:.2e} [{card}]")
    print("wgmma_plan's crossover, device ms (torch.profiler) and by "
          "events, wgmma kernel / F.linear + ReLU:")
    for d, u in CROSSOVER:
        w, bias = rand(u, d, scale=d ** -0.5), rand(u)
        for bb in CROSSOVER_B:
            x = rand(bb, d)
            kern_ = (lambda: mk._linear_wg(x, w, bias, True))
            lib_ = (lambda: torch.relu(
                torch.nn.functional.linear(x, w, bias)))
            kd, ld = profiled_ms(torch, kern_), profiled_ms(torch, lib_)
            ke, le = cuda_ms(torch, kern_), cuda_ms(torch, lib_)
            taken = mk.wgmma_plan(bb, d, u, True)
            print(f"  {d} -> {u}, B={bb}: device {kd:.4f} / {ld:.4f}, "
                  f"events {ke:.4f} / {le:.4f}; the plan takes "
                  f"{'the wgmma kernel' if taken else 'F.linear + ReLU'}"
                  f"{'' if (kd <= ld) == taken else ', the slower'} "
                  f"[{card}]")
    return tot


def tower_launches(model, b: int) -> int:
    """B8 launches of ``model``'s forward at batch ``b`` with no gradient
    recorded: one for each DNNTower layer that wgmma_plan takes (each
    layer's input is a fresh tensor, on the 16-byte grid)."""
    from rec_now_tpu_torch.models.tower import DNNTower
    from rec_now_tpu_torch.ops import multi_dense_kernel as mk
    return sum(mk.wgmma_plan(b, layer.in_features, layer.out_features,
                             True)
               for tower in model.modules() if isinstance(tower, DNNTower)
               for layer in tower.children())


def dcn_eval_launches(b: int = 8192) -> dict:
    """Launches of one eval batch of the CLI's config 2 (DCNv2Model at the
    CLI's default widths): its row gather, its tower's wgmma layers."""
    from rec_now_tpu_torch.models import DCNv2Model, FeatureConfig
    return {"gather_rows": 1, "linear_wg": tower_launches(
        DCNv2Model(FeatureConfig(), device="cpu"), b)}


def serve_pooled(torch, np, counted, dev, card) -> None:
    """DLRM-DCNv2 at MLPerf's widths on the DLRM layout through
    ``build_scorer``: every request one ``gather_pool_rows`` launch, one
    B8 wgmma launch for each tower layer the plan takes, and no other
    counted kernel; logits (B,) finite and equal to the model's forward
    on the plain pooled lookup with a gradient recorded (its towers on
    nn.Linear)."""
    from rec_now_tpu_torch.embedding.table import EmbeddingTable
    from rec_now_tpu_torch.models import DLRMDCNv2Model
    from rec_now_tpu_torch.ops import gather_kernel as gk
    from rec_now_tpu_torch.serving import ServingState, build_scorer
    fc, table_t = pooled_layout(torch, dev)
    model = DLRMDCNv2Model(fc, device=dev)
    state = ServingState(dict(model.named_parameters()), table_t)
    score = build_scorer(model, fc, EmbeddingTable(fc.total_rows, POOL_DIM,
                                                   device=dev), device=dev)
    reqs = pooled_requests(np, fc, 8192, 4, 8)
    score(state, *reqs[0])                          # warm-up, not counted
    torch.cuda.synchronize()

    def requests():
        times, outs = [], []
        for dense, raw in reqs:
            t0 = time.perf_counter()
            outs.append(score(state, dense, raw))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return times, outs

    towers = tower_launches(model, 8192)
    times, outs = counted(f"serve DLRM-DCNv2 (B=8192, {sum(fc.hotness)} "
                          f"ids an example), {len(reqs)} requests",
                          len(reqs), {"gather_pool_rows": 1,
                                      "linear_wg": towers}, requests)
    print(f"  {towers} B8 wgmma launches a request (the towers' layers "
          f"that wgmma_plan takes)")
    for (dense, raw), out in zip(reqs[:2], outs[:2]):
        if tuple(out.shape) != (8192,) or not torch.isfinite(out).all():
            fail(f"DLRM-DCNv2: bad logits {tuple(out.shape)}")
        with torch.no_grad():
            pooled = gk.gather_pool_rows_plain(
                table_t, fc.global_ids(torch.from_numpy(raw).to(dev)),
                fc.hotness)
        want = model(torch.from_numpy(dense).to(dev), pooled)
        if not want.requires_grad:
            fail("DLRM-DCNv2's reference forward recorded no gradient")
        compare("DLRM-DCNv2 served vs its forward on the plain pooled "
                "lookup and nn.Linear towers", out, want.detach(),
                floor=0.0)
    ms = statistics.median(times)
    print(f"  {ms:.3f} ms/request (median of {len(times)}), "
          f"{8192 / ms * 1e3:.0f} examples/s at B=8192, requests in "
          f"pageable memory [{card}]")
    del state, table_t, model
    torch.cuda.empty_cache()


def check_wide_tables(torch, rand, gen, batch, tk, gk, ek, dev,
                      card) -> None:
    """B9-B12 at widths of a warp a row: config 5's CAN table (CAN_ROWS x
    CAN_DIM) with the CAN ids of a B = 8192 batch (its field CAN_FIELD),
    and ragged tables of D = 45 (float lanes) and 72 (float4s).  Each
    kernel against its plain version (B9 within 1e-6 of each output's
    scale, B10 within REL_TOL, B11 exact, B12 within SUM_TOL of the
    summed scale) and repeated bit for bit (B12's atomics excepted); then
    timed at the CAN table's shapes by events and on the device
    (torch.profiler) beside its bound, the plain version and the library
    call where one exists."""
    ids = torch.as_tensor(batch.sparse_ids[:, CAN_FIELD] % CAN_ROWS,
                          device=dev).long()
    n, distinct = ids.numel(), int(torch.unique(ids).numel())
    print(f"the CAN table, {CAN_ROWS} x {CAN_DIM} "
          f"({CAN_ROWS * CAN_DIM * 4 / 1e6:.1f} MB): a B=8192 batch's "
          f"{n} CAN ids touch {distinct} rows")

    def timed(what, fn, plain, nflops, nbytes, library=None):
        b_ms, b_by = bound_ms(nflops, nbytes)
        ev, on_dev = cuda_ms(torch, fn), profiled_ms(torch, fn)
        lib = ("" if library is None else
               f", {library[0]} {cuda_ms(torch, library[1]):.4f} by events,"
               f" {profiled_ms(torch, library[1]):.4f} on the device")
        print(f"  {what}: {ev:.4f} ms by events, {on_dev:.4f} on the device"
              f" (torch.profiler), plain {cuda_ms(torch, plain):.4f}{lib}; "
              f"bound {b_ms:.4f} ({b_by}), {100 * b_ms / on_dev:.1f}% of the "
              f"device time [{card}]")

    print("adagrad_dense_pass at wide widths vs plain (1e-6 of scale):")
    for v, d in ((CAN_ROWS, CAN_DIM), (12345, 45), (1001, 72), (777, 272)):
        tb, ac = rand(v, d, scale=0.05), rand(v).abs() * 0.1
        dg = rand(v, d) * (torch.rand(v, generator=gen) < 0.1).to(dev)[:, None]
        old, want = (tb.clone(), ac.clone()), (tb.clone(), ac.clone())
        again = (tb.clone(), ac.clone())
        tk.adagrad_dense_pass(tb, ac, dg, 0.05)
        tk.adagrad_dense_pass(*again, dg, 0.05)
        if not (torch.equal(tb, again[0]) and torch.equal(ac, again[1])):
            fail(f"adagrad_dense_pass at V={v} D={d} is not bit-equal on a "
                 f"repeat")
        tk.adagrad_dense_pass_plain(*want, dg, 0.05)
        for name, got, ref, start in (("rows", tb, want[0], old[0]),
                                      ("accumulators", ac, want[1], old[1])):
            compare(f"V={v} D={d} {name}", got, ref, 0.0, rel=1e-6)
            visible(f"the {name}' update", ref - start,
                    float(ref.abs().max()), rel=1e-6)
    v, d = CAN_ROWS, CAN_DIM
    tb, ac = rand(v, d, scale=0.05), torch.full((v,), 0.1, device=dev)
    dg = rand(v, d)
    # as at D = 16: table and g read, table written, acc read and written
    timed(f"B9 V={v} D={d}", lambda: tk.adagrad_dense_pass(tb, ac, dg, 0.05),
          lambda: tk.adagrad_dense_pass_plain(tb, ac, dg, 0.05),
          v * (4 * d + 5), v * (3 * d + 2) * 4)

    print("adam_dense_pass at wide widths vs plain:")
    touched = torch.zeros(CAN_ROWS, dtype=torch.bool, device=dev)
    touched.index_fill_(0, ids, True)
    cases = ((CAN_ROWS, CAN_DIM, touched),
             (12345, 45, (torch.rand(12345, generator=gen) < 0.3).to(dev)),
             (1001, 72, (torch.rand(1001, generator=gen) < 0.3).to(dev)),
             # rows touched only in a partial last 64-flag chunk
             (1000, 272, torch.arange(1000, device=dev) >= 960))
    for v, d, tch in cases:
        for t in (1, 1000):
            tb, m1 = rand(v, d, scale=0.05), rand(v, d, scale=1e-3)
            v1 = rand(v, d, scale=1e-3).square()
            dg = rand(v, d, scale=1e-3) * tch[:, None]
            dg[::7] = 0.0              # touched rows with a zero gradient
            cnt = torch.tensor(t, dtype=torch.int32, device=dev)
            before = [x.clone() for x in (tb, m1, v1)]
            want = [x.clone() for x in (tb, m1, v1)]
            again = [x.clone() for x in (tb, m1, v1)]
            tk.adam_dense_pass(tb, m1, v1, dg, tch, cnt, 1e-3)
            tk.adam_dense_pass(*again, dg, tch, cnt, 1e-3)
            if not all(torch.equal(u, r) for u, r in zip((tb, m1, v1),
                                                         again)):
                fail(f"adam_dense_pass at V={v} D={d} is not bit-equal on a "
                     f"repeat")
            tk.adam_dense_pass_plain(*want, dg, tch, cnt, 1e-3, 0.9, 0.999,
                                     1e-7)
            for name, got, ref, start in zip(("rows", "m", "v"),
                                             (tb, m1, v1), want, before):
                compare(f"V={v} D={d} t={t} {name}", got, ref, 0.0)
                if not torch.equal(got[~tch], start[~tch]):
                    fail(f"adam_dense_pass changed an untouched {name}")
                visible(f"the touched {name}' change", ref[tch] - start[tch],
                        float(ref.abs().max()))
    v, d = CAN_ROWS, CAN_DIM
    tb, m1 = rand(v, d, scale=0.05), rand(v, d, scale=1e-3)
    v1, dg = rand(v, d, scale=1e-3).square(), rand(v, d)
    cnt = torch.tensor(1, dtype=torch.int32, device=dev)
    # the flags, then table, m, v and g read and table, m, v written for
    # each touched row; ~14 operations a touched element
    timed(f"B10 V={v} D={d}, {distinct} rows touched",
          lambda: tk.adam_dense_pass(tb, m1, v1, dg, touched, cnt, 1e-3),
          lambda: tk.adam_dense_pass_plain(tb, m1, v1, dg, touched, cnt,
                                           1e-3, 0.9, 0.999, 1e-7),
          14 * distinct * d, v + distinct * 7 * d * 4 + 4)
    del m1, v1

    print(f"gather_rows and scatter_add_rows at D={CAN_DIM} with the "
          f"batch's CAN ids:")
    got, want = gk.gather_rows(tb, ids), gk.gather_rows_plain(tb, ids)
    if not (torch.equal(got, want) and float(got.abs().max()) > 0):
        fail(f"gather_rows at D={CAN_DIM} differs from its plain version")
    print(f"  gather_rows: shape {tuple(got.shape)} equal")
    vals = rand(n, CAN_DIM, scale=1e-3)
    buf, ref = torch.zeros_like(tb), torch.zeros_like(tb)
    ek.scatter_add_rows(buf, ids, vals)
    ek.scatter_add_rows_plain(ref, ids, vals)
    scale = float(torch.zeros_like(tb).index_add_(0, ids, vals.abs()).max())
    compare_sum(f"scatter_add_rows D={CAN_DIM}", buf, ref, scale)
    visible("the added rows", ref, scale, rel=SUM_TOL)
    # B11: the distinct rows read, the (n, D) rows written, the ids read;
    # B12: the values and ids read, the distinct rows read and written
    timed(f"B11 D={CAN_DIM}, {n} ids", lambda: gk.gather_rows(tb, ids),
          lambda: gk.gather_rows_plain(tb, ids), 0,
          (distinct + n) * CAN_DIM * 4 + n * 8,
          ("index_select", lambda: torch.index_select(tb, 0, ids)))
    timed(f"B12 D={CAN_DIM}, {n} ids",
          lambda: ek.scatter_add_rows(buf, ids, vals),
          lambda: ek.scatter_add_rows_plain(buf, ids, vals), n * CAN_DIM,
          (n + 2 * distinct) * CAN_DIM * 4 + n * 8,
          ("index_add_", lambda: buf.index_add_(0, ids, vals)))


def cli_launches(per_step: dict, steps: int, eval_batches: int,
                 per_eval: dict = None) -> dict:
    """Launches of a CLI run: ``per_step`` for each step, and ``per_eval``
    (one row gather unless given) for each batch of its one (final)
    eval."""
    want = {k: v * steps for k, v in per_step.items()}
    for k, v in (per_eval or {"gather_rows": 1}).items():
        want[k] = want.get(k, 0) + v * eval_batches
    return want


def run_cli(cli, counted, args, what: str, launches: dict,
            lines_out: list = None):
    """``rec_now_tpu_torch.train.main(args)``, which ``python -m
    rec_now_tpu_torch.train`` runs, in this process with its output
    captured and every launch count set to 0 just before it and held to
    ``launches`` just after -> (its periodic log lines, its final eval);
    every JSON line it printed goes to ``lines_out`` when given; fails on
    a non-zero exit, a loss that is not finite and > 0, or a final eval
    without a finite auc and gauc."""
    out = io.StringIO()

    def main():
        with contextlib.redirect_stdout(out):
            return cli.main(args)

    t0 = time.perf_counter()
    try:
        rc = counted(what, 1, launches, main)
    except BaseException:
        print(out.getvalue()[-3000:])
        raise
    print(f"  exit {rc} after {time.perf_counter() - t0:.1f} s")
    if rc != 0:
        print(out.getvalue()[-3000:])
        fail(f"{what}: the training CLI exited {rc}")
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()
             if ln.startswith("{")]
    if lines_out is not None:
        lines_out.extend(lines)
    logs = [ln for ln in lines if "examples_per_sec" in ln]
    finals = [ln for ln in lines if "final_eval" in ln]
    for ln in logs:
        print(f"  {json.dumps(ln)}")
    losses = [v for ln in logs for k, v in ln.items()
              if k not in ("step", "examples_per_sec", "sparse_dropped")]
    if not logs or not all(math.isfinite(v) and v > 0 for v in losses):
        fail(f"{what}: no log line or a bad loss")
    if len(finals) != 1:
        fail(f"{what}: {len(finals)} final_eval lines")
    res = finals[0]["final_eval"]
    print(f"  final_eval {json.dumps(res)}")
    if not all(math.isfinite(res.get(k, math.nan)) for k in ("auc", "gauc")):
        fail(f"{what}: the final eval has no finite auc and gauc")
    return logs, res


def steady_ms(logs, batch: int) -> float:
    """ms per step over the second half of the log lines (the prefetch
    queues' head start spent): a line at step s with rate r was printed
    batch * s / r seconds into the loop."""
    a, b = logs[len(logs) // 2], logs[-1]
    ta = batch * a["step"] / a["examples_per_sec"]
    tb = batch * b["step"] / b["examples_per_sec"]
    return (tb - ta) / (b["step"] - a["step"]) * 1e3


def train_cli_phase(torch, counted, card: str) -> dict:
    """Phase 8: the training entry point on the card (module docstring);
    returns the windowed CLI runs' ms per step (A: device eval, B: exact
    eval) for phase 9."""
    import numpy as np
    from rec_now_tpu_torch import train as cli
    from rec_now_tpu_torch.training.checkpoint import CheckpointManager
    from rec_now_tpu_torch.training.prefetch import (DevicePrefetcher,
                                                     WindowPrefetcher)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        args = cli.parse_args(CLI_FLAGSHIP + CLI_COMMON)
        batches, make_eval, _ = cli.data_streams(args)
        first = [next(batches) for _ in range(args.scan_window)]
        per_step = {"gather_rows": 1, "scatter_add_rows": 1,
                    "pair_loss_sum": 1, "adagrad_dense_pass": 1}

        # the CLI's first window, in process: the windowed loop against
        # put + train_step on the same (host-dequantized) batches
        trainer = cli.make_trainer(args)
        state = cli.init_state(trainer, args)
        win = trainer.put_packed_window(first)
        state, seq = counted(
            f"the CLI's first window in process ({len(first)} steps at "
            f"B=8192)", len(first), per_step,
            lambda: trainer.train_many_packed(state, win))
        ref = cli.make_trainer(args)
        rstate = cli.init_state(ref, args)
        packed = ref.wire.pack_window(first)
        native = ref.wire.pack_window_native(first)
        same = all(a.dtype == b.dtype and np.array_equal(a, b)
                   for a, b in zip(native, packed))
        print(f"the first window's C++ pack (what put_packed_window runs) "
              f"vs the numpy pack: {'equal' if same else 'DIFFERENT'} "
              f"bytes")
        if not same:
            fail("the C++ wire pack differs from the numpy pack")
        scale = packed.dense_scale                      # (S, 1, 2, F)
        deq = (packed.dense.astype(np.float32) * scale[:, :, 1]
               + scale[:, :, 0])
        print("windowed loop vs put + train_step, first window:")
        for i, b in enumerate(first):
            rstate, m = ref.train_step(rstate, *ref.put(
                b._replace(dense=deq[i])))
            for key, want in m.items():
                got, want = float(seq[key][i]), float(want)
                print(f"  step {i + 1} {key}: windowed {got:.7f} "
                      f"stepwise {want:.7f}")
                if not abs(got - want) <= 1e-4 * abs(want):
                    fail(f"windowed step {i + 1} {key} {got} != {want}")
        del ref, rstate

        # the CLI's two loops (with their prefetch threads) on batches
        # drawn beforehand (the CLI's rate below includes drawing them),
        # and the windowed loop alone on windows placed beforehand (what
        # the prefetch thread's host work costs it), from the state above,
        # four times each in alternating order; each read whole and from
        # its first batch's arrival (the pipeline's fill left out)
        t0 = time.perf_counter()
        more = [next(batches) for _ in range(LOOP_STEPS)]
        gen_ms = (time.perf_counter() - t0) / LOOP_STEPS * 1e3
        pack_ms = {}
        for name, pack in (("numpy", trainer.wire.pack_window),
                           ("C++", trainer.wire.pack_window_native)):
            t0 = time.perf_counter()
            for i in range(0, LOOP_STEPS, args.scan_window):
                pack(more[i:i + args.scan_window])
            pack_ms[name] = (time.perf_counter() - t0) / LOOP_STEPS * 1e3

        def windowed(st):
            arrived = None
            with WindowPrefetcher(more, trainer.put_packed_window,
                                  args.scan_window) as wins:
                for dev_win, _ in wins:
                    arrived = arrived or time.perf_counter()
                    st, _ = trainer.train_many_packed(st, dev_win)
            return st, arrived

        def stepwise(st):
            arrived = None
            with DevicePrefetcher(more, trainer.put) as steps:
                for dev_batch in steps:
                    arrived = arrived or time.perf_counter()
                    st, _ = trainer.train_step(st, *dev_batch)
            return st, arrived

        placed_wins = [trainer.put_packed_window(
            more[i:i + args.scan_window])
            for i in range(0, LOOP_STEPS, args.scan_window)]

        def placed(st):
            arrived = time.perf_counter()
            for dev_win in placed_wins:
                st, _ = trainer.train_many_packed(st, dev_win)
            return st, arrived

        loops = {"windowed": windowed, "stepwise": stepwise,
                 "windowed on placed windows": placed}
        loop_ms = {k: [] for k in loops}
        for r in range(4):
            for name in list(loops)[::1 if r % 2 == 0 else -1]:
                loop = loops[name]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, arrived = counted(
                    f"{name} loop, {LOOP_STEPS} steps at B=8192",
                    LOOP_STEPS, per_step, lambda: loop(state))
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                loop_ms[name].append(((t1 - t0) / LOOP_STEPS * 1e3,
                                      (t1 - arrived) / LOOP_STEPS * 1e3))
        del placed_wins
        print(f"loops on batches drawn beforehand, config 2 at B=8192, "
              f"ms/step whole and from the first batch's arrival: "
              + "; ".join(f"{k} " + ", ".join(f"{a:.3f} / {b:.3f}"
                                               for a, b in v)
                          for k, v in loop_ms.items())
              + "; medians from arrival: " + ", ".join(
                  f"{k} {statistics.median(b for _, b in v):.3f}"
                  for k, v in loop_ms.items())
              + f"; drawing a batch {gen_ms:.1f} ms, packing it "
              + ", ".join(f"{v:.2f} ms ({k})" for k, v in pack_ms.items())
              + f" on the host [{card}]")

        # a checkpoint of that state, restored into a fresh one
        mgr = CheckpointManager(os.path.join(ckdir, "in_process"))
        mgr.save(int(state.step), state)
        other = cli.make_trainer(args)
        back = mgr.restore(target=cli.init_state(other, args))
        saved, restored = state.opt.state_dict(), back.opt.state_dict()
        same = (all(torch.equal(p, back.params[n])
                    for n, p in state.params.items())
                and all(torch.equal(t, getattr(back.table, n))
                        for n, t in state.table._asdict().items()
                        if t is not None)
                and int(back.step) == int(state.step)
                and all(torch.equal(torch.as_tensor(v), torch.as_tensor(
                    restored["state"][i][k]))
                        for i, st in saved["state"].items()
                        for k, v in st.items()))
        print(f"checkpoint at step {int(state.step)} restored into a "
              f"fresh state: {'equal' if same else 'DIFFERENT'}")
        if not same:
            fail("the restored checkpoint differs from the saved state")
        del trainer, state, other, back, win

        # the entry point as users start it, each run counted whole
        fm_step = {"gather_rows": 1, "scatter_add_rows": 1,
                   "adagrad_dense_pass": 1}
        flagship = cli_launches(per_step, args.steps, args.eval_batches,
                                dcn_eval_launches())
        cli_ck = os.path.join(ckdir, "cli")
        a_logs, a_res = run_cli(cli, counted, CLI_FLAGSHIP + CLI_COMMON + [
            "--eval-mode", "device", "--checkpoint-dir", cli_ck,
            "--checkpoint-every", "20"],
            "train CLI A: config 2, windowed, u8, device eval, checkpoints",
            flagship)
        got, want = a_logs[0]["loss"], float(seq["loss"][-1])
        print(f"  CLI step {a_logs[0]['step']} loss {got} vs in process "
              f"{want:.7f}")
        if not abs(got - want) <= 1e-4 * abs(want) + 5e-6:
            fail("the CLI's first window differs from the in-process one")
        b_logs, b_res = run_cli(cli, counted, CLI_FLAGSHIP + CLI_COMMON + [
            "--eval-mode", "exact"], "train CLI B: the same, exact eval",
            flagship)
        for key, tol in (("auc", 1e-3), ("gauc", 2e-3)):
            d = abs(a_res[key] - b_res[key])
            print(f"  device {key} {a_res[key]:.6f} vs exact "
                  f"{b_res[key]:.6f}: {d:.2e} (tol {tol:g})")
            if d > tol:
                fail(f"device-eval {key} is off the exact eval's")
        c_logs, _ = run_cli(cli, counted, CLI_FLAGSHIP + CLI_COMMON + [
            "--scan-window", "0", "--eval-mode", "exact"],
            "train CLI C: config 2, stepwise", flagship)
        run_cli(cli, counted, [
            "--model", "fm", "--batch-size", "8192", "--steps",
            str(FM_STEPS), "--scan-window", "5", "--log-every", "5",
            "--eval-batches", str(FM_EVAL), "--eval-mode", "device"],
            "train CLI D: config 1 (FM), windowed, device eval",
            cli_launches(fm_step, FM_STEPS, FM_EVAL))

        # the CLI's last checkpoint, evaluated again in process
        mgr = CheckpointManager(cli_ck)
        print(f"CLI checkpoints: steps {mgr.steps()}")
        if mgr.steps() != [20, 40, 60]:
            fail("the CLI did not keep checkpoints 20, 40 and 60")
        trainer = cli.make_trainer(args)
        state = mgr.restore(target=cli.init_state(trainer, args))
        evals = list(make_eval())
        res = counted(
            f"device eval of the CLI's last checkpoint ({len(evals)} "
            f"batches)", len(evals), dcn_eval_launches(),
            lambda: trainer.evaluate_device(
                state, evals, num_group_slots=cli.eval_slots(args),
                group_buckets=args.eval_group_buckets))
        for key in ("auc", "gauc"):
            d = abs(res[key] - a_res[key])
            print(f"  restored {key} {res[key]!r} vs the CLI's "
                  f"{a_res[key]!r}: {d:.2e}")
            if d > 1e-6:
                fail("the CLI's checkpoint does not give the CLI's eval")
        w_ms, s_ms = steady_ms(b_logs, 8192), steady_ms(c_logs, 8192)
        print(f"train CLI, config 2 at B=8192, steps "
              f"{b_logs[len(b_logs) // 2]['step']}-{b_logs[-1]['step']}, "
              f"batches drawn as it runs: windowed (--scan-window 5) "
              f"{w_ms:.3f} ms/step, {8192 / w_ms * 1e3:.0f} examples/s; "
              f"stepwise {s_ms:.3f} ms/step, {8192 / s_ms * 1e3:.0f} "
              f"examples/s [{card}]")
        return {"A": steady_ms(a_logs, 8192), "B": w_ms, "B_logs": b_logs,
                "B_res": b_res}
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


def step_collectives(tables: int, steps: int = 1) -> dict:
    """The collectives ``steps`` training steps call on a mesh: each
    table's lookup gathers the ids and reduce-scatters the rows, its
    update gathers the ids and their gradients; one all_reduce sums the
    loss terms' sums and counts, one the parameter gradients."""
    return {"all_gather_into_tensor": 3 * tables * steps,
            "reduce_scatter_tensor": tables * steps, "all_reduce": 2 * steps}


def snapshot(state) -> dict:
    """A copy of a training state's parameters and tables."""
    out = {"params": {n: p.detach().clone() for n, p in state.params.items()},
           "table": state.table.table.clone()}
    if state.can_table is not None:
        out["can_table"] = state.can_table.table.clone()
    return out


def spread(a: dict, b: dict) -> dict:
    """Each part's largest difference between two snapshots over its
    largest value (the largest over the parameters)."""
    out = {"params": max(
        float((a["params"][n] - p).abs().max())
        / max(float(p.abs().max()), 1e-30) for n, p in b["params"].items())}
    for key in b:
        if key != "params":
            out[key] = float((a[key] - b[key]).abs().max()) / float(
                b[key].abs().max())
    return out


def full_state(state) -> dict:
    """A copy of everything a training state holds: params, the Adam
    state, the step and every tensor of each table."""
    import copy
    out = {"params": {n: p.detach().clone() for n, p in state.params.items()},
           "opt": copy.deepcopy(state.opt.state_dict()),
           "step": int(state.step)}
    for key in ("table", "can_table"):
        t = getattr(state, key)
        if t is not None:
            out[key] = {k: v.clone() for k, v in t._asdict().items()
                        if v is not None}
    return out


def same_state(torch, a, b) -> bool:
    """Two :func:`full_state` copies (or nests of them) bit for bit."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(same_state(torch, a[k], b[k])
                                        for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_state(torch, x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        return a.shape == b.shape and torch.equal(a.cpu(), b.cpu())
    return a == b


def routed_part(torch, counted, collectives, card: str, fc, batch, mesh,
                dev) -> None:
    """Phase 10 (e): the routed exchange's lookup and update bodies on the
    NCCL group of one (where ``route_mode`` resolves to allgather, as in
    JAX) on config 2's table (dense Adagrad, then lazy Adam) and config 5's
    CAN table, one B = 8192 batch's ids (module docstring)."""
    from rec_now_tpu_torch.embedding import exchange
    from rec_now_tpu_torch.embedding.sharded import ShardedEmbeddingTable
    from rec_now_tpu_torch.ops.expand_kernel import scatter_add_rows
    ids = torch.as_tensor(batch.sparse_ids, device=dev)
    cases = [("config 2 table, Adagrad", dict(
                  vocab_size=fc.total_rows, dim=fc.embedding_dim),
              fc.global_ids(ids).reshape(-1), "adagrad_dense_pass"),
             ("config 2 table, lazy Adam", dict(
                  vocab_size=fc.total_rows, dim=fc.embedding_dim,
                  optimizer="adam"),
              fc.global_ids(ids).reshape(-1), "adam_dense_pass"),
             ("config 5 CAN table, Adagrad", dict(
                  vocab_size=CAN_ROWS, dim=CAN_DIM, initializer_scale=0.05),
              (ids[:, CAN_FIELD] % CAN_ROWS).reshape(-1),
              "adagrad_dense_pass")]
    gen = torch.Generator(device=dev).manual_seed(7)
    for what, kw, flat, update_pass in cases:
        table = ShardedEmbeddingTable(mesh=mesh, route_mode="routed", **kw)
        if table.route_mode != "allgather":
            fail(f"{what}: routed on a group of one resolved to "
                 f"{table.route_mode}, not allgather (JAX's resolution)")
        state = table.init(torch.Generator().manual_seed(1))
        n = flat.shape[0]
        distinct = int(torch.unique(flat).numel())
        cap, ov_cap = table._route_caps(n)
        print(f"routed exchange, {what}: {n} ids, {distinct} distinct, "
              f"cap {cap}, ov_cap {ov_cap}")

        def lookup_routed(table=table, state=state, flat=flat):
            return table._lookup_routed(state.table, flat)

        def lookup_ag(table=table, state=state, flat=flat):
            return table.lookup(state, flat, return_dropped=True)

        rows_r, dropped = collectives(
            f"{what}: routed lookup", ROUTED_LOOKUP,
            lambda: counted(f"{what}: routed lookup", 1, {"gather_rows": 2},
                            lookup_routed))
        rows_a, _ = collectives(
            f"{what}: allgather lookup", AG_LOOKUP,
            lambda: counted(f"{what}: allgather lookup", 1,
                            {"gather_rows": 1}, lookup_ag))
        same = torch.equal(rows_r, rows_a)
        print(f"  routed lookup vs allgather: "
              f"{'equal' if same else 'DIFFERENT'} rows, dropped "
              f"{int(dropped)}")
        if not same or int(dropped) != 0:
            fail(f"{what}: the routed lookup differs from the allgather one "
                 f"or dropped {int(dropped)} ids at the default caps")

        # one update each way from the same state on dyadic gradients
        # (multiples of 2^-8: their sums are exact in any order), so the
        # states must be bit-equal
        grads = torch.randint(-64, 64, (n, table.dim), device=dev,
                              generator=gen).to(torch.float32) / 256
        lr = 1e-3 if kw.get("optimizer") == "adam" else 0.05

        def clone(st):
            return type(st)(*[None if t is None else t.clone() for t in st])

        st_r, st_a = clone(state), clone(state)
        collectives(f"{what}: routed update", ROUTED_UPDATE, lambda: counted(
            f"{what}: routed update", 1,
            {"scatter_add_rows": 2, update_pass: 1},
            lambda: table._apply_owned(
                st_r, *table._routed_candidates(flat, grads), lr)))
        collectives(f"{what}: allgather update", AG_UPDATE, lambda: counted(
            f"{what}: allgather update", 1,
            {"scatter_add_rows": 1, update_pass: 1},
            lambda: table.apply_grads(st_a, flat, grads, lr)))
        same = all(torch.equal(getattr(st_r, k), a)
                   for k, a in st_a._asdict().items() if a is not None)
        moved = int((st_a.table != state.table).any(1).sum())
        # on random gradients the duplicates sum in another order: each
        # summed element within SUM_TOL of the sum of its terms' |values|
        rgrads = torch.randn(n, table.dim, device=dev, generator=gen) * 1e-2
        dense = [scatter_add_rows(torch.zeros_like(state.table), *owned)
                 for owned in (table._routed_candidates(flat, rgrads),
                               table._owned(flat, rgrads))]
        scale = torch.zeros_like(state.table).index_add_(0, flat,
                                                         rgrads.abs())
        worst = float(((dense[0] - dense[1]).abs()
                       / scale.clamp_min(1e-30)).max())
        print(f"  routed update vs allgather: dyadic gradients, states "
              f"{'bit-equal' if same else 'DIFFERENT'}, {moved} rows "
              f"moved; random gradients, summed gradients within "
              f"{worst:.3e} of their terms' summed |values|")
        if not same or moved == 0 or worst > SUM_TOL:
            fail(f"{what}: the routed update is off the allgather one")
        del dense, scale

        # a cap of a tenth of the share: full buckets, a full lane, drops;
        # the card's plan equals the CPU's from the same ids
        forced = ShardedEmbeddingTable(mesh=mesh, route_mode="routed",
                                       route_cap_factor=FORCED_CAP, **kw)
        fcap, fov = forced._route_caps(n)
        uid, slot = exchange.sort_dedup(flat)
        plan = exchange.plan_route(uid, 1, fcap, fov)
        cpu_uid, _ = exchange.sort_dedup(flat.cpu())
        cpu_plan = exchange.plan_route(cpu_uid, 1, fcap, fov)
        same_plan = all(torch.equal(a.cpu(), b)
                        for a, b in zip(plan, cpu_plan))
        rows_f, dropped_f = collectives(
            f"{what}: routed lookup, cap factor {FORCED_CAP}",
            ROUTED_LOOKUP, lambda: forced._lookup_routed(state.table, flat))
        zero = (rows_f == 0).all(1)
        zero_ids = int(torch.unique(flat[zero]).numel())
        in_main = int((plan.ret_slot >= 0).sum())
        in_lane = int((plan.ov_slot >= 0).sum())
        print(f"  cap factor {FORCED_CAP}: cap {fcap}, ov_cap {fov}: "
              f"{in_main} ids in the buckets, {in_lane} in the lane, "
              f"dropped {int(dropped_f)} (the CPU's plan "
              f"{int(cpu_plan.dropped)}), {zero_ids} distinct ids read "
              f"zero; plan on the card vs the CPU: "
              f"{'equal' if same_plan else 'DIFFERENT'}")
        if not same_plan or int(dropped_f) != int(cpu_plan.dropped) \
                or zero_ids != int(dropped_f) or int(dropped_f) == 0 \
                or in_main + in_lane + int(dropped_f) != distinct:
            fail(f"{what}: the forced-cap plan or its dropped count is off")
        kept = ~zero
        if not torch.equal(rows_f[kept], rows_a[kept]):
            fail(f"{what}: the forced-cap lookup changed a kept row")

        # the plan's own cost on the group of one: ms by events, and the
        # device operations a call
        def update_routed(table=table, st=st_r, flat=flat, grads=grads,
                          lr=lr):
            table._apply_owned(st, *table._routed_candidates(flat, grads),
                               lr)

        def update_ag(table=table, st=st_a, flat=flat, grads=grads, lr=lr):
            table.apply_grads(st, flat, grads, lr)

        parts, tops = [], []
        for tag, fn in (("lookup routed", lookup_routed),
                        ("lookup allgather", lookup_ag),
                        ("update routed", update_routed),
                        ("update allgather", update_ag)):
            ms = cuda_ms(torch, fn, reps=10, warmup=2)
            seq = profiled_sequence(torch, fn, reps=3)
            parts.append(f"{tag} {ms:.4f} ms ({len(seq) // 3} device "
                         f"operations, {sum(t for _, t in seq) / 3:.4f} ms "
                         f"busy)")
            if tag.endswith("routed"):
                # where a routed call's device time goes: its largest
                # kernels by name, ms a call (and how many a call)
                by = {}
                for name, t in seq:
                    k = kernel_name(name)
                    ms_k, c = by.get(k, (0.0, 0))
                    by[k] = (ms_k + t / 3, c + 1)
                top = sorted(by.items(), key=lambda kv: -kv[1][0])[:5]
                tops.append(f"{tag}: " + ", ".join(
                    f"{k} {v:.4f} ({c // 3})" for k, (v, c) in top))
        print(f"  on the NCCL group of one, by events: " + "; ".join(parts)
              + f" [{card}]")
        print("  largest device kernels, ms a call (launches a call): "
              + "; ".join(tops))
        del state, st_r, st_a, rows_r, rows_a, rows_f


def mesh_phase(torch, counted, card: str, fc, runs, batches, phase8: dict,
               dev) -> None:
    """Phase 10: the multi-process path in a NCCL group of one on ``dev``
    (module docstring)."""
    import torch.distributed as dist
    from rec_now_tpu_torch import train as cli
    from rec_now_tpu_torch.parallel import make_mesh
    from rec_now_tpu_torch.training import Trainer
    from rec_now_tpu_torch.training.checkpoint import CheckpointManager
    calls = dict.fromkeys(COLLECTIVES, 0)
    real = {name: getattr(dist, name) for name in COLLECTIVES}

    def wrapped(name):
        def call(*args, **kwargs):
            calls[name] += 1
            return real[name](*args, **kwargs)
        return call

    def collectives(what: str, want: dict, run):
        """``run()`` with every collective count set to 0 just before it;
        each must be called exactly as ``want`` says (0 where not
        named)."""
        for name in calls:
            calls[name] = 0
        out = run()
        print(f"{what}: collective calls {calls}")
        for name, c in calls.items():
            if c != want.get(name, 0):
                fail(f"{what}: {name} called {c} times, expected "
                     f"{want.get(name, 0)}")
        return out

    def close(what: str, got: float, want: float, rounding: float = 0.0):
        if not abs(got - want) <= MESH_TOL * abs(want) + rounding:
            fail(f"{what}: mesh {got!r} vs one device {want!r}")

    for name in COLLECTIVES:
        setattr(dist, name, wrapped(name))
    try:
        t0 = time.perf_counter()
        mesh = make_mesh(dev)
        print(f"process group: rank {mesh.rank} of {mesh.size} on "
              f"{mesh.device}, backend {dist.get_backend()}, formed in "
              f"{time.perf_counter() - t0:.2f} s")
        if (mesh.size, dist.get_backend()) != (
                1, "nccl" if dev.type == "cuda" else "gloo"):
            fail("the mesh is not a NCCL group of one")

        # (b) configs 4 and 5 in process: MESH_STEPS steps each with and
        # without the mesh, then both timed in turns beside config 2
        args = cli.parse_args(CLI_FLAGSHIP + CLI_COMMON)
        flagship = {"gather_rows": 1, "scatter_add_rows": 1,
                    "pair_loss_sum": 1, "adagrad_dense_pass": 1}
        # what (d) times: (the trainers without and with the mesh, their
        # launches a step, their tables)
        timed = {"config 2 (the CLI's flagship trainer)": (
            [cli.make_trainer(args, m) for m in (None, mesh)], flagship, 1)}
        for run in runs:
            if run["what"] not in ("config 4 (MultiTaskModel)",
                                   "config 5 (CANDCNModel)"):
                continue
            what, tables = run["what"], 2 if run.get("can") else 1
            trainers, out = [], []
            for tag, m in (("one device", None), ("one device again", None),
                           ("mesh", mesh)):
                trainer = Trainer(run["make"](dev), fc, run["cfg"],
                                  device=dev, mesh=m)
                state = collectives(
                    f"{what}, {tag}: init", {"broadcast": 1} if m else {},
                    lambda: trainer.init(torch.Generator().manual_seed(1)))

                def steps(trainer=trainer, state=state):
                    seq, after = [], []
                    for b in batches[:MESH_STEPS]:
                        state, m = trainer.train_step(
                            state, *trainer.put_local(b))
                        seq.append(losses_of(what, m))
                        if len(after) < 1:
                            after.append(snapshot(state))
                    return state, seq, after + [snapshot(state)]
                want = step_collectives(tables, MESH_STEPS) if m else {}
                out.append(counted(
                    f"{what}, {tag}: {MESH_STEPS} steps at B=8192",
                    MESH_STEPS, run["train"],
                    lambda: collectives(f"{what}, {tag}: {MESH_STEPS} steps",
                                        want, steps)))
                if tag != "one device again":
                    trainers.append(trainer)
            (_, one_seq, one), (_, _, again), (_, mesh_seq, on_mesh) = out
            for i, (a, b) in enumerate(zip(mesh_seq, one_seq)):
                if set(a) != set(b) or set(b) != run["keys"]:
                    fail(f"{what}: metric keys {set(a)} vs {set(b)}")
                for key in sorted(b):
                    close(f"{what} step {i + 1} {key}", a[key], b[key])
                print(f"  step {i + 1}: " + ", ".join(
                    f"{k} mesh {a[k]:.7f} one device {b[k]:.7f}"
                    for k in sorted(b)))
            # after step 1 the parameters are bit-equal (no sum in the
            # dense path's step is atomic) and the tables within SUM_TOL
            # (B12's atomics); after MESH_STEPS steps the mesh is held to
            # STATE_TOL, and the one-device run repeated shows what the
            # order of B12's adds alone moves
            first = spread(on_mesh[0], one[0])
            if first["params"] != 0.0:
                fail(f"{what}: params after step 1 differ by "
                     f"{first['params']:.3e} of the largest value")
            for key, d in first.items():
                if d > SUM_TOL:
                    fail(f"{what}: {key} after step 1 differs by {d:.3e} "
                         f"of the largest value (> {SUM_TOL:g})")
            last, rep = spread(on_mesh[1], one[1]), spread(again[1], one[1])
            print(f"  largest difference over the largest value, after step "
                  f"1: " + ", ".join(f"{k} {v:.2e}" for k, v in first.items())
                  + f"; after {MESH_STEPS} steps: " + ", ".join(
                      f"{k} {v:.2e} (one device repeated {rep[k]:.2e})"
                      for k, v in last.items()))
            for key, d in last.items():
                if d > STATE_TOL:
                    fail(f"{what}: {key} after {MESH_STEPS} steps differs "
                         f"by {d:.3e} of the largest value (> {STATE_TOL:g})")
            del out, one, again, on_mesh
            timed[what] = (trainers, run["train"], tables)

        # (d) each config's step with and without the mesh, in turns
        # (one device, mesh, mesh, one device), on batches placed
        # beforehand: wall ms by the host clock, each step ending in a
        # synchronize (as phase 6) and, in the same turn, the steps back
        # to back with one synchronize at the end (as a training loop runs
        # them); busy ms on the device
        for what, (pair, per_step, tables) in timed.items():
            states = [t.init(torch.Generator().manual_seed(1)) for t in pair]
            dev_batches = [[t.put_local(b) for b in batches[:MESH_TIMED]]
                           for t in pair]
            wall = {0: [], 1: []}
            stream = {0: [], 1: []}
            for i in (0, 1, 1, 0):
                trainer, state = pair[i], states[i]

                def turn(trainer=trainer, state=state, i=i):
                    times = []
                    for b in dev_batches[i]:
                        t0 = time.perf_counter()
                        state, _ = trainer.train_step(state, *b)
                        torch.cuda.synchronize()
                        times.append((time.perf_counter() - t0) * 1e3)
                    t0 = time.perf_counter()
                    for b in dev_batches[i]:
                        state, _ = trainer.train_step(state, *b)
                    torch.cuda.synchronize()
                    return times, (time.perf_counter() - t0) * 1e3 / len(
                        dev_batches[i])
                tag = "mesh" if i else "one device"
                times, back_to_back = counted(
                    f"{what}, {tag}: 2 x {MESH_TIMED} timed steps",
                    2 * MESH_TIMED, per_step, lambda: collectives(
                        f"{what}, {tag}: 2 x {MESH_TIMED} timed steps",
                        step_collectives(tables, 2 * MESH_TIMED) if i
                        else {}, turn))
                wall[i] += times
                stream[i].append(back_to_back)
            busy = [profiled_ms(torch, lambda i=i: pair[i].train_step(
                states[i], *dev_batches[i][0]), reps=5) for i in (0, 1)]
            print(f"{what} at B=8192, ms/step: one device wall "
                  f"{statistics.median(wall[0]):.3f} (median of "
                  f"{2 * MESH_TIMED}, each synchronized), back to back "
                  f"{', '.join(f'{x:.3f}' for x in stream[0])}, busy "
                  f"{busy[0]:.3f}; mesh of one (NCCL) wall "
                  f"{statistics.median(wall[1]):.3f}, back to back "
                  f"{', '.join(f'{x:.3f}' for x in stream[1])}, busy "
                  f"{busy[1]:.3f}; collective calls a step "
                  f"{step_collectives(tables)} [{card}]")
            del states, dev_batches
        del timed

        # (a) the CLI's flagship run under --multihost against phase 8's
        # run B (the same flags without it), on the routed exchange (which
        # a group of one resolves to allgather) and with checkpoints: the
        # last one, restored into a fresh state, equals the live state
        steps, evals = args.steps, args.eval_batches
        want = step_collectives(1, steps)
        # the eval batches' lookups and their gathered columns; init's
        # broadcast of the parameters
        want["all_gather_into_tensor"] += 2 * evals
        want["reduce_scatter_tensor"] += evals
        want["broadcast"] = 1
        what = ("train CLI E: run B's flags with --multihost "
                "--sparse-route-mode routed --checkpoint-dir")
        ckdir = tempfile.mkdtemp(prefix="chip_smoke_mesh_ckpt_")
        e_flags = CLI_FLAGSHIP + CLI_COMMON + [
            "--eval-mode", "exact", "--multihost", "--sparse-route-mode",
            "routed", "--checkpoint-dir", ckdir]
        live = {}
        save = CheckpointManager.save

        def keep_live(self, step, state):
            live[step] = full_state(state)
            return save(self, step, state)

        CheckpointManager.save = keep_live
        try:
            logs, res = collectives(what, want, lambda: run_cli(
                cli, counted, e_flags, what,
                cli_launches(flagship, steps, evals, dcn_eval_launches())))
            mgr = CheckpointManager(ckdir)
            e_args = cli.parse_args(e_flags)
            back = mgr.restore(target=cli.init_state(
                cli.make_trainer(e_args, mesh), e_args))
            same = (mgr.steps() == [steps] and list(live) == [steps]
                    and same_state(torch, full_state(back), live[steps]))
            print(f"  checkpoint {mgr.steps()} restored into a fresh state "
                  f"vs the live state at its save: "
                  f"{'equal' if same else 'DIFFERENT'}")
            if not same:
                fail(f"{what}: the restored checkpoint differs from the "
                     "live state")
            del back, live
        finally:
            CheckpointManager.save = save
            shutil.rmtree(ckdir, ignore_errors=True)
        b_logs, b_res = phase8["B_logs"], phase8["B_res"]
        if [ln["step"] for ln in logs] != [ln["step"] for ln in b_logs]:
            fail(f"{what}: logged other steps than run B")
        for a, b in zip(logs, b_logs):
            for key in sorted(b):
                if key in ("step", "examples_per_sec", "sparse_dropped"):
                    continue
                # the log rounds to 5 decimals: 1e-5 apart at most from it
                close(f"{what} step {b['step']} {key}", a[key], b[key],
                      1e-5)
        for key in sorted(b_res):
            close(f"{what} final {key}", res[key], b_res[key])
            print(f"  final {key}: --multihost {res[key]!r} vs run B "
                  f"{b_res[key]!r}")
        print(f"  {len(logs)} log lines within {MESH_TOL:g} relative of run "
              f"B's (and the log's rounding to 5 decimals)")
        print(f"train CLI, config 2 at B=8192, --multihost (NCCL group of "
              f"one): windowed {steady_ms(logs, 8192):.3f} ms/step vs run B "
              f"{phase8['B']:.3f} [{card}]")

        # (e) the routed exchange's bodies, called directly
        routed_part(torch, counted, collectives, card, fc, batches[0], mesh,
                    dev)
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)
        if dist.is_initialized():
            dist.destroy_process_group()


def median_ms(fn, reps: int) -> float:
    """The median host ms of ``reps`` calls of ``fn`` (host work only)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def file_cli_phase(torch, counted, card: str, synthetic_ms: dict) -> None:
    """Phase 9: the training entry point on a data file (module
    docstring), at the flagship setting's batch size and rows a field."""
    import numpy as np
    from rec_now_tpu_torch import train as cli
    from rec_now_tpu_torch.io import (CriteoTSV, build as io_build,
                                      parse_chunk, write_synthetic_tsv)
    from rec_now_tpu_torch.training.prefetch import WindowPrefetcher
    from rec_now_tpu_torch.training.trainer import Trainer
    from rec_now_tpu_torch.training.wire import WireFormat
    setting = cli.parse_args(CLI_FLAGSHIP)
    bsz, rows_pf = setting.batch_size, setting.rows_per_field
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tsv_")
    put_window = Trainer.put_packed_window
    try:
        # the files: the port's writer, full width
        train_tsv = os.path.join(tmp, "train.tsv")
        eval_tsv = os.path.join(tmp, "eval.tsv")
        t0 = time.perf_counter()
        n_rows = (FILE_STEPS + FILE_EVAL) * bsz
        write_synthetic_tsv(train_tsv, n_rows, rows_per_field=rows_pf)
        t1 = time.perf_counter()
        write_synthetic_tsv(eval_tsv, FILE_EVAL * bsz,
                            rows_per_field=rows_pf, sample_seed=99)
        print(f"data files: {n_rows} rows ("
              f"{os.path.getsize(train_tsv) / 1e6:.1f} MB) in "
              f"{t1 - t0:.1f} s and {FILE_EVAL * bsz} eval rows in "
              f"{time.perf_counter() - t1:.1f} s (write_synthetic_tsv, one "
              f"host thread)")

        # the parser: its build, native vs plain, its time
        t0 = time.perf_counter()
        lib_path = io_build.load()._name
        print(f"native parser: {os.path.basename(lib_path)} loaded in "
              f"{time.perf_counter() - t0:.2f} s (g++, built if stale)")
        with open(train_tsv, "rb") as f:
            chunk = f.read(8 << 20)                 # CriteoTSV's chunk
        chunk = chunk[:chunk.rfind(b"\n") + 1]
        head = b"\n".join(chunk.split(b"\n", PARSE_CHECK_LINES)
                          [:PARSE_CHECK_LINES]) + b"\n"
        nat = parse_chunk(head, rows_per_field=rows_pf)
        py = parse_chunk(head, rows_per_field=rows_pf, force_python=True)
        same = (nat[4] == py[4] == PARSE_CHECK_LINES
                and all(np.array_equal(nat[k], py[k]) for k in (1, 2, 3)))
        rel = float(np.max(np.abs(nat[0] - py[0])
                           / np.maximum(np.abs(py[0]), 1e-30)))
        print(f"native parser vs its plain version on the first "
              f"{PARSE_CHECK_LINES} lines: ids, labels and groups "
              f"{'equal' if same else 'DIFFERENT'}, dense max relative "
              f"error {rel:.2e} (tol 1e-6)")
        if not same or rel > 1e-6:
            fail("the native parser differs from its plain version")
        rows = chunk.count(b"\n")
        threads = min(os.cpu_count() or 1, 16)
        nat_ms = median_ms(lambda: parse_chunk(
            chunk, rows_per_field=rows_pf), 7) * 8192 / rows
        py_ms = median_ms(lambda: parse_chunk(
            head, rows_per_field=rows_pf, force_python=True),
            1) * 8192 / PARSE_CHECK_LINES
        tsv = functools.partial(CriteoTSV, rows_per_field=rows_pf)
        t0 = time.perf_counter()
        n_file = sum(1 for _ in tsv(train_tsv).batches(bsz))
        tsv_ms = (time.perf_counter() - t0) * 1e3 / n_file
        print(f"parse per 8,192 rows: native {nat_ms:.2f} ms ({threads} "
              f"threads, an 8 MB chunk of {rows} rows, median of 7), plain "
              f"{py_ms:.1f} ms (one thread); CriteoTSV.batches "
              f"{tsv_ms:.2f} ms a batch of {bsz} over the file's {n_file} "
              f"(reads, "
              f"parse, concatenation) on the host [{card}]")
        if n_file != FILE_STEPS + FILE_EVAL:
            fail(f"the file gave {n_file} batches")

        # the wire on the file's first window: C++ vs numpy, both id modes
        first = list(tsv(train_tsv).batches(bsz, 5))
        for mode in ("packed", "hot8"):
            wires = [WireFormat(26, rows_pf, "u8", id_mode=mode)
                     for _ in range(2)]
            t0 = time.perf_counter()
            want = wires[0].pack_window(first)
            t1 = time.perf_counter()
            got = wires[1].pack_window_native(first)
            t2 = time.perf_counter()
            same = all(a.dtype == b.dtype and a.shape == b.shape
                       and np.array_equal(a, b) for a, b in zip(got, want))
            np_ms = median_ms(lambda: wires[0].pack_window(first), 5)
            cc_ms = median_ms(lambda: wires[1].pack_window_native(first), 5)
            cost = WireFormat.wire_cost(13, 26, rows_pf, "u8", mode)[0]
            measured = sum(a.nbytes for a in got) / (5 * bsz)
            esc = ""
            if mode == "hot8":
                esc = (f", escapes {float((got.id_words == 255).mean()):.4f}"
                       f" of the ids, table version "
                       f"{wires[1].hot_version}")
            print(f"wire {mode}, the file's first window (5 x {bsz}, u8 "
                  f"dense): C++ pack vs numpy "
                  f"{'equal' if same else 'DIFFERENT'} bytes; first pack "
                  f"numpy {(t1 - t0) * 1e3:.1f} ms, C++ "
                  f"{(t2 - t1) * 1e3:.1f} ms; then numpy {np_ms:.1f} ms, "
                  f"C++ {cc_ms:.1f} ms a window (median of 5); "
                  f"{measured:.3f} B/example as packed (wire_cost {cost})"
                  f"{esc} [{card}]")
            if not same:
                fail(f"the C++ {mode} pack differs from the numpy pack")

        # every window the runs pack, kept with its host ids and decoded on
        # the card after the run
        packed_windows = []

        def recording(self, batches, raw_groups=False):
            batches = list(batches)
            out = put_window(self, batches, raw_groups=raw_groups)
            packed_windows.append((self.wire, np.stack(
                [b.sparse_ids for b in batches]), out))
            return out

        def check_windows(what: str) -> None:
            bad = sum(not np.array_equal(
                wire.decode(dev)[1].cpu().numpy(), ids)
                for wire, ids, dev in packed_windows)
            modes = sorted({w.id_mode for w, _, _ in packed_windows})
            print(f"  {what}: {len(packed_windows)} windows ({modes}) "
                  f"decoded on the card, {bad} off their host ids")
            if bad or not packed_windows:
                fail(f"{what}: a window decodes to other ids")
            packed_windows.clear()

        Trainer.put_packed_window = recording
        per_step = {"gather_rows": 1, "scatter_add_rows": 1,
                    "pair_loss_sum": 1, "adagrad_dense_pass": 1}
        base = CLI_FLAGSHIP + ["--eval-mode", "device", "--log-every", "5",
                               "--eval-batches", str(FILE_EVAL),
                               "--data-file", train_tsv]
        runs = {}
        for key, extra, steps, what in (
                ("1", ["--eval-file", eval_tsv, "--wire-id-mode", "hot8"],
                 FILE_STEPS, "--eval-file, hot8"),
                ("2", ["--eval-file", eval_tsv, "--wire-id-mode", "packed"],
                 FILE_STEPS, "--eval-file, packed ids"),
                ("3", ["--wire-id-mode", "hot8"], FILE_STEPS,
                 "held-out eval, hot8"),
                ("4", ["--wire-id-mode", "hot8"], FILE_STEPS + FILE_EVAL,
                 "steps past the file's end, hot8")):
            lines = []
            args = base + extra + ["--steps", str(steps + (key == "4"))]
            logs, res = run_cli(
                cli, counted, args,
                f"file CLI {key}: {setting.model} from the file, windowed, u8, "
                f"device eval, {what}",
                cli_launches(per_step, steps, FILE_EVAL,
                             dcn_eval_launches()), lines)
            check_windows(f"file CLI {key}")
            runs[key] = (logs, res, lines)

        (l1, _, _), (l2, _, _) = runs["1"], runs["2"]
        for k in ("loss", "pointwise", "pairwise"):
            a, b = l1[0][k], l2[0][k]
            print(f"  step {l1[0]['step']} {k}: hot8 {a} packed {b}")
            if not abs(a - b) <= 1e-4 * abs(b):
                fail("hot8 and packed ids train differently")
        for key, on_train in (("3", False), ("4", True)):
            lines = runs[key][2]
            warned = [ln for ln in lines if "warning" in ln]
            final = lines[-1]
            flagged = [ln.get("eval_on_train") for ln in lines
                       if "eval" in ln or "final_eval" in ln]
            print(f"  file CLI {key}: warning lines {len(warned)}, "
                  f"eval_on_train on the eval lines {flagged}")
            if on_train != bool(warned) or "final_eval" not in final or \
                    flagged != [True if on_train else None]:
                fail(f"file CLI {key}: the held-out marking is wrong")
            if on_train and lines.index(warned[0]) > lines.index(final):
                fail("the warning line comes after the final line")
        ms1, ms2 = steady_ms(l1, bsz), steady_ms(l2, bsz)
        print(f"train CLI from a file, {setting.model} at B={bsz}, steps "
              f"{l1[len(l1) // 2]['step']}-{l1[-1]['step']}: hot8 "
              f"{ms1:.3f} ms/step, packed ids {ms2:.3f} ms/step; the "
              f"synthetic stream (phase 8, windowed) {synthetic_ms['A']:.3f} "
              f"(device eval) / {synthetic_ms['B']:.3f} (exact eval) "
              f"ms/step [{card}]")

        # the CLI's windowed loop fed from the file (the parse on a thread
        # of its own, the pack and copy on another) against the same loop
        # on windows placed beforehand, hot8 and packed ids, in turns; each
        # read from the first window's arrival (the pipeline's fill left
        # out), the median of 4
        Trainer.put_packed_window = put_window
        file_batches = list(tsv(train_tsv).batches(bsz, FILE_STEPS))

        def from_file(tr, st, _, threads=None):
            arrived = None
            with WindowPrefetcher(tsv(train_tsv, num_threads=threads).batches(
                    bsz, FILE_STEPS), tr.put_packed_window, 5) as wins:
                for dev_win, _ in wins:
                    arrived = arrived or time.perf_counter()
                    st, _ = tr.train_many_packed(st, dev_win)
            return st, arrived

        def placed(tr, st, wins):
            arrived = time.perf_counter()
            for dev_win in wins:
                st, _ = tr.train_many_packed(st, dev_win)
            return st, arrived

        loops, ready = {}, {}
        for mode in ("hot8", "packed"):
            args = cli.parse_args(CLI_FLAGSHIP + ["--wire-id-mode", mode])
            tr = cli.make_trainer(args)
            ready[mode] = [tr, cli.init_state(tr, args), [
                tr.put_packed_window(file_batches[i:i + 5])
                for i in range(0, FILE_STEPS, 5)]]
            loops[f"{mode} from the file"] = (mode, from_file)
            loops[f"{mode} on placed windows"] = (mode, placed)
        # the parser's threads share the host's cores with the loop thread,
        # which dispatches the steps: the same loop with fewer of them
        for n in PARSE_THREADS:
            loops[f"hot8 from the file, the parser on {n} threads"] = (
                "hot8", functools.partial(from_file, threads=n))
        loop_ms = {k: [] for k in loops}
        for r in range(4):
            for name in list(loops)[::1 if r % 2 == 0 else -1]:
                mode, loop = loops[name]
                tr, st, wins = ready[mode]
                torch.cuda.synchronize()
                st, arrived = counted(
                    f"{name}, {FILE_STEPS} steps at B={bsz}", FILE_STEPS,
                    per_step, lambda: loop(tr, st, wins))
                torch.cuda.synchronize()
                loop_ms[name].append(
                    (time.perf_counter() - arrived) / FILE_STEPS * 1e3)
                ready[mode][1] = st
        print(f"windowed loop, {setting.model} at B={bsz}, ms/step from the "
              f"first window's arrival, 4 turns: " + "; ".join(
                  f"{k} " + ", ".join(f"{v:.3f}" for v in vs)
                  + f" (median {statistics.median(vs):.3f})"
                  for k, vs in loop_ms.items()) + f" [{card}]")
        del ready, file_batches

        # the stale-table check: the prefetch thread relearns the table
        # while windows packed with the first one wait in its queue
        args = cli.parse_args(CLI_FLAGSHIP + ["--wire-id-mode", "hot8"])
        trainer = cli.make_trainer(args)
        head = list(tsv(train_tsv).batches(bsz, 15))
        moved = [b._replace(
            sparse_ids=(b.sparse_ids + rows_pf // 2) % rows_pf) for b in head]
        versions, bad = [], 0

        def put(batches):
            dev = trainer.put_packed_window(batches)
            return dev, np.stack([b.sparse_ids for b in batches]), \
                trainer.wire.hot_version

        with WindowPrefetcher(iter(head + moved), put, 5, depth=2,
                              parse_ahead=False) as wins:
            for k, ((dev, ids, version), _) in enumerate(wins):
                if k == 0:
                    deadline = time.monotonic() + 120
                    while not (wins._inner._q.full()
                               and trainer.wire.hot_version >= 2):
                        if time.monotonic() > deadline:
                            fail("the prefetch thread did not relearn")
                        time.sleep(0.01)
                versions.append(version)
                bad += not np.array_equal(
                    trainer.wire.decode(dev)[1].cpu().numpy(), ids)
        print(f"stale-table check: {len(versions)} hot8 windows through "
              f"the prefetch thread, table versions {versions} (windows 2-3 "
              f"waited in its queue while it relearned), {bad} decoded off "
              f"their host ids")
        if bad or versions[:3] != [1, 1, 1] or versions[3] < 2:
            fail("a hot8 window packed before a relearn decodes wrongly")
        del trainer
    finally:
        Trainer.put_packed_window = put_window
        shutil.rmtree(tmp, ignore_errors=True)


def peak_mib(torch, fn) -> float:
    """Device memory ``fn()`` takes at its peak above what was allocated
    before it, MiB (``torch.cuda.max_memory_allocated``, reset first)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def ops_a_call(torch, fn, reps: int = LIB_PROFILE_REPS) -> float:
    """Device operations (kernels and copies) one ``fn()`` runs."""
    return len(profiled_sequence(torch, fn, reps)) / reps


def library_phase(torch, counted, card: str, dev, fc, data, table,
                  table_t, cpu_table, cpu_table_t) -> None:
    """Phase 11: the layer and loss library at B = 8,192 (module
    docstring), each module forward and backward on the card against the
    CPU from one set of weights."""
    import numpy as np
    from rec_now_tpu_torch import layers as L
    from rec_now_tpu_torch.losses import focal_crossentropy_loss
    from rec_now_tpu_torch.losses import listwise as lw
    from rec_now_tpu_torch.losses import listwise_blocked as lwb
    from rec_now_tpu_torch.losses import pairwise as pw
    from rec_now_tpu_torch.losses import pairwise_blocked as pwb
    from rec_now_tpu_torch.ops import hashing
    from rec_now_tpu_torch.ops import listwise_kernel as lk
    from torch.utils.checkpoint import checkpoint
    from rec_now_tpu_torch.rec_block import (DNNAttention,
                                             attention_by_dot_product)

    t_phase = time.perf_counter()
    batch = next(data.batches(8192, 1, seed=11))
    b = len(batch.labels)
    rng = np.random.RandomState(11)
    raw = torch.as_tensor(batch.sparse_ids)
    ids = {"cpu": fc.global_ids(raw)}
    ids[dev] = ids["cpu"].to(dev)
    emb = {dev: counted("phase 11 lookup, B=8192", 1, {"gather_rows": 1},
                        lambda: table.lookup(table_t, ids[dev])),
           "cpu": cpu_table.lookup(cpu_table_t, ids["cpu"])}
    compare("phase 11 lookup: card vs CPU", emb[dev].cpu(), emb["cpu"],
            rel=0.0)
    # a 50-long history per sample, looked up through the table (B11)
    hist_ids = ids["cpu"].repeat(1, 2)[:, :LIB_HISTORY]
    hist = {dev: counted("phase 11 history lookup, B=8192 x 50", 1,
                         {"gather_rows": 1},
                         lambda: table.lookup(table_t, hist_ids.to(dev))),
            "cpu": cpu_table.lookup(cpu_table_t, hist_ids)}

    def both(t):
        return {dev: t.to(dev), "cpu": t}

    logits = both(torch.as_tensor(rng.randn(b).astype(np.float32) * 2))
    labels = both(torch.as_tensor(batch.labels))
    groups = both(torch.as_tensor(batch.group_ids))
    mask = both(torch.as_tensor((rng.rand(b) > 0.1).astype(np.float32)))
    graded = both(torch.as_tensor(rng.randint(0, 4, b).astype(np.float32)))
    dense = both(torch.as_tensor(batch.dense))
    domain = both(torch.as_tensor(batch.domain_idx).to(torch.int64))
    print(f"phase 11: the layer and loss library, B = {b} "
          f"({len(torch.unique(groups['cpu']))} user groups) [{card}]")

    def grad_of(fn, x):
        """(value, d value / d x) of a scalar loss ``fn(x)``."""
        x = x.detach().requires_grad_()
        out = fn(x)
        value = out[0] if isinstance(out, tuple) else out
        g, = torch.autograd.grad(value, x)
        return out, g

    def timed(name, fn):
        ms = cuda_ms(torch, fn)
        ops = ops_a_call(torch, fn)
        print(f"  {name}: {ms:.4f} ms forward + backward (events, median "
              f"of 20), {ops:.1f} device operations a call [{card}]")
        return ms

    # -- losses ---------------------------------------------------------------
    route = {"pairwise": 0, "listwise": 0}
    orig_pair, orig_list = pwb.pairwise_loss_blocked, lwb.listwise_loss_blocked

    def pair_spy(*a, **k):
        route["pairwise"] += 1
        return orig_pair(*a, **k)

    def list_spy(*a, **k):
        route["listwise"] += 1
        return orig_list(*a, **k)

    pwb.pairwise_loss_blocked, lwb.listwise_loss_blocked = pair_spy, list_spy
    try:
        # (a) blocked BPR, power -0.5, mask, against the kernel path
        def blocked_bpr(d):
            return lambda x: pwb.pairwise_loss_blocked(
                x, labels[d], groups[d], click_occurance_power=-0.5,
                mask=mask[d], return_num_pair=True)

        def kernel_bpr(x):
            return pw.pairwise_loss(x, labels[dev], groups[dev],
                                    click_occurance_power=-0.5,
                                    mask=mask[dev], return_num_pair=True)

        (bl, bn), bg = counted("phase 11 pairwise_loss_blocked (card)", 1,
                               {}, lambda: grad_of(blocked_bpr(dev),
                                                   logits[dev]))
        (kl, kn), kg = counted("phase 11 pairwise_loss, kernel path", 1,
                               {"pair_loss_sum": 1},
                               lambda: grad_of(kernel_bpr, logits[dev]))
        (cl, cn), cg = grad_of(blocked_bpr("cpu"), logits["cpu"])
        if not float(bn) == float(kn) == float(cn) > 0:
            fail(f"blocked BPR pair count {float(bn)}, kernel {float(kn)}, "
                 f"CPU {float(cn)}")
        print(f"  blocked BPR: {int(float(bn))} pairs, loss card "
              f"{float(bl.detach()):.7f} kernel {float(kl.detach()):.7f} "
              f"cpu {float(cl.detach()):.7f}")
        compare("blocked BPR vs B3 (general entry): loss", bl.detach().cpu(),
                kl.detach().cpu(), 0.0, rel=LIB_LOSS_TOL)
        compare("blocked BPR vs B3: dlogits", bg.cpu(), kg.cpu(), 0.0)
        compare("blocked BPR card vs CPU: loss", bl.detach().cpu(),
                cl.detach(), 0.0, rel=LIB_LOSS_TOL)
        compare("blocked BPR card vs CPU: dlogits", bg.cpu(), cg, 0.0)
        blocked_ms = timed("pairwise_loss_blocked (BPR, power -0.5, mask)",
                           lambda: grad_of(blocked_bpr(dev), logits[dev]))
        kernel_ms = timed("pairwise_loss kernel path (B3 general entry)",
                          lambda: grad_of(kernel_bpr, logits[dev]))
        print(f"  blocked / kernel: {blocked_ms / kernel_ms:.1f}x")
        # the same loss with torch.utils.checkpoint a block in place of
        # the hand-written backward (bpr_loss_func as a custom tile-
        # contract pair loss): the same numbers, its ms and peak memory
        def ckpt_bpr(x):
            return pwb.pairwise_loss_blocked(
                x, labels[dev], groups[dev], click_occurance_power=-0.5,
                mask=mask[dev], return_num_pair=True,
                pairloss_func=pw.bpr_loss_func)

        (ql, qn), qg = grad_of(ckpt_bpr, logits[dev])
        if float(qn) != float(bn):
            fail(f"checkpointed BPR pair count {float(qn)} != {float(bn)}")
        compare("blocked BPR, Function vs checkpoint: loss",
                bl.detach().cpu(), ql.detach().cpu(), 0.0, rel=LIB_LOSS_TOL)
        compare("blocked BPR, Function vs checkpoint: dlogits", bg.cpu(),
                qg.cpu(), 0.0)
        fn_mib = peak_mib(torch, lambda: grad_of(blocked_bpr(dev),
                                                 logits[dev]))
        ck_mib = peak_mib(torch, lambda: grad_of(ckpt_bpr, logits[dev]))
        ck_ms = timed("pairwise_loss_blocked (BPR) through checkpoint",
                      lambda: grad_of(ckpt_bpr, logits[dev]))
        print(f"  blocked BPR backward: Function {blocked_ms:.4f} ms "
              f"{fn_mib:.1f} MiB, checkpoint {ck_ms:.4f} ms {ck_mib:.1f} "
              f"MiB peak, forward + backward [{card}]")

        # (b) blocked listwise against B6
        def blocked_lw(d):
            return lambda x: lwb.listwise_loss_blocked(groups[d], labels[d],
                                                       x)

        def kernel_lw(x):
            s, c = lw.listwise_loss_sum(x, labels[dev], groups[dev])
            return s / c

        bl, bg = counted("phase 11 listwise_loss_blocked (card)", 1, {},
                         lambda: grad_of(blocked_lw(dev), logits[dev]))
        kl, kg = counted("phase 11 listwise_loss_sum / count (B6)", 1,
                         {"listwise_loss_sum": 1},
                         lambda: grad_of(kernel_lw, logits[dev]))
        cl, cg = grad_of(blocked_lw("cpu"), logits["cpu"])
        compare("blocked listwise vs B6: loss", bl.detach().cpu(),
                kl.detach().cpu(), 0.0, rel=LIB_LOSS_TOL)
        compare("blocked listwise vs B6: dlogits", bg.cpu(), kg.cpu(), 0.0)
        compare("blocked listwise card vs CPU: loss", bl.detach().cpu(),
                cl.detach(), 0.0, rel=LIB_LOSS_TOL)
        compare("blocked listwise card vs CPU: dlogits", bg.cpu(), cg, 0.0)
        fn_ms = timed("listwise_loss_blocked", lambda: grad_of(
            blocked_lw(dev), logits[dev]))

        # the same loss with torch.utils.checkpoint a block in place of
        # the hand-written backward: the same numbers, its ms and peak
        def ckpt_lw(x):
            def tile(x, i0, r):
                valid, _, y, z = lwb.listwise_block(
                    groups[dev], labels[dev], x, i0, r, lk.POS_NEG_TH,
                    lk.MASKED_LOGIT)
                vf = valid.to(x.dtype)
                rows = -(y * torch.log_softmax(z, dim=1)).sum(dim=1)
                return torch.stack(((rows * vf).sum(), vf.sum()))
            tot = sum(checkpoint(tile, x, i0, r, use_reentrant=False)
                      for i0, r in pwb.row_blocks(b, 1024))
            return tot[0] / tot[1].detach().clamp_min(1.0)

        ql, qg = grad_of(ckpt_lw, logits[dev])
        compare("blocked listwise, Function vs checkpoint: loss",
                bl.detach().cpu(), ql.detach().cpu(), 0.0, rel=LIB_LOSS_TOL)
        compare("blocked listwise, Function vs checkpoint: dlogits",
                bg.cpu(), qg.cpu(), 0.0)
        fn_mib = peak_mib(torch, lambda: grad_of(blocked_lw(dev),
                                                 logits[dev]))
        ck_mib = peak_mib(torch, lambda: grad_of(ckpt_lw, logits[dev]))
        ck_ms = timed("listwise blocked through checkpoint",
                      lambda: grad_of(ckpt_lw, logits[dev]))
        print(f"  blocked listwise backward: Function {fn_ms:.4f} ms "
              f"{fn_mib:.1f} MiB, checkpoint {ck_ms:.4f} ms {ck_mib:.1f} "
              f"MiB peak, forward + backward [{card}]")
        timed("listwise_loss_sum / count (B6)",
              lambda: grad_of(kernel_lw, logits[dev]))

        # (c) a weight function on graded labels with a custom pair loss:
        # the blocked route, against the dense form on the card and the CPU
        def weight(li, lj):
            return li - lj

        def hinge(pos, neg, weights=None, pair_mask=None, reduce_mean=True):
            per = torch.clamp_min(1.0 - (pos - neg), 0.0)
            if weights is not None:
                per = per * weights
            m = pair_mask.to(per.dtype)
            total = (per * m).sum()
            return total / (m.sum() + 1e-10) if reduce_mean else total
        hinge.blocked_capable = True

        def weighted(d):
            return lambda x: pw.pairwise_loss(
                x, graded[d], groups[d], pairloss_func=hinge,
                label_pair_to_weight_func=weight, return_num_pair=True)

        route["pairwise"] = 0
        (wl, wn), wg = counted("phase 11 weighted custom pairwise_loss "
                               "(card)", 1, {},
                               lambda: grad_of(weighted(dev), logits[dev]))
        if route["pairwise"] != 1:
            fail(f"the weighted custom pair loss took the blocked route "
                 f"{route['pairwise']} times, expected 1")
        print("  weighted custom pair loss: the blocked route, 1 call "
              "(counted)")
        (cl, cn), cg = grad_of(weighted("cpu"), logits["cpu"])
        saved = pw.BLOCKED_MIN_BATCH
        pw.BLOCKED_MIN_BATCH = 1 << 40        # the dense (B, B) form
        try:
            (dl, dn), dg = grad_of(weighted(dev), logits[dev])
            dense_mib = peak_mib(torch, lambda: grad_of(weighted(dev),
                                                        logits[dev]))
            dense_ms = timed("weighted custom pair loss, dense (B, B)",
                             lambda: grad_of(weighted(dev), logits[dev]))
        finally:
            pw.BLOCKED_MIN_BATCH = saved
        if not float(wn) == float(dn) == float(cn) > 0:
            fail(f"weighted pair count blocked {float(wn)}, dense "
                 f"{float(dn)}, CPU {float(cn)}")
        compare("weighted custom pair loss, blocked vs dense: loss",
                wl.detach().cpu(), dl.detach().cpu(), 0.0, rel=LIB_LOSS_TOL)
        compare("weighted custom pair loss, blocked vs dense: dlogits",
                wg.cpu(), dg.cpu(), 0.0)
        compare("weighted custom pair loss, card vs CPU: loss",
                wl.detach().cpu(), cl.detach(), 0.0, rel=LIB_LOSS_TOL)
        compare("weighted custom pair loss, card vs CPU: dlogits", wg.cpu(),
                cg, 0.0)
        blocked_mib = peak_mib(torch, lambda: grad_of(weighted(dev),
                                                      logits[dev]))
        blocked_ms = timed("weighted custom pair loss, blocked",
                           lambda: grad_of(weighted(dev), logits[dev]))
        print(f"  weighted custom pair loss peak memory, forward + backward:"
              f" blocked {blocked_mib:.1f} MiB, dense {dense_mib:.1f} MiB "
              f"({blocked_mib / dense_mib:.3f}); ms blocked "
              f"{blocked_ms:.4f} dense {dense_ms:.4f} [{card}]")
        if not blocked_mib < dense_mib:
            fail("the blocked weighted pair loss is not below the dense "
                 "form's peak memory")

        # (d) listwise_loss at mask value -1e4: blocked against dense
        def masked_lw(d):
            return lambda x: lw.listwise_loss(groups[d], labels[d], x,
                                              value_of_masked_logit=-1e4)

        route["listwise"] = 0
        bl, bg = counted("phase 11 listwise_loss(-1e4) (card)", 1, {},
                         lambda: grad_of(masked_lw(dev), logits[dev]))
        if route["listwise"] != 1:
            fail("listwise_loss at -1e4 did not take the blocked route")
        cl, cg = grad_of(masked_lw("cpu"), logits["cpu"])
        pw.BLOCKED_MIN_BATCH = 1 << 40
        try:
            dl, dg = grad_of(masked_lw(dev), logits[dev])
            dense_mib = peak_mib(torch, lambda: grad_of(masked_lw(dev),
                                                        logits[dev]))
            dense_ms = timed("listwise_loss(-1e4), dense (B, B)",
                             lambda: grad_of(masked_lw(dev), logits[dev]))
        finally:
            pw.BLOCKED_MIN_BATCH = saved
        compare("listwise_loss(-1e4), blocked vs dense: loss",
                bl.detach().cpu(), dl.detach().cpu(), 0.0, rel=LIB_LOSS_TOL)
        compare("listwise_loss(-1e4), blocked vs dense: dlogits", bg.cpu(),
                dg.cpu(), 0.0)
        compare("listwise_loss(-1e4), card vs CPU: loss", bl.detach().cpu(),
                cl.detach(), 0.0, rel=LIB_LOSS_TOL)
        compare("listwise_loss(-1e4), card vs CPU: dlogits", bg.cpu(), cg,
                0.0)
        blocked_mib = peak_mib(torch, lambda: grad_of(masked_lw(dev),
                                                      logits[dev]))
        blocked_ms = timed("listwise_loss(-1e4), blocked",
                           lambda: grad_of(masked_lw(dev), logits[dev]))
        print(f"  listwise_loss(-1e4) peak memory, forward + backward: "
              f"blocked {blocked_mib:.1f} MiB, dense {dense_mib:.1f} MiB "
              f"({blocked_mib / dense_mib:.3f}); ms blocked "
              f"{blocked_ms:.4f} dense {dense_ms:.4f} [{card}]")
        if not blocked_mib < dense_mib:
            fail("the blocked listwise loss is not below the dense form's "
                 "peak memory")

        # (d') listwise_loss at threshold 0.3 on labels of {0, 1/3, 2/3, 1}
        # (a third is above 0.3, below the default): B6 once, with that
        # threshold, the blocked form never; against the CPU
        def th_lw(d):
            return lambda x: lw.listwise_loss(groups[d], graded[d] / 3.0, x,
                                              pos_neg_th=0.3)

        route["listwise"] = 0
        tl, tg = counted("phase 11 listwise_loss(pos_neg_th=0.3) (card)", 1,
                         {"listwise_loss_sum": 1},
                         lambda: grad_of(th_lw(dev), logits[dev]))
        if route["listwise"]:
            fail("listwise_loss at threshold 0.3 took the blocked form")
        cl, cg = grad_of(th_lw("cpu"), logits["cpu"])
        print(f"  listwise_loss(pos_neg_th=0.3): B6, loss card "
              f"{float(tl.detach()):.7f} cpu {float(cl.detach()):.7f}")
        compare("listwise_loss(pos_neg_th=0.3), card vs CPU: loss",
                tl.detach().cpu(), cl.detach(), 0.0, rel=LIB_LOSS_TOL)
        compare("listwise_loss(pos_neg_th=0.3), card vs CPU: dlogits",
                tg.cpu(), cg, 0.0)

        # (e) the trainer's default call: B3 once, the blocked form never
        route["pairwise"] = 0
        counted("phase 11 the trainer's pairwise call", 1,
                {"pair_loss_sum": 1},
                lambda: grad_of(lambda x: pw.pairwise_loss(
                    x, labels[dev], groups[dev], click_occurance_power=-0.5,
                    return_num_pair=True, reduce_mean=False,
                    binary_labels=True), logits[dev]))
        if route["pairwise"]:
            fail("the trainer's pairwise call took the blocked form")
    finally:
        pwb.pairwise_loss_blocked = orig_pair
        lwb.listwise_loss_blocked = orig_list

    # (f) the focal loss on the batch's logits
    def focal(d):
        return lambda x: focal_crossentropy_loss(labels[d], x)

    fl, fg = counted("phase 11 focal loss (card)", 1, {},
                     lambda: grad_of(focal(dev), logits[dev]))
    cl, cg = grad_of(focal("cpu"), logits["cpu"])
    compare("focal loss card vs CPU", fl.detach().cpu(), cl.detach(), 0.0,
            rel=LIB_LOSS_TOL)
    compare("focal loss card vs CPU: dlogits", fg.cpu(), cg, 0.0)
    timed("focal_crossentropy_loss", lambda: grad_of(focal(dev),
                                                     logits[dev]))

    # -- hashing --------------------------------------------------------------
    def hashes(d):
        return (hashing.salted_hash(ids[d], 7, 2 ** 20),
                hashing.combine_hash(ids[d], ids[d].flip(1)))

    got = counted("phase 11 salted_hash / combine_hash (card)", 1, {},
                  lambda: hashes(dev))
    for name, a, c in zip(("salted_hash", "combine_hash"), got,
                          hashes("cpu")):
        if not torch.equal(a.cpu(), c):
            fail(f"{name} on the card differs from the CPU")
        print(f"  {name} on {ids['cpu'].numel()} ids: card = CPU bit for "
              f"bit")
    ms = cuda_ms(torch, lambda: hashes(dev))
    print(f"  salted_hash + combine_hash: {ms:.4f} ms (events) [{card}]")

    # -- modules, forward and backward, card vs CPU ---------------------------
    def check(name, make, args, call):
        """``make(device)`` -> the module (one seed: the same weights on
        both), ``args[device]`` its inputs (float ones take a gradient),
        ``call(module, *args)`` -> one tensor."""
        res = {}
        for d in (dev, "cpu"):
            m = make(d)
            xs = [a.detach().requires_grad_() if a.is_floating_point()
                  else a for a in args[d]]
            diff = list(m.parameters()) + [x for x in xs
                                           if x.requires_grad]

            cts = []

            def run():
                out = call(m, *xs)
                if not out.is_floating_point():
                    return out, []
                if not cts:
                    # random weights, made once: a ramp's sorted signs
                    # made long cancelling sums, whose f32 rounding on the
                    # CPU reached 9.7e-4 of scale where a hot scene's rows
                    # add up
                    cts.append(torch.randn(
                        out.shape, generator=torch.Generator().manual_seed(
                            7)).to(out.device))
                return out, list(torch.autograd.grad(
                    (out * cts[0]).sum(), diff))

            res[d] = (counted(f"phase 11 {name} (card)", 1, {}, run)
                      if d == dev else run())
            if d == dev:
                timed(name, run)
        (out, grads), (want, wgrads) = res[dev], res["cpu"]
        if not torch.isfinite(want.float()).all() or \
                out.shape != want.shape:
            fail(f"{name}: output {tuple(out.shape)} not finite or not "
                 f"{tuple(want.shape)}")
        if out.is_floating_point():
            compare(f"{name}: output", out.detach().cpu(), want.detach())
        elif not torch.equal(out.cpu(), want):
            fail(f"{name}: card differs from the CPU")
        for i, (g, w) in enumerate(zip(grads, wgrads)):
            compare(f"{name}: gradient {i}", g.cpu(), w, 0.0, rel=1e-3)

    def seeded(ctor):
        return lambda d: ctor(torch.Generator().manual_seed(5), d)

    # the hash-trick path: a cross of fields 0 and 1 and a (B, 3) slice of
    # fields 2-4 (the most common id of field 2 invalid) into a 2^21-row
    # shared table
    invalid = int(torch.mode(ids["cpu"][:, 2]).values)
    cross_in = {d: [ids[d][:, 0], ids[d][:, 1], ids[d][:, 2:5]]
                for d in (dev, "cpu")}

    def crossed(m, x0, x1, x2):
        c = m[0]([x0, x1, x2], invalid_value_list=[None, None, invalid],
                 default_result_id=0)
        return m[1].get_pooling(c)

    check("CartesianProductLayer -> FastMultiHashLayer(2^20, 16, 2)",
          seeded(lambda g, d: torch.nn.ModuleList([
              L.CartesianProductLayer(device=d),
              L.FastMultiHashLayer(2 ** 20, 16, 2, generator=g,
                                   device=d)])),
          cross_in, crossed)
    check("MultiHashLayer(2^20, 16, 2).get_pooling, 26 fields",
          seeded(lambda g, d: L.MultiHashLayer(2 ** 20, 16, 2, generator=g,
                                               device=d)),
          {d: [ids[d]] for d in (dev, "cpu")},
          lambda m, x: m.get_pooling(x))

    concat = {d: [torch.cat([emb[d].reshape(b, -1), dense[d]], 1)]
              for d in (dev, "cpu")}
    check("DCNLayer(3) on (B, 429)",
          seeded(lambda g, d: L.DCNLayer(429, 3, g, device=d)), concat,
          lambda m, x: m(x))
    chain = {i: [j for j in (i - 1, i + 1) if 0 <= j < fc.num_sparse]
             for i in range(fc.num_sparse)}
    for share in (True, False):
        check(f"SparseGNNLayer, chain of 26, 2 layers, shared={share}",
              lambda d, share=share: L.SparseGNNLayer(
                  range(fc.num_sparse), chain, num_layers=2,
                  share_weights_between_layers=share, device=d),
              {d: [emb[d]] for d in (dev, "cpu")}, lambda m, x: m(x))
    units, scenes = 32, LIB_SCENES
    size = L.StarDenseLayer.get_starnet_param_size(64, units)
    star_in = {}
    for d in (dev, "cpu"):
        gen = torch.Generator().manual_seed(6)
        p1 = 1.0 + 0.1 * torch.randn(scenes, size, generator=gen)
        p2 = 1.0 + 0.1 * torch.randn(scenes, size, generator=gen)
        star_in[d] = [emb[d][:, :4].reshape(b, 64), p1.to(d), p2.to(d),
                      (ids[d][:, 5] % scenes)]
    check(f"StarDenseLayer({units}), two star nets by scene id",
          seeded(lambda g, d: L.StarDenseLayer(64, units, g, device=d)),
          star_in, lambda m, x, p1, p2, s: m(x, [p1[s], p2[s]]))
    check(f"StackedDenseLayer({units}), two nets by scene id",
          seeded(lambda g, d: L.StackedDenseLayer(64, units, g, device=d)),
          {d: [a if i in (0, 3) else a - 1.0
               for i, a in enumerate(star_in[d])] for d in (dev, "cpu")},
          lambda m, x, p1, p2, s: m(x, [p1[s], p2[s]], 0.5))
    check(f"ParasiticStackedDenseLayer({units}), 4 domains per sample",
          seeded(lambda g, d: L.ParasiticStackedDenseLayer(
              64, units, 4, g, device=d)),
          {d: [star_in[d][0], domain[d]] for d in (dev, "cpu")},
          lambda m, x, dom: m(x, dom))
    half = fc.num_sparse // 2
    check("SENETLayer list path, 13 fields of 16 and 13 of 8",
          seeded(lambda g, d: L.SENETLayer(fc.num_sparse, 0.5, g, device=d)),
          {d: [emb[d]] for d in (dev, "cpu")},
          lambda m, e: m([e[:, i] for i in range(half)]
                         + [e[:, i, :8] for i in range(half, 2 * half)]))
    for length in (64, 32):
        check(f"FixLengthLayer({length}) on a (B, 50) history",
              lambda d, n=length: L.FixLengthLayer(n, device=d),
              {d: [hist_ids.to(d)] for d in (dev, "cpu")},
              lambda m, h: m(h))
    hist_mask = both(torch.as_tensor(rng.rand(b, LIB_HISTORY) > 0.2))
    att_in = {d: [hist[d], emb[d][:, 8], hist_mask[d]] for d in (dev, "cpu")}
    check("attention_by_dot_product over (B, 50, 16)",
          lambda d: torch.nn.Module(), att_in,
          lambda m, u, doc, msk: torch.cat(attention_by_dot_product(
              u * msk[..., None], doc), dim=1))
    check("DNNAttention((64, 32)) over (B, 50, 16), masked",
          seeded(lambda g, d: DNNAttention(16, (64, 32), g, device=d)),
          att_in, lambda m, u, doc, msk: torch.cat(m(u, doc, msk), dim=1))
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s [{card}]")


def slot_phase(torch, counted, card: str, dev, fc, data, table, table_t,
               cpu_table, cpu_table_t, batch_size: int = 8192) -> None:
    """Phase 12: the slot and segment embedding utilities on the table's
    ``embedding_func`` and the table's leftovers (module docstring), card
    against CPU, each call timed with its device operations."""
    import numpy as np
    from rec_now_tpu_torch.embedding.sharded import ShardedEmbeddingTable
    from rec_now_tpu_torch.rec_block import embedding_util as eu
    from rec_now_tpu_torch.serving import export_table_rows

    t_phase = time.perf_counter()
    batch = next(data.batches(batch_size, 1, seed=12))
    b, f = batch.sparse_ids.shape
    v = table_t.shape[0]
    rng = np.random.RandomState(12)
    # the (slot, id, weight) triples: fields 0-25 one global id each, the
    # history slot, the multi-valued slot (0-20 ids, then slot -1 pads)
    fields = fc.global_ids(torch.as_tensor(batch.sparse_ids)).numpy()
    # history place j: a global id of field j % 26, drawn as the batch
    # draws that field's ids (SyntheticCriteo's zipf): a hot row takes
    # ~6,000 adds of the batch's gradient
    hist = (rng.zipf(data.zipf_a, (b, SLOT_HISTORY)) % fc.rows_per_field
            + np.arange(SLOT_HISTORY) % f * fc.rows_per_field)
    count = rng.randint(0, SLOT_MULTI + 1, b)
    multi_ids = rng.randint(0, v, (b, SLOT_MULTI))
    pad = np.arange(SLOT_MULTI)[None, :] >= count[:, None]
    multi_slots = np.where(pad, -1, f + 1)
    slots = np.concatenate([np.broadcast_to(np.arange(f), (b, f)),
                            np.full((b, SLOT_HISTORY), f), multi_slots], 1)
    ids = np.concatenate([fields, hist, np.where(pad, 0, multi_ids)], 1)
    weights = rng.rand(*ids.shape).astype(np.float32)
    c = ids.shape[1]
    trip = {"cpu": [torch.as_tensor(a) for a in (slots, ids, weights)]}
    trip[dev] = [a.to(dev) for a in trip["cpu"]]
    targets = list(range(f + 1))               # the fields and the history
    print(f"phase 12: slot features, B = {b}, C = {c} columns ({b * c} ids:"
          f" {f} fields, a {SLOT_HISTORY}-long zipf history, 0-"
          f"{SLOT_MULTI} multi-valued ids a row, {int(pad.sum())} pads), "
          f"{len(targets)} pooled target slots, on the {v} x "
          f"{table_t.shape[1]} table [{card}]")
    tables = {dev: (table, table_t), "cpu": (cpu_table, cpu_table_t)}

    def timed(name, fn, reps=20):
        """ms by events; device operations and ms a call, B11's share and
        the three largest kernels by ``torch.profiler`` over ``reps``."""
        ms = cuda_ms(torch, fn)
        seq = profiled_sequence(torch, fn, reps)
        by_name = {}
        for n, t in seq:
            by_name[n] = by_name.get(n, 0.0) + t / reps
        total = sum(by_name.values())
        b11 = [t for n, t in seq if "gather4_kernel" in n
               or "gather1_kernel" in n]
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
        # the tracer can lose some of a window's launches (a one-launch
        # call has read 0.6 a call): B11's time is also given a launch
        b11_each = (f", {sum(b11) / len(b11):.4f} ms a launch" if b11
                    else "")
        print(f"  {name}: {ms:.4f} ms (events, median of 20), "
              f"{len(seq) / reps:.1f} device operations a call, device "
              f"{total:.4f} ms, B11 {sum(b11) / reps / max(total, 1e-12):.1%}"
              f" of it{b11_each}; largest: " + ", ".join(
                  f"{kernel_name(n)} {t:.4f}" for n, t in top) + f" [{card}]")
        return ms

    def slot_calls(d, leaves):
        """Every utility on device ``d``'s triples through its table's
        embedding_func, the looked-up rows made leaves (the trainer's
        ``requires_grad_()``); returns the outputs by name."""
        tbl, rows = tables[d]
        inner = tbl.embedding_func(rows)

        def func(i):
            e = inner(i)
            if leaves is not None:
                e.requires_grad_()
                leaves.append(e)
            return e
        s, i, w = trip[d]
        out = {}
        for method in ("sum", "mean"):
            out[f"pooled {method}"] = eu.embedding_using_batch_segment_ids(
                func, s, targets, i, w, method=method)
        out["history padded"] = eu.embedding_single_slot(
            func, s, f, i, w, ncols=SLOT_HISTORY)
        out["multi padded"] = eu.embedding_single_slot(
            func, s, f + 1, i, w, default_weight=1.0, ncols=SLOT_MULTI_COLS)
        out["pool_slots"] = eu.pool_slots(s, targets + [f + 1], i, w,
                                          method="mean",
                                          drop_duplicate_slot=True)
        out["fetch_single_slot"] = eu.fetch_single_slot(
            s, f + 1, i, w, default_id=-1, ncols=SLOT_MULTI_COLS)
        return out

    # one embedding_func call each: pooled x 2, padded x 2
    res = {d: counted(f"phase 12 slot utilities ({d})", 4,
                      {"gather_rows": 1}, lambda d=d: slot_calls(d, None))
           if d == dev else slot_calls(d, None) for d in (dev, "cpu")}
    for name, want in res["cpu"].items():
        got = res[dev][name]
        got, want = ((got, want) if isinstance(want, tuple)
                     else ((got,), (want,)))
        for k, (a, w) in enumerate(zip(got, want)):
            if w is None:
                continue
            if not torch.isfinite(w.float()).all():
                fail(f"phase 12 {name} [{k}] is not finite on the CPU")
            if w.is_floating_point():
                compare(f"phase 12 {name} [{k}], card vs CPU", a.cpu(), w)
            elif not torch.equal(a.cpu(), w):
                fail(f"phase 12 {name} [{k}]: card differs from the CPU")
            else:
                print(f"  phase 12 {name} [{k}]: shape {tuple(a.shape)} "
                      f"{a.dtype}, card = CPU exactly")
    pooled = res["cpu"]["pooled sum"]
    if tuple(pooled.shape) != (b, len(targets), table_t.shape[1]):
        fail(f"phase 12 pooled shape {tuple(pooled.shape)}")
    multi_hits = res["cpu"]["multi padded"][2]
    if not (multi_hits.sum(1).squeeze(-1)
            == torch.as_tensor(count).clamp_max(SLOT_MULTI_COLS)).all():
        fail("phase 12: the multi-valued slot's padded hits are not "
             "min(count, ncols)")
    print(f"  multi-valued slot: {int((count > SLOT_MULTI_COLS).sum())} "
          f"rows cut off at ncols = {SLOT_MULTI_COLS}")

    # -- the loss's gradient with respect to the looked-up rows -------------
    # normal weights on the outputs, as phase 3's B12 cases: a sum of
    # terms of both signs rounds within SUM_TOL of its summed |terms| in
    # any order (a same-signed sum of thousands, as a hot row's, by up to
    # ~2e-6 of it: seen on the card)
    cts = {}                          # device -> the weights on it

    def loss_grads(d):
        leaves = []
        out = slot_calls(d, leaves)
        if not cts:
            g = torch.Generator().manual_seed(12)
            cts["cpu"] = {}
            for name in ("pooled sum", "pooled mean", "history padded",
                         "multi padded"):
                first = out[name] if name.startswith("pooled") \
                    else out[name][0]
                cts["cpu"][name] = torch.randn(first.shape, generator=g)
        if d not in cts:
            cts[d] = {n: t.to(d) for n, t in cts["cpu"].items()}
        loss = sum((out[n] if n.startswith("pooled") else out[n][0]
                    * out[n][1]).mul(ct).sum() for n, ct in cts[d].items())
        return torch.autograd.grad(loss, leaves)

    grads = {dev: counted("phase 12 loss and its row gradients (card)", 4,
                          {"gather_rows": 1}, lambda: loss_grads(dev)),
             "cpu": loss_grads("cpu")}
    for k, (a, w) in enumerate(zip(grads[dev], grads["cpu"])):
        compare(f"phase 12 d loss / d rows, lookup {k}", a.cpu(), w, 0.0,
                rel=1e-3)
    # the four lookups share the (B, C) layout (an id outside a call's
    # slots reads row 0 with a zero gradient): their gradients summed are
    # the gradient of each place's id; the mask drops the padding
    flat_ids = {d: trip[d][1].reshape(-1) for d in (dev, "cpu")}
    valid = {d: (trip[d][0] != -1).reshape(-1) for d in (dev, "cpu")}
    row_g = {d: sum(grads[d]).detach() for d in (dev, "cpu")}
    print(f"  row gradients: {int(valid['cpu'].sum())} valid of "
          f"{flat_ids['cpu'].numel()}, max |g| "
          f"{float(row_g['cpu'].abs().max()):.3e}")

    # -- updates: card vs CPU ------------------------------------------------
    start = cpu_table_t
    ids_c, g_c, ok_c = flat_ids["cpu"], row_g["cpu"], valid["cpu"]
    # each element's summed gradient G and summed |g|: B12's limit on G is
    # SUM_TOL of the latter
    gsig = torch.zeros_like(start).index_add_(0, ids_c[ok_c], g_c[ok_c])
    gsum = torch.zeros_like(start).index_add_(0, ids_c[ok_c],
                                              g_c[ok_c].abs())
    touched = torch.unique(ids_c)
    print(f"  {touched.numel()} distinct rows looked up")

    def check_update(name, got, want, optimizer):
        """Touched rows against the CPU within SUM_TOL of each element's
        summed scale: its start and the most its terms add (each
        occurrence's Adagrad move at the initial accumulator 0.1; the
        moments' and accumulators' terms from the summed |gradient|, a
        square's twice, as a square's error is twice its root's); Adam's
        move at t = 1, lr * G / (|G| + eps), is monotone in the summed
        gradient G, so its scale also takes what G within B12's limit can
        move it by (a near-tie may flip).  Untouched rows as they were."""
        rows = touched.to(dev)
        g_abs, g_sig = gsum[touched], gsig[touched]
        scales = {"table": start[touched].abs()}
        if optimizer == "adagrad":        # both tables start at 0.1
            scales["table"] += UPDATE_LR / math.sqrt(0.1) * g_abs
            scales["accumulator"] = 0.1 + 2 * g_abs.square().mean(1)
        else:
            def move(g):
                return UPDATE_LR * g / (g.abs() + 1e-7)
            near = SUM_TOL * g_abs
            reach = torch.maximum((move(g_sig + near) - move(g_sig)).abs(),
                                  (move(g_sig - near) - move(g_sig)).abs())
            scales["table"] += UPDATE_LR + reach / SUM_TOL
            scales["m"] = 0.1 * g_abs
            scales["v"] = 2e-3 * g_abs.square()
        for k, sc in scales.items():
            sc = sc.clamp_min(1e-30)
            compare_sum(f"{name}: {k} (touched rows, over each element's "
                        f"summed scale)", getattr(got, k)[rows].cpu() / sc,
                        getattr(want, k)[touched] / sc, 1.0)
        moves = want.table[touched] - start[touched]
        visible(f"{name}: the touched rows' moves", moves / scales["table"],
                1.0, rel=SUM_TOL)
        untouched = torch.ones(v, dtype=torch.bool)
        untouched[touched] = False
        sample = torch.nonzero(untouched).reshape(-1)[::97]
        if not torch.equal(got.table[sample.to(dev)].cpu(), start[sample]):
            fail(f"{name}: an untouched row moved")
        print(f"    {name}: {int((moves != 0).any(1).sum())} of "
              f"{touched.numel()} touched rows moved")
        if optimizer == "adam":
            print(f"    {name}: {int((reach > UPDATE_LR).sum())} elements "
                  f"whose summed gradient B12's limit lets cross 0")

    upd = {}
    for d in (dev, "cpu"):
        tbl = tables[d][0]
        state = tbl.state_from(start.to(d).clone())
        run = functools.partial(tbl.apply_grads, state, flat_ids[d],
                                row_g[d], UPDATE_LR, valid_mask=valid[d])
        upd[d] = (counted("phase 12 EmbeddingTable.apply_grads (card)", 1,
                          {"scatter_add_rows": 2}, run)
                  if d == dev else run())
    check_update("EmbeddingTable.apply_grads, padding masked", upd[dev],
                 upd["cpu"], "adagrad")
    # the multi-valued slot's rows, by global id, from the updated state
    export = {d: functools.partial(export_table_rows, upd[d], tables[d][0],
                                   trip[d][1][:, f + 1:].reshape(-1))
              for d in (dev, "cpu")}
    got = counted("phase 12 export_table_rows (card)", 1,
                  {"gather_rows": 1}, export[dev])
    compare("phase 12 export_table_rows, card vs CPU", got.cpu(),
            export["cpu"](), rel=SUM_TOL)
    timing = {"export_table_rows": export[dev],
              "EmbeddingTable.apply_grads, padding masked":
                  functools.partial(tables[dev][0].apply_grads, upd[dev],
                                    flat_ids[dev], row_g[dev], UPDATE_LR,
                                    valid_mask=valid[dev])}
    del upd, export

    # the sharded table: Adagrad per occurrence and deduped with the mask,
    # in both update modes; lazy Adam with the mask, both modes
    sharded_runs = (
        ("adagrad", "dense", False, {"scatter_add_rows": 1}),
        ("adagrad", "sparse", False, {"scatter_add_rows": 1}),
        ("adagrad", "dense", True, {"scatter_add_rows": 1,
                                    "adagrad_dense_pass": 1}),
        ("adagrad", "sparse", True, {"scatter_add_rows": 2}),
        ("adam", "dense", True, {"scatter_add_rows": 1,
                                 "adam_dense_pass": 1}),
        ("adam", "sparse", True, {"gather_rows": 2, "scatter_add_rows": 4}))
    for opt, mode, dedup, launches in sharded_runs:
        name = (f"ShardedEmbeddingTable {opt} {mode}, valid_mask"
                + ("" if dedup else ", dedup=False"))
        got = {}
        for d in (dev, "cpu"):
            tbl = ShardedEmbeddingTable(v, table_t.shape[1], device=d,
                                        optimizer=opt, update_mode=mode)
            state = tbl.state_from(start.to(d).clone())
            run = functools.partial(tbl.apply_grads, state, flat_ids[d],
                                    row_g[d], UPDATE_LR, valid_mask=valid[d],
                                    dedup=dedup)
            got[d] = (counted(f"phase 12 {name} (card)", 1, launches, run)
                      if d == dev else run())
            if d == dev:
                timing[name] = run
        check_update(name, got[dev], got["cpu"], opt)
        del got
        torch.cuda.empty_cache()

    # -- times ---------------------------------------------------------------
    s, i, w = trip[dev]
    func = table.embedding_func(table_t)
    calls = {
        "embedding_func (B11), all ids": lambda: func(i.reshape(-1)),
        "embedding_using_batch_segment_ids, sum": lambda:
            eu.embedding_using_batch_segment_ids(func, s, targets, i, w),
        "embedding_using_batch_segment_ids, mean": lambda:
            eu.embedding_using_batch_segment_ids(func, s, targets, i, w,
                                                 method="mean"),
        f"embedding_single_slot, history (ncols={SLOT_HISTORY})": lambda:
            eu.embedding_single_slot(func, s, f, i, w, ncols=SLOT_HISTORY),
        f"embedding_single_slot, multi-valued (ncols={SLOT_MULTI_COLS})":
            lambda: eu.embedding_single_slot(func, s, f + 1, i, w,
                                             ncols=SLOT_MULTI_COLS),
        "pool_slots, mean, drop_duplicate_slot": lambda: eu.pool_slots(
            s, targets + [f + 1], i, w, method="mean",
            drop_duplicate_slot=True),
        "fetch_single_slot": lambda: eu.fetch_single_slot(
            s, f + 1, i, w, default_id=-1, ncols=SLOT_MULTI_COLS),
        "the loss's forward + backward (4 lookups)": lambda: loss_grads(dev)}
    calls.update(timing)
    for name, fn in calls.items():
        timed(name, fn)
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s [{card}]")


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from rec_now_tpu_torch.embedding.table import EmbeddingTable
    from rec_now_tpu_torch.layers.multi_dense_layer import MultiDenseLayer
    from rec_now_tpu_torch.losses import pairwise as pw_mod
    from rec_now_tpu_torch.losses.pairwise import pairwise_loss
    from rec_now_tpu_torch.models import (CANDCNModel, DCNv2Model,
                                          FeatureConfig, MultiTaskModel,
                                          XDeepFMModel)
    from rec_now_tpu_torch.ops import _build, cin_kernel as ck
    from rec_now_tpu_torch.ops import expand_kernel as expand_k
    from rec_now_tpu_torch.ops import gather_kernel as gather_k
    from rec_now_tpu_torch.ops import listwise_kernel as lk
    from rec_now_tpu_torch.ops import multi_dense_kernel as mk
    from rec_now_tpu_torch.ops import pairwise_kernel as pk
    from rec_now_tpu_torch.ops import table_update_kernel as tk
    from rec_now_tpu_torch.ops.cin_op import cin_contract_plain
    from rec_now_tpu_torch.serving import (ServingState, WireScorer,
                                           build_scorer)
    from rec_now_tpu_torch.embedding.sharded import ShardedEmbeddingTable
    from rec_now_tpu_torch.training import SyntheticCriteo, Trainer, \
        TrainerConfig

    t_start = time.perf_counter()
    card = smi()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(secs)} sources "
          f"at once")
    for name, sec in secs.items():
        print(f"  csrc/{name}.cu: {sec:.1f} s")
        log = _build.library_path(name).with_suffix(".log")
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "properties" in line:
                print(f"  ptxas {name}: {line.strip()}")
            if "C7520" in line:       # a wgmma serialized: ~3x its time
                fail(f"csrc/{name}.cu: ptxas serialized a wgmma: {line}")

    # -- 3. kernels vs plain --------------------------------------------------
    gen = torch.Generator().manual_seed(1234)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def glorot(k, f, h):
        return rand(k, f, h, scale=(2.0 / (f * h + k)) ** 0.5)

    B, D, F, KS = 8192, 16, 26, (64, 64)
    M = B * D
    kern = {}

    print("cin_stack_sum vs plain:")
    x0 = rand(M, F)
    ws = [glorot(KS[0], F, F), glorot(KS[1], F, KS[0])]
    err = 0.0
    for oi in (True, False):
        err = max(err, compare(f"M={M} Ks={KS} output_input={oi}",
                               ck.cin_stack_sum(x0, ws, oi),
                               ck.cin_stack_sum_plain(x0, ws, oi)))
    # the other paths at config 3: 64-row blocks, layer by layer
    for rows in (64, -1):
        err = max(err, compare(f"M={M} Ks={KS} {STACK_PATHS[rows]}",
                               ck._stack_fwd_cuda(x0, ws, True, rows),
                               ck.cin_stack_sum_plain(x0, ws)))
    xr = rand(12345, F)
    # ragged stacks; an odd F; the widest F + 2 h_max the f32 stack kernel
    # took (1,493), whose tiles fit no block: layer by layer
    for f, ks in ((F, (100, 37, 50)), (F, (5,)), (33, (40, 17)),
                  (27, (733, 5))):
        xs = xr if f == F else rand(12345, f)
        hs = (f,) + ks[:-1]
        wr = [glorot(k, f, h) for k, h in zip(ks, hs)]
        err = max(err, compare(f"ragged M=12345 F={f} Ks={ks}",
                               ck.cin_stack_sum(xs, wr),
                               ck.cin_stack_sum_plain(xs, wr)))
    least = cin_stack_fwd_parts(M, F, KS)
    nbytes = (M * F + M + sum(w.numel() for w in ws)) * 4
    t_ops, t_bytes = sum(least.values()), bound_ms(0, nbytes)[0]
    b_ms, b_by = max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")
    kern["cin_stack_sum"] = dict(
        name="cin_stack_sum", route="cuda",
        source="rec_now_tpu_torch/csrc/cin.cu",
        replaces=f"{CIN_TPU}:493", max_abs_err=err,
        ms=cuda_ms(torch, lambda: ck.cin_stack_sum(x0, ws)),
        plain_ms=cuda_ms(torch, lambda: ck.cin_stack_sum_plain(x0, ws)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    paths = {name: cuda_ms(torch, lambda: ck._stack_fwd_cuda(x0, ws, True,
                                                             rows))
             for rows, name in STACK_PATHS.items()}
    print(f"  B1 paths, Ks={KS}, ms by events: " + "; ".join(
        f"{name} {ms:.4f}" for name, ms in paths.items())
        + f"; bound {b_ms:.4f} [{card}]")
    reps = 20
    # two launches a call: layer 1 folded and Wc, then the stack
    split = kernel_split(
        profiled_sequence(torch, lambda: ck.cin_stack_sum(x0, ws), reps),
        reps, {"stack_prep_kernel": "prep", "cin_stack_tc_kernel": "stack"},
        "cin_stack_sum")
    print(f"  B1 split, Ks={KS}, device ms by torch.profiler: prep (fold, "
          f"Wc) {split['prep'] / reps:.4f}; stack kernel "
          f"{split['stack'] / reps:.4f} (bound {t_ops:.4f}: layers in split "
          f"TF32 {least['layers']:.4f}, collapse and sums in f32 "
          f"{least['collapse']:.4f}; {100 * t_ops * reps / split['stack']:.1f}"
          f"%) [{card}]")

    print("cin_flat vs plain:")
    err, t = 0.0, dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0,
                       nbytes=0)
    for h, k in ((F, KS[0]), (KS[0], KS[1])):
        prev = x0 if h == F else rand(M, h)
        w = glorot(k, F, h)
        err = max(err, compare(f"M={M} H={h} K={k}",
                               ck.cin_flat(x0, prev, w),
                               ck.cin_flat_plain(x0, prev, w)))
        ms = cuda_ms(torch, lambda: ck.cin_flat(x0, prev, w))
        lib = cuda_ms(
            torch, lambda: torch.einsum("mf,mh,kfh->mk", x0, prev, w))
        t["ms"] += ms
        t["plain_ms"] += cuda_ms(torch, lambda: ck.cin_flat_plain(x0, prev,
                                                                  w))
        t["library_ms"] += lib
        flops = cin_flops(M, F, h, k, prev is x0)
        nbytes = (M * F + (0 if prev is x0 else M * h) + k * F * h
                  + M * k) * 4
        t["flops"] += flops
        t["nbytes"] += nbytes
        # split TF32: three tensor-core products per multiply-add
        tc, f32 = (bound_ms(3 * flops, nbytes, PEAK_TF32_FLOPS)[0],
                   bound_ms(flops, nbytes)[0])
        print(f"  B2 layer H={h} K={k}: {ms:.4f} ms by events, bound "
              f"{tc:.4f} split TF32 ({100 * tc / ms:.1f}%), {f32:.4f} at "
              f"the f32 rate ({100 * f32 / ms:.1f}%); torch.einsum "
              f"{lib:.4f} [{card}]")
    pr = rand(12345, 37)
    w100 = glorot(100, F, 37)
    err = max(err, compare("ragged M=12345 H=37 K=100",
                           ck.cin_flat(xr, pr, w100),
                           ck.cin_flat_plain(xr, pr, w100)))
    b_ms, b_by = bound_ms(3 * t["flops"], t["nbytes"], PEAK_TF32_FLOPS)
    kern["cin_flat"] = dict(
        name="cin_flat", route="cuda", source="rec_now_tpu_torch/csrc/cin.cu",
        replaces=f"{CIN_TPU}:153", max_abs_err=err, ms=t["ms"],
        plain_ms=t["plain_ms"], bound_ms=b_ms, bound_by=b_by,
        library_ms=t["library_ms"])
    # xDeepFM's CIN (F = 39, three layers of 200, prev x0 at layer 1) at
    # B = 1,024 and 8,192 with D = 10: each layer against the float64
    # plain version, the three by events beside their split-TF32 bound
    for bx in (1024, 8192):
        mx, fx = bx * 10, 39
        xx = rand(mx, fx)
        prevs, wx, flops_x = [xx], [], 0
        for h in (fx, 200, 200):
            w = glorot(200, fx, h)
            got = ck.cin_flat(xx, prevs[-1], w)
            want = ck.cin_flat_plain(xx.double(), prevs[-1].double(),
                                     w.double())
            err = max(err, compare(f"xDeepFM M={mx} H={h} K=200 vs f64",
                                   got.double(), want))
            flops_x += cin_flops(mx, fx, h, 200, h == fx)
            wx.append(w)
            prevs.append(got)

        def three():
            for i, w in enumerate(wx):
                ck.cin_flat(xx, prevs[i], w)

        ms_x = cuda_ms(torch, three)
        tc = bound_ms(3 * flops_x, 0, PEAK_TF32_FLOPS)[0]
        print(f"  B2 xDeepFM B={bx} three layers: {ms_x:.4f} ms by events, "
              f"bound {tc:.4f} split TF32 ({100 * tc / ms_x:.1f}%), "
              f"{flops_x / 495e12 * 1e3:.4f} at one TF32 product "
              f"({100 * flops_x / 495e12 * 1e3 / ms_x:.1f}%) [{card}]")
    def einsum_grads(fn, inputs, g):
        """autograd through the einsum forward: the backward alone, the
        graph built once and kept."""
        leaves = [t.detach().requires_grad_() for t in inputs]
        out = fn(*leaves)
        return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)

    print("cin_stack_sum_bwd vs plain:")
    g = rand(M)
    err = 0.0
    for oi in (True, False):
        got = ck.cin_stack_sum_bwd(x0, ws, g, oi)
        want = ck.cin_stack_sum_bwd_plain(x0, ws, g, oi)
        err = max(err, compare_all(f"M={M} Ks={KS} output_input={oi}",
                                   [got[0]] + got[1], [want[0]] + want[1]))
    gr = rand(12345)
    for ks in ((100, 37, 50), (5,)):
        hs = (F,) + ks[:-1]
        wr = [glorot(k, F, h) for k, h in zip(ks, hs)]
        got = ck.cin_stack_sum_bwd(xr, wr, gr)
        want = ck.cin_stack_sum_bwd_plain(xr, wr, gr)
        err = max(err, compare_all(f"ragged M=12345 Ks={ks}",
                                   [got[0]] + got[1], [want[0]] + want[1]))
    nbytes = (2 * M * F + M + 2 * sum(w.numel() for w in ws[:-1])
              + ws[-1].numel() + F * KS[0]) * 4
    # each part's operations at the rate of the unit that runs them
    least = cin_stack_bwd_parts(M, F, KS)
    t_ops, t_bytes = sum(least.values()), bound_ms(0, nbytes)[0]
    b_ms, b_by = max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")
    kern["cin_stack_sum_bwd"] = dict(
        name="cin_stack_sum_bwd", route="cuda",
        source="rec_now_tpu_torch/csrc/cin.cu",
        replaces=f"{CIN_TPU}:534", max_abs_err=err,
        ms=cuda_ms(torch, lambda: ck.cin_stack_sum_bwd(x0, ws, g)),
        plain_ms=cuda_ms(torch,
                         lambda: ck.cin_stack_sum_bwd_plain(x0, ws, g)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(torch, einsum_grads(
            lambda a, *w: ck.cin_stack_sum_plain(a, w), [x0] + ws, g)))
    # its device split, each part beside its least work
    reps = 20
    seq = profiled_sequence(torch, lambda: ck.cin_stack_sum_bwd(x0, ws, g),
                            reps)
    split = b4_split(seq, len(KS) - 1, reps)
    print(f"  B4 split, Ks={KS}, device ms by torch.profiler: " + "; ".join(
        f"{what} {split[key] / reps:.4f} (bound {least[key]:.4f}"
        + (f", {100 * least[key] * reps / split[key]:.1f}%)"
           if split[key] else ", not measured)")
        for key, what in (("recompute", "recompute"),
                          ("rows", "row kernel"),
                          ("dw", "dW kernel + partial sums"),
                          ("collapsed", "collapsed layer, Wc and dWc")))
        + f"; total {sum(split.values()) / reps:.4f} [{card}]")

    print("cin_flat_bwd vs plain:")
    err, t = 0.0, dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0,
                       nbytes=0)
    h1 = ck.cin_flat(x0, x0, ws[0])
    for prev, w in ((x0, ws[0]), (h1, ws[1])):
        h, k = prev.shape[1], w.shape[0]
        gk = rand(M, k)
        err = max(err, compare_all(f"M={M} H={h} K={k}",
                                   ck.cin_flat_bwd(x0, prev, w, gk),
                                   ck.cin_flat_bwd_plain(x0, prev, w, gk)))
        t["ms"] += cuda_ms(torch, lambda: ck.cin_flat_bwd(x0, prev, w, gk))
        t["plain_ms"] += cuda_ms(
            torch, lambda: ck.cin_flat_bwd_plain(x0, prev, w, gk))
        t["library_ms"] += cuda_ms(torch, einsum_grads(
            lambda a, b, c: torch.einsum("mf,mh,kfh->mk", a, b, c),
            [x0, prev, w], gk))
        same = prev is x0
        t["flops"] += cin_flat_bwd_flops(M, F, h, k, same)
        io = M * F + (0 if same else M * h) + w.numel()   # read and written
        t["nbytes"] += (2 * io + M * k + (M * h if same else 0)) * 4
        # the device time of its two kernels, each beside its least work:
        # the row kernel A = g W and both epilogues, the weight gradient
        # (its partial sums included)
        by = profiled_by_name(torch, lambda: ck.cin_flat_bwd(x0, prev, w, gk))
        rows = sum(v for n, v in by.items() if "cin_bwd_rows" in n)
        terms = F * (F + 1) // 2 if same else F * h
        parts = (("row kernel", rows, 2 * M * k * F * h + 4 * M * F * h),
                 ("dW kernel + partial sums", sum(by.values()) - rows,
                  M * terms + 2 * M * k * terms))
        print(f"  B5 split, H={h} K={k}, device ms by torch.profiler: "
              + "; ".join(f"{what} {v:.4f} (bound {bound_ms(fl, 0)[0]:.4f}"
                          + (f", {100 * bound_ms(fl, 0)[0] / v:.1f}%)" if v
                             else ", not measured)")
                          for what, v, fl in parts) + f" [{card}]")
    g100 = rand(12345, 100)
    err = max(err, compare_all("ragged M=12345 H=37 K=100",
                               ck.cin_flat_bwd(xr, pr, w100, g100),
                               ck.cin_flat_bwd_plain(xr, pr, w100, g100)))
    b_ms, b_by = bound_ms(t["flops"], t["nbytes"])
    kern["cin_flat_bwd"] = dict(
        name="cin_flat_bwd", route="cuda",
        source="rec_now_tpu_torch/csrc/cin.cu", replaces=f"{CIN_TPU}:235",
        max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=b_ms,
        bound_by=b_by, library_ms=t["library_ms"])
    del h1

    print("pair_loss_sum vs plain:")
    data0 = SyntheticCriteo(seed=0)
    pb = next(data0.batches(8192, 1, seed=1))
    lab = torch.as_tensor(pb.labels, device=dev)
    grp = torch.as_tensor(pb.group_ids, device=dev)
    xl = rand(8192)
    _, inv = np.unique(pb.group_ids, return_inverse=True)
    sizes = np.bincount(inv)
    print(f"  B=8192: {len(sizes)} groups, the largest {sizes.max()}, "
          f"{int((sizes.astype(np.int64) ** 2).sum()):,} tests in groups, "
          f"{pair_ops(pb.labels, pb.group_ids):,} operations")
    err = 0.0
    cases = [(xl, lab, grp, -0.5)]
    rb = next(data0.batches(1000, 1, seed=2))
    cases.append((rand(1000), torch.as_tensor(rb.labels, device=dev),
                  torch.as_tensor(rb.group_ids, device=dev), 0.0))
    # the worst case for the sort path (one group: B^2 tests), the best
    # (singletons), and one past the one-block sort (the O(B^2) sweeps)
    one = torch.zeros(8192, dtype=torch.int32, device=dev)
    single = torch.arange(8192, dtype=torch.int32, device=dev)
    lab1 = torch.cat([lab, lab[:1]])
    one1 = torch.zeros(8193, dtype=torch.int32, device=dev)
    edge = {"one group": (xl, lab, one), "singletons": (xl, lab, single),
            "one group, B=8193 (O(B^2) sweeps)": (rand(8193), lab1, one1)}
    cases += [(*v, -0.5) for v in edge.values()]
    for xs, ls, gs, power in cases:
        got = pk.pair_loss_fused(xs, ls, gs, 1.0, power)
        want = pk.pair_loss_fused_plain(xs, ls, gs, 1.0, power)
        if float(got[1]) != float(want[1]):
            fail(f"pair count {float(got[1])} != {float(want[1])}")
        err = max(err, compare_all(f"B={len(xs)} power={power}", got, want))
        again = pk.pair_loss_fused(xs, ls, gs, 1.0, power)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"pair_loss_sum at B={len(xs)} is not bit-equal on a repeat")
    err_pair = err
    b_ms, b_by = bound_ms(pair_ops(pb.labels, pb.group_ids), 16 * 8192 + 8)
    kern["pair_loss_sum"] = dict(
        name="pair_loss_sum", route="cuda",
        source="rec_now_tpu_torch/csrc/pairwise.cu",
        replaces=f"{PAIR_TPU}:357", max_abs_err=err,
        ms=cuda_ms(torch, lambda: pk.pair_loss_fused(xl, lab, grp, 1.0,
                                                     -0.5)),
        plain_ms=cuda_ms(torch, lambda: pk.pair_loss_fused_plain(
            xl, lab, grp, 1.0, -0.5)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    print(f"  B3 batches, ms by events: SyntheticCriteo "
          f"{kern['pair_loss_sum']['ms']:.4f}; " + "; ".join(
              f"{what} {cuda_ms(torch, lambda: pk.pair_loss_fused(*v, 1.0, -0.5)):.4f}"
              for what, v in edge.items()) + f" [{card}]")
    # its device split on each batch (the one group's sort takes one pass,
    # the label test), the SyntheticCriteo batch's parts beside their
    # least work: the sort's compares and 5 a sample for the segments and
    # the occurrence weight (pair_ops); 12 a valid pair for the sweep, and
    # a sample's partials and its share of the sums (3) for the merge
    n_pairs = pair_ops(pb.labels, pb.group_ids) - sort_ops(8192) - 5 * 8192
    least = {"sort and segments": bound_ms(sort_ops(8192) + 5 * 8192,
                                           48 * 8192)[0],
             "sweep": bound_ms(n_pairs, 20 * 8192)[0],
             "merge": bound_ms(3 * 8192, 8 * 8192 + 8)[0]}
    reps = 20
    for what, v in (("SyntheticCriteo", (xl, lab, grp)),
                    ("one group", edge["one group"]),
                    ("singletons", edge["singletons"])):
        split = kernel_split(profiled_sequence(
            torch, lambda: pk.pair_loss_fused(*v, 1.0, -0.5), reps), reps,
            B3_PARTS, "pair_loss_sum")
        print(f"  B3 split, {what} B=8192, device ms by torch.profiler: "
              + "; ".join(f"{part} {split[part] / reps:.4f}"
                          + (f" (bound {least[part]:.6f})"
                             if what == "SyntheticCriteo" else "")
                          for part in least)
              + f"; total {sum(split.values()) / reps:.4f} [{card}]")

    print("adagrad_dense_pass vs plain:")
    err = 0.0
    for v, d in ((2_600_000, 16), (12345, 16), (1001, 8)):
        tb, ac = rand(v, d, scale=1e-3), rand(v).abs() * 0.1
        dg = rand(v, d) * (torch.rand(v, generator=gen) < 0.1).to(dev)[:, None]
        t2, a2 = tb.clone(), ac.clone()
        tk.adagrad_dense_pass(tb, ac, dg, 0.05)
        tk.adagrad_dense_pass_plain(t2, a2, dg, 0.05)
        err = max(err, compare(f"V={v} D={d} accumulators", ac, a2, 0.0),
                  compare(f"V={v} D={d} rows", tb, t2, 0.0))
    # per row: 2 D (squares, sum) + 2 D (scale x g, subtract) + 5 (mean,
    # add, max, sqrt, divide); bytes: table and g read, table written,
    # acc read and written
    v, d = 2_600_000, 16
    b_ms, b_by = bound_ms(v * (4 * d + 5), v * (3 * d + 2) * 4)
    tb, ac = rand(v, d, scale=1e-3), torch.full((v,), 0.1, device=dev)
    dg = rand(v, d)
    kern["adagrad_dense_pass"] = dict(
        name="adagrad_dense_pass", route="cuda",
        source="rec_now_tpu_torch/csrc/table_update.cu",
        replaces=f"{TABLE_TPU}:142", max_abs_err=err,
        ms=cuda_ms(torch, lambda: tk.adagrad_dense_pass(tb, ac, dg, 0.05)),
        plain_ms=cuda_ms(torch, lambda: tk.adagrad_dense_pass_plain(
            tb, ac, dg, 0.05)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    on_dev = profiled_ms(torch, lambda: tk.adagrad_dense_pass(tb, ac, dg,
                                                              0.05))
    print(f"  B9 V={v} D={d}: {kern['adagrad_dense_pass']['ms']:.4f} ms by "
          f"events, {on_dev:.4f} on the device (torch.profiler), bound "
          f"{b_ms:.4f} ({b_by}), {100 * b_ms / on_dev:.1f}% of the device "
          f"time [{card}]")
    print("multi_dense vs plain:")
    err = 0.0
    t = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, t_ops=0.0, t_bytes=0.0,
             flops=0, nbytes=0)
    for name, nx, n, d, u, relu, times in MD_BANKS:
        act = "relu" if relu else None
        x = rand(nx, B, d)
        w, bias = rand(n, d, u, scale=d ** -0.5), rand(n, 1, u)
        for bb in (bias, None):
            err = max(err, compare(
                f"{name} ({nx}, {B}, {d}) x ({n}, {d}, {u}) relu={relu} "
                f"bias={bb is not None}", mk.multi_dense_fused(x, w, bb, relu),
                mk.multi_dense_xla(x, w, bb, act), floor=0.0))
        xe = x.expand(n, B, d)
        ms = cuda_ms(torch, lambda: mk.multi_dense_fused(x, w, bias, relu))
        pms = cuda_ms(torch, lambda: mk.multi_dense_xla(x, w, bias, act))
        lms = cuda_ms(torch, lambda: torch.baddbmm(bias, xe, w))
        fl, nb = multi_dense_work(nx, n, B, d, u)
        # the tile runs three TF32 products per multiply-add on the
        # tensor cores; the gate kernel f32 FMAs
        gate = mk.takes_gate_kernel(nx, n, d, u)
        ops, peak, kind = ((fl, PEAK_F32_FLOPS, "f32") if gate
                           else (3 * fl, PEAK_TF32_FLOPS, "ops, split TF32"))
        b_ms, b_by = bound_ms(ops, nb, peak)
        print(f"  {name}: {'gate kernel' if gate else 'split-TF32 tile'} "
              f"{ms:.4f} ms, {pms:.4f} ms plain, {lms:.4f} ms torch.baddbmm;"
              f" bound {b_ms:.4f} ms ({kind if b_by == 'operations' else b_by}"
              f") = {b_ms / ms:.1%} of the kernel's time; f32 SIMT bound "
              f"{bound_ms(fl, nb)[0]:.4f} ms; x{times} per forward [{card}]")
        if b_ms > ms:
            fail(f"multi_dense {name} ran under its bound: the bound or "
                 f"the count is wrong")
        for key, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                       ("t_ops", ops / peak), ("t_bytes", nb / PEAK_BYTES),
                       ("flops", fl), ("nbytes", nb)):
            t[key] += times * v
    # ragged shapes (B = 1, odd D, U between the tile widths) and the
    # dispatch edges at other B: N * U = 16 with W too deep for the gate
    # kernel's shared memory (the tile), a per-expert input with N * U = 8
    # (the tile), D % 4 == 0 with U % 4 == 0 (16-byte copies) per expert
    for nx, n, b, d, u in ((1, 4, 1, 429, 128), (4, 4, 1000, 128, 64),
                           (1, 2, 1000, 429, 4), (1, 3, 777, 77, 17),
                           (3, 3, 1001, 45, 200), (1, 1, 1, 13, 5),
                           (1, 4, 1000, 5000, 4), (2, 2, 500, 429, 4),
                           (3, 3, 257, 64, 200)):
        x = rand(nx, b, d)
        w, bias = rand(n, d, u, scale=d ** -0.5), rand(n, 1, u)
        for relu in (True, False):
            err = max(err, compare(
                f"ragged ({nx}, {b}, {d}) x ({n}, {d}, {u}) relu={relu}",
                mk.multi_dense_fused(x, w, bias, relu),
                mk.multi_dense_xla(x, w, bias, "relu" if relu else None),
                floor=0.0))
        # x off the 16-byte grid: the tile's 4-byte copies
        err = max(err, compare(
            f"ragged ({nx}, {b}, {d}) x ({n}, {d}, {u}), x misaligned",
            mk.multi_dense_fused(misaligned(x), w, bias, False),
            mk.multi_dense_xla(x, w, bias, None), floor=0.0))
    t_ops, t_bytes = t["t_ops"], t["t_bytes"]
    b_ms = max(t_ops, t_bytes) * 1e3
    b_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"  one forward's six launches: {t['flops'] / 1e9:.3f} GFLOP, "
          f"{t['nbytes'] / 1e6:.1f} MB: kernel {t['ms']:.4f} ms, "
          f"torch.baddbmm {t['library_ms']:.4f} ms; bound {b_ms:.4f} ms "
          f"(ops, split TF32 {t_ops * 1e3:.4f}; bytes {t_bytes * 1e3:.4f}) "
          f"= {b_ms / t['ms']:.1%}; f32 SIMT bound "
          f"{bound_ms(t['flops'], t['nbytes'])[0]:.4f} ms [{card}]")
    kern["multi_dense"] = dict(
        name="multi_dense", route="cuda",
        source="rec_now_tpu_torch/csrc/multi_dense.cu",
        replaces=f"{MD_TPU}:75", max_abs_err=err, ms=t["ms"],
        plain_ms=t["plain_ms"], bound_ms=b_ms, bound_by=b_by,
        library_ms=t["library_ms"])
    wg = tower_rows(torch, mk, rand, B, card)
    kern["linear_wg"] = dict(
        name="linear_wg", route="cuda",
        source="rec_now_tpu_torch/csrc/multi_dense.cu",
        replaces="nn.Linear + torch.relu (DNNTower, no TPU kernel)",
        max_abs_err=wg["err"], ms=wg["ms"], plain_ms=wg["plain_ms"],
        bound_ms=wg["bound_ms"], bound_by=" and ".join(sorted(
            wg["bound_by"])),
        library_ms=wg["library_ms"])

    print("listwise_loss_sum vs plain:")
    print(f"  B=8192: {listwise_ops(pb.labels):,} operations")
    err = 0.0
    ones = torch.ones(8192, device=dev)
    wide = torch.tensor([-2 ** 31, 2 ** 31 - 1, -70000, -7, 0, 2 ** 24 + 1],
                        dtype=torch.int32)
    wide = wide[torch.randint(0, len(wide), (8192,), generator=gen)].to(dev)
    pm_lab = torch.tensor([1.0, -1.0], device=dev).repeat(150)
    pm_lab = torch.cat([pm_lab, torch.ones(300, device=dev)])
    pm_grp = (torch.arange(600, device=dev) >= 300).int()
    lw_x1, lw_lab1 = rand(8193), torch.cat([lab, lab[:1]])
    lw_grp1 = torch.cat([grp, grp[:1]])
    one8k = torch.zeros(8192, dtype=torch.int32, device=dev)
    # graded labels in [-0.4, 1.2) for a caller's threshold (a generator
    # of their own: the script's stream stays as it was)
    glab = (torch.rand(8192, generator=torch.Generator().manual_seed(18))
            * 1.6 - 0.4).to(dev)
    # (what, x, labels, groups, path[, threshold]): the click batch on
    # each path, past the one-block sort (8,193 takes the sweep), the int32
    # ends, one group and singletons at 8,192, a {+1, -1} group (label sum
    # 0, valid) beside an all-positive one; graded labels at thresholds
    # 0.3 and -0.25 (where a non-member's 0 counts as a label above it: on
    # the click batch's groups and on one group) on each path
    lw_cases = [("click batch B=8192", xl, lab, grp, "auto"),
                ("click batch B=8192, sort forced", xl, lab, grp, "sort"),
                ("click batch B=8192, sweep forced", xl, lab, grp, "sweep"),
                ("click batch B=8193 (sweep)", lw_x1, lw_lab1, lw_grp1,
                 "auto"),
                ("click batch B=1000", *cases[1][:3], "auto"),
                ("no valid group", xl, ones, grp, "auto"),
                ("B=1", xl[:1], lab[:1], grp[:1], "auto"),
                ("wide ids B=8192", xl, lab, wide, "auto"),
                ("one group B=8192", xl, lab, one8k, "auto"),
                ("singletons B=8192", xl, lab,
                 torch.arange(8192, dtype=torch.int32, device=dev), "auto"),
                ("{+1, -1} group B=600", xl[:600], pm_lab, pm_grp, "auto")]
    lw_cases += [(f"graded labels, {g_what}, th={th}, {path}", xl, glab, gs,
                  path, th)
                 for th in (0.3, -0.25)
                 for g_what, gs in (("click groups", grp),
                                    ("one group", one8k))
                 for path in ("sort", "sweep")]
    for what, xs, ls, gs, path, *th in lw_cases:
        got = lk._listwise_fused(xs, ls, gs, path, *th)
        want = lk.listwise_loss_fused_plain(xs, ls, gs, *th)
        if float(got[1]) != float(want[1]):
            fail(f"listwise count {float(got[1])} != {float(want[1])} "
                 f"({what})")
        print(f"  {what}: {int(want[1])} valid groups")
        err = max(err, compare_all(what, got, want))
        again = lk._listwise_fused(xs, ls, gs, path, *th)
        if not all(torch.equal(u, r) for u, r in zip(got, again)):
            fail(f"listwise_loss_sum ({what}) is not bit-equal on a repeat")
    b_ms, b_by = bound_ms(listwise_ops(pb.labels),
                          16 * 8192 + 8)
    kern["listwise_loss_sum"] = dict(
        name="listwise_loss_sum", route="cuda",
        source="rec_now_tpu_torch/csrc/listwise.cu",
        replaces=f"{LW_TPU}:99", max_abs_err=err,
        ms=cuda_ms(torch, lambda: lk.listwise_loss_fused(xl, lab, grp)),
        plain_ms=cuda_ms(torch, lambda: lk.listwise_loss_fused_plain(
            xl, lab, grp)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    lw_paths = {"sort B=8192": (xl, lab, grp, "sort"),
                "sweep B=8192": (xl, lab, grp, "sweep"),
                "B=8193 (sweep)": (lw_x1, lw_lab1, lw_grp1, "auto")}
    print("  B6 paths, ms by events: " + "; ".join(
        f"{what} {cuda_ms(torch, lambda: lk._listwise_fused(*v)):.4f}"
        for what, v in lw_paths.items()) + f" [{card}]")
    # the device split: the sort path is one launch a call (one kernel),
    # the sweep two; any other kernel or count fails
    reps = 20
    for what, v, parts in (
            ("sort, click batch B=8192", (xl, lab, grp, "sort"),
             {"lw_sort_kernel": "sort"}),
            ("sort, wide ids B=8192", (xl, lab, wide, "sort"),
             {"lw_sort_kernel": "sort"}),
            ("sort, one group B=8192", (xl, lab, one8k, "sort"),
             {"lw_sort_kernel": "sort"}),
            ("sweep, click batch B=8192", (xl, lab, grp, "sweep"),
             {"lw_sweep_kernel": "sweep", "lw_finalize_kernel": "merge"})):
        split = kernel_split(profiled_sequence(
            torch, lambda: lk._listwise_fused(*v), reps), reps, parts,
            "listwise_loss_sum")
        print(f"  B6 split, {what}, device ms by torch.profiler: "
              + "; ".join(f"{part} {ms / reps:.4f}"
                          for part, ms in split.items())
              + f"; total {sum(split.values()) / reps:.4f} [{card}]")
    # -- config 2's kernels: lazy Adam (B10), the pair counts (B7a/b/c) and
    # the general pair loss (B3) --------------------------------------------
    fc = FeatureConfig()
    ids8k = fc.global_ids(torch.as_tensor(pb.sparse_ids, device=dev)
                          ).reshape(-1)
    print("adam_dense_pass vs plain:")
    err = 0.0
    vfull = fc.total_rows
    touched_full = torch.zeros(vfull, dtype=torch.bool, device=dev)
    touched_full.index_fill_(0, ids8k, True)
    n_touched = int(touched_full.sum())
    print(f"  V={vfull}: a B=8192 batch's {ids8k.numel()} ids touch "
          f"{n_touched} rows ({n_touched / vfull:.2%})")
    ragged = []
    for v, d in ((12345, 16), (1001, 8)):
        ragged.append((v, d, (torch.rand(v, generator=gen) < 0.3).to(dev)))
    # rows touched only in a partial last 512-flag chunk (enough of them
    # that visible() below sees v's change, ~1e-9 an element)
    for v, d in ((1000, 16), (1100, 8)):
        ragged.append((v, d, torch.arange(v, device=dev) >= v // 512 * 512))
    for v, d, tch in [(vfull, 16, touched_full)] + ragged:
        for t in (1, 1000):
            tb, m1 = rand(v, d, scale=1e-3), rand(v, d, scale=1e-3)
            v1 = rand(v, d, scale=1e-3).square()
            dg = rand(v, d, scale=1e-3) * tch[:, None]
            dg[::7] = 0.0              # touched rows with a zero gradient
            cnt = torch.tensor(t, dtype=torch.int32, device=dev)
            before = [x.clone() for x in (tb, m1, v1)]
            want = [x.clone() for x in (tb, m1, v1)]
            again = [x.clone() for x in (tb, m1, v1)]
            tk.adam_dense_pass(tb, m1, v1, dg, tch, cnt, 1e-3)
            tk.adam_dense_pass(*again, dg, tch, cnt, 1e-3)
            if not all(torch.equal(u, r) for u, r in zip((tb, m1, v1),
                                                         again)):
                fail(f"adam_dense_pass at V={v} is not bit-equal on a repeat")
            tk.adam_dense_pass_plain(*want, dg, tch, cnt, 1e-3, 0.9, 0.999,
                                     1e-7)
            for name, got, ref, old in zip(("rows", "m", "v"), (tb, m1, v1),
                                           want, before):
                err = max(err, compare(f"V={v} D={d} t={t} {name}", got,
                                       ref, 0.0))
                if not torch.equal(got[~tch], old[~tch]):
                    fail(f"adam_dense_pass changed an untouched {name}")
                visible(f"the touched {name}' change", ref[tch] - old[tch],
                        float(ref.abs().max()))
    # bytes this batch's data needs: every row's flag, then table, m, v and
    # g read and table, m, v written for each touched row; ~14 operations a
    # touched element
    b_ms, b_by = bound_ms(14 * n_touched * 16,
                          vfull + n_touched * 7 * 16 * 4 + 4)
    tb, m1 = rand(vfull, 16, scale=1e-3), rand(vfull, 16, scale=1e-3)
    v1, dg = rand(vfull, 16, scale=1e-3).square(), rand(vfull, 16)
    cnt = torch.tensor(1, dtype=torch.int32, device=dev)
    kern["adam_dense_pass"] = dict(
        name="adam_dense_pass", route="cuda",
        source="rec_now_tpu_torch/csrc/table_update.cu",
        replaces=f"{TABLE_TPU}:186", max_abs_err=err,
        ms=cuda_ms(torch, lambda: tk.adam_dense_pass(
            tb, m1, v1, dg, touched_full, cnt, 1e-3)),
        plain_ms=cuda_ms(torch, lambda: tk.adam_dense_pass_plain(
            tb, m1, v1, dg, touched_full, cnt, 1e-3, 0.9, 0.999, 1e-7)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    # the device time: the events above also time the wrapper's host path
    reps = 20
    split = kernel_split(profiled_sequence(
        torch, lambda: tk.adam_dense_pass(tb, m1, v1, dg, touched_full, cnt,
                                          1e-3), reps), reps,
        {"adam_chunk_kernel": "update"}, "adam_dense_pass")
    print(f"  B10 V={vfull}: {kern['adam_dense_pass']['ms']:.4f} ms by "
          f"events, {split['update'] / reps:.4f} on the device "
          f"(torch.profiler), bound {b_ms:.4f} ({b_by}) [{card}]")
    del tb, m1, v1, dg, before, want, again

    print("pair counts and the general pair loss vs plain:")
    graded = torch.as_tensor(pb.labels + pb.cvr_labels, device=dev)
    dom = torch.as_tensor(pb.domain_idx, device=dev)
    mask = (torch.rand(8192, generator=gen) > 0.1).float().to(dev)
    two = [grp, dom]
    print(f"  B=8192, labels {{0, 1, 2}}, groups and domain: "
          f"{int(mask.sum())} samples unmasked")
    gcases = [("B=8192 graded, 2 groups, mask", xl, graded, two, mask),
              ("B=8191", xl[:8191], graded[:8191], [grp[:8191], dom[:8191]],
               mask[:8191]),
              ("B=1", xl[:1], graded[:1], [grp[:1], dom[:1]], mask[:1])]
    errs = {"pair_row_counts": 0.0, "same_group_matvec": 0.0,
            "group_pair_counts_binary": 0.0, "pair_loss_sum": err_pair}
    def repeat(name: str, fn, got) -> None:
        if not torch.equal(got, fn()):
            fail(f"{name} is not bit-equal on a repeat")

    # B7a and B7c on each path (auto takes the sort at these B)
    for what, xs, ls, gs, ms in gcases:
        for wrong in (False, True):
            want = pk.pair_row_counts_plain(xs, ls, gs, ms, wrong)
            for path in ("auto", "sort", "sweep"):
                name = f"pair_row_counts {what} wrong_order={wrong} {path}"
                got = pk._pair_row_counts(xs, ls, gs, ms, wrong, path)
                errs["pair_row_counts"] = max(
                    errs["pair_row_counts"],
                    compare(name, got, want, 0.0, rel=0.0))
                repeat(name, lambda: pk._pair_row_counts(
                    xs, ls, gs, ms, wrong, path), got)
            # B7b: exact on the counts, bit-equal on a repeat
            wgpc = pk.same_group_matvec_plain(gs[0], want)
            name = f"same_group_matvec {what} wrong_order={wrong}"
            gpc = pk.same_group_matvec(gs[0], want)
            errs["same_group_matvec"] = max(
                errs["same_group_matvec"],
                compare(name, gpc, wgpc, 0.0, rel=0.0))
            repeat(name, lambda: pk.same_group_matvec(gs[0], want), gpc)
            rw = torch.where(wgpc > 0, wgpc.clamp_min(1e-30) ** -0.5,
                             torch.zeros_like(wgpc))
            got = pk.pair_loss_fused(xs, ls, gs, 1.0, row_weights=rw,
                                     sample_mask=ms, wrong_order=wrong)
            want = pk.pair_loss_fused_plain(xs, ls, gs, 1.0, row_weights=rw,
                                            sample_mask=ms,
                                            wrong_order=wrong)
            if float(got[1]) != float(want[1]):
                fail(f"general pair count {float(got[1])} != "
                     f"{float(want[1])}")
            print(f"  {what} wrong_order={wrong}: {int(want[1])} pairs")
            errs["pair_loss_sum"] = max(errs["pair_loss_sum"], compare_all(
                f"pair_loss_sum {what} wrong_order={wrong}", got, want))
            # the general loss in one call on each path, against its plain
            # version and the composition above (`got`): powf against
            # torch's rsqrt, sums in other orders
            gwant = pk.pair_loss_general_plain(xs, ls, gs, 1.0, -0.5,
                                               sample_mask=ms,
                                               wrong_order=wrong)
            for path in ("auto", "sort", "sweep"):
                name = f"pair_loss_general {what} wrong_order={wrong} {path}"
                one = pk._pair_loss_general(xs, ls, gs, 1.0, -0.5, ms, wrong,
                                            path)
                if not float(one[1]) == float(gwant[1]) == float(got[1]):
                    fail(f"{name}: count {float(one[1])} vs plain "
                         f"{float(gwant[1])}, composed {float(got[1])}")
                for ref, vs in ((gwant, "plain"), (got, "composed")):
                    errs["pair_loss_sum"] = max(
                        errs["pair_loss_sum"],
                        compare(f"{name} vs {vs}: loss", one[0], ref[0], 0.0,
                                rel=1e-5),
                        compare(f"{name} vs {vs}: dlogits", one[2], ref[2],
                                0.0))
                again = pk._pair_loss_general(xs, ls, gs, 1.0, -0.5, ms,
                                              wrong, path)
                if not all(torch.equal(a, r) for a, r in zip(one, again)):
                    fail(f"{name} is not bit-equal on a repeat")
        clicks = (ls > 1.5).float()     # a click and a conversion: binary
        want = pk.group_pair_counts_binary_plain(gs[0], clicks, ms)
        via = pk.same_group_matvec_plain(gs[0], pk.pair_row_counts_plain(
            xs, clicks, gs[0], ms))
        # graded labels and a fractional mask: the sums of mask * label and
        # of mask (in double on the card and in the plain version)
        frac = torch.rand(len(ls), generator=torch.Generator().manual_seed(
            5)).to(dev)
        graded_want = pk.group_pair_counts_binary_plain(gs[0], ls, frac)
        for path in ("auto", "sort", "sweep"):
            name = f"group_pair_counts_binary {what} {path}"
            got = pk._group_pair_counts_binary(gs[0], clicks, ms, path)
            repeat(name, lambda: pk._group_pair_counts_binary(
                gs[0], clicks, ms, path), got)
            got_graded = pk._group_pair_counts_binary(gs[0], ls, frac, path)
            repeat(name + ", graded", lambda: pk._group_pair_counts_binary(
                gs[0], ls, frac, path), got_graded)
            errs["group_pair_counts_binary"] = max(
                errs["group_pair_counts_binary"],
                compare(name, got, want, 0.0, rel=0.0),
                compare(f"{name} vs B7a -> B7b", got, via, 0.0, rel=0.0),
                compare(f"{name}, graded labels, fractional mask", got_graded,
                        graded_want, 0.0, rel=1e-6))
    counts_full = pk.pair_row_counts_plain(xl, graded, two, mask)
    # B7b on f32 vec: 1e-6 of the largest sum (the hash adds doubles in no
    # fixed order)
    vec = rand(8192, scale=3.0)
    errs["same_group_matvec"] = max(
        errs["same_group_matvec"],
        compare("same_group_matvec B=8192 f32 vec",
                pk.same_group_matvec(grp, vec),
                pk.same_group_matvec_plain(grp, vec), 0.0, rel=1e-6))
    nb = 8192 * 4
    n_valid = float(pk.pair_loss_fused_plain(xl, graded, two, 1.0,
                                             sample_mask=mask)[1])
    # least work, with no (i, j) sweep: B7a a sort on (group, domain,
    # label) of the unmasked samples, then each sample's mask test and the
    # count of its group's lower labels (4); B7b a hash of each id, its
    # slot's add and a read back (4 a sample, no sort); B7c a sort by
    # group, mask * label, the pos and tot adds, pos * (tot - pos) (5 a
    # sample)
    work = {
        "pair_row_counts": (sort_ops(8192, 3) + 4 * 8192, 6 * nb),
        "same_group_matvec": (4 * 8192, 3 * nb),
        "group_pair_counts_binary": (sort_ops(8192) + 5 * 8192, 4 * nb),
    }
    calls = {
        "pair_row_counts": (
            lambda: pk.pair_row_counts(xl, graded, two, mask),
            lambda: pk.pair_row_counts_plain(xl, graded, two, mask)),
        "same_group_matvec": (
            lambda: pk.same_group_matvec(grp, counts_full),
            lambda: pk.same_group_matvec_plain(grp, counts_full)),
        "group_pair_counts_binary": (
            lambda: pk.group_pair_counts_binary(grp, lab, mask),
            lambda: pk.group_pair_counts_binary_plain(grp, lab, mask))}
    for name, line in (("pair_row_counts", 170), ("same_group_matvec", 190),
                       ("group_pair_counts_binary", 227)):
        b_ms, b_by = bound_ms(*work[name])
        kern[name] = dict(
            name=name, route="cuda",
            source="rec_now_tpu_torch/csrc/pairwise.cu",
            replaces=f"{PAIR_TPU}:{line}", max_abs_err=errs[name],
            ms=cuda_ms(torch, calls[name][0]),
            plain_ms=cuda_ms(torch, calls[name][1]),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
    # each count kernel's paths, by events and on the device; auto at B =
    # 8,192 must take the sort (B7a: the sort and the count sweep, no
    # O(B^2) sweep; B7c: one launch of one block; B7b: its memset and two
    # hash kernels, also at B = 8,193), and the general loss in one call
    # the sort, B7a's count sweep, B3's sweep and B3's merge, once each.
    # B7a's conditions as one (2, B) tensor: a list costs the wrapper a
    # stack kernel
    reps = 20
    two_t = torch.stack(two).to(torch.int32)
    grp1 = torch.cat([grp, grp[:1]])
    counts1 = torch.cat([counts_full, counts_full[:1]])
    count_paths = (
        ("pair_row_counts", "auto (sort)", lambda: pk.pair_row_counts(
            xl, graded, two_t, mask),
         {"sort_segments_kernel": "sort and segments",
          "segment_sweep": "count sweep"}),
        ("pair_row_counts", "sweep", lambda: pk._pair_row_counts(
            xl, graded, two_t, mask, False, "sweep"),
         {"row_count_sweep": "sweep", "merge_rows": "merge"}),
        ("same_group_matvec", "hash", calls["same_group_matvec"][0],
         B7B_PARTS),
        ("same_group_matvec", "hash, B=8193",
         lambda: pk.same_group_matvec(grp1, counts1), B7B_PARTS),
        ("group_pair_counts_binary", "auto (sort)",
         calls["group_pair_counts_binary"][0],
         {"binary_sort_kernel": "sort and sums"}),
        ("group_pair_counts_binary", "sweep",
         lambda: pk._group_pair_counts_binary(grp, lab, mask, "sweep"),
         {"binary_sum_sweep": "sweep", "merge_rows": "merge"}),
        ("pair_loss_general", "auto (one sort)",
         lambda: pk.pair_loss_general(xl, graded, two_t, 1.0, -0.5,
                                      sample_mask=mask), GENERAL_PARTS))
    for name, path, fn, parts in count_paths:
        ms = cuda_ms(torch, fn)
        split = kernel_split(profiled_sequence(torch, fn, reps), reps, parts,
                             name)
        at = "" if ", B=" in path else ", B=8192"
        print(f"  {name}, {path}{at}: {ms:.4f} ms by events, "
              f"{sum(split.values()) / reps:.4f} on the device ("
              + "; ".join(f"{part} {t / reps:.4f}"
                          for part, t in split.items())
              + f"; torch.profiler) [{card}]")
    # the general loss composed of sweeps in its one call, and as the
    # parent composed it (B7a, B7b, the weights in torch, B3): each
    # call's device operations, by kernel
    def composed():
        c = pk.pair_row_counts(xl, graded, two_t, mask)
        g = pk.same_group_matvec(grp, c)
        w = torch.where(g > 0, g.clamp_min(1e-30) ** -0.5,
                        torch.zeros_like(g))
        return pk.pair_loss_fused(xl, graded, two_t, 1.0, row_weights=w,
                                  sample_mask=mask)

    for path, fn in (
            ("sweep (one call)", lambda: pk._pair_loss_general(
                xl, graded, two_t, 1.0, -0.5, mask, False, "sweep")),
            ("composed: B7a, B7b, weights, B3", composed)):
        ms = cuda_ms(torch, fn)
        seq = profiled_sequence(torch, fn, reps)
        by = {}
        for n, t in seq:
            by[kernel_name(n)] = by.get(kernel_name(n), 0.0) + t / reps
        print(f"  pair_loss_general, {path}, B=8192: {ms:.4f} ms by events, "
              f"{sum(by.values()):.4f} on the device in "
              f"{len(seq) / reps:g} operations a call ("
              + "; ".join(f"{k} {t:.4f}" for k, t in by.items())
              + f"; torch.profiler) [{card}]")
    kern["pair_loss_sum"]["max_abs_err"] = errs["pair_loss_sum"]
    gen_ms = cuda_ms(torch, lambda: pk.pair_loss_general(
        xl, graded, two_t, 1.0, -0.5, sample_mask=mask))
    gen_plain = cuda_ms(torch, lambda: pk.pair_loss_general_plain(
        xl, graded, two_t, 1.0, -0.5, sample_mask=mask))
    # a sort on (group, domain, label), the mask test a sample, each
    # sample's count added to its group's and its group's weight (5 a
    # sample), 12 a valid pair (pair_ops); logits, labels, two groups and
    # the mask read, dlogits and the two sums written
    g_ms, g_by = bound_ms(sort_ops(8192, 3) + 6 * 8192 + 12 * n_valid,
                          6 * nb + 8)
    print(f"  pair_loss_general (graded labels, 2 groups, mask, power "
          f"-0.5; {int(n_valid)} pairs): {gen_ms:.4f} ms kernel, "
          f"{gen_plain:.4f} ms plain, bound {g_ms:.6f} ms ({g_by}) "
          f"[{card}]")

    # -- B11 and B12 on the full-width table with a B = 8192 batch's ids --
    grads8k = rand(ids8k.numel(), 16, scale=1e-3)
    check_gather_scatter(torch, kern, rand, ids8k, grads8k, vfull, gather_k,
                         expand_k, ShardedEmbeddingTable, dev, card)
    # -- B9-B12 at config 5's CAN table and other widths of a warp a row --
    check_wide_tables(torch, rand, gen, pb, tk, gather_k, expand_k, dev, card)
    # -- the pooled multi-hot lookup at the DLRM layout ----------------------
    check_gather_pool(torch, np, kern, gather_k, dev, card)
    torch.cuda.empty_cache()

    print(f"update paths of the table (auto), median of {UPDATE_ROUNDS} "
          f"interleaved rounds of 10 calls each:")
    for opt in ("adagrad", "adam"):
        paths = {}
        for mode, v in (("dense", vfull), ("dense", 4 * vfull),
                        ("sparse", vfull)):
            tbl = ShardedEmbeddingTable(v, 16, device=dev, optimizer=opt,
                                        update_mode=mode)
            st = tbl.state_from(rand(v, 16, scale=1e-3))
            paths[f"{mode} V={v}"] = functools.partial(
                tbl.apply_grads, st, ids8k, grads8k, 1e-3)
        # the sparse path is ~30 launches whose time moves with the host:
        # the paths take turns, in alternating order, and each is read as
        # the median of its rounds
        reads = {k: [] for k in paths}
        for r in range(UPDATE_ROUNDS):
            for k in (list(paths) if r % 2 == 0 else list(paths)[::-1]):
                reads[k].append(cuda_ms(torch, paths[k], reps=10))
        del paths, st
        for k, ts in reads.items():
            print(f"  {opt} {k}: rounds " + " ".join(f"{t:.4f}" for t in ts)
                  + " ms")
        d1, d4, sparse = (statistics.median(ts) for ts in reads.values())
        slope = (d4 - d1) / (3 * vfull)              # ms a row
        cross = (sparse - (d1 - slope * vfull)) / slope
        limit = ShardedEmbeddingTable.DENSE_UPDATE_MAX_TABLE_BYTES[opt]
        # at its limit auto switches paths: where they cost about the
        # same, auto takes the faster one on both sides of it
        dense_at = d1 + slope * (limit / 64 - vfull)
        gap = max(dense_at, sparse) / min(dense_at, sparse) - 1
        print(f"  {opt}: dense {d1:.4f} ms at V={vfull}, {d4:.4f} ms at "
              f"V={4 * vfull}; sparse {sparse:.4f} ms for {ids8k.numel()} "
              f"ids; the two cross at V = {cross:,.0f} rows of D = 16, a "
              f"table of {cross * 64 / 2 ** 20:,.0f} MiB; at auto's limit "
              f"({limit / 2 ** 20:,.0f} MiB) dense takes {dense_at:.4f} "
              f"ms, the paths {gap:.1%} apart [{card}]")
    torch.cuda.empty_cache()

    for v in kern.values():
        print(f"  {v['name']}: {v['ms']:.4f} ms kernel, {v['plain_ms']:.4f} "
              f"ms plain, library {v['library_ms']}, bound {v['bound_ms']:.6f}"
              f" ms ({v['bound_by']}) at full width [{card}]")
    del x0, ws, xr, pr, g, gr, ac, t2, a2, x, xe, w, bias
    torch.cuda.empty_cache()

    # -- 4-6. serve, check one step, train: config 3 in both CIN modes, then
    # config 4 ------------------------------------------------------------
    fc = FeatureConfig()
    data = SyntheticCriteo(num_dense=fc.num_dense, num_sparse=fc.num_sparse,
                           rows_per_field=fc.rows_per_field, seed=0)
    rng_batches = list(data.batches(8192, 6, seed=1))
    small = next(data.batches(1000, 1, seed=2))
    table = EmbeddingTable(fc.total_rows, fc.embedding_dim, device=dev)
    table_t = table.init(torch.Generator().manual_seed(1))
    print(f"table {tuple(table_t.shape)} "
          f"{table_t.numel() * 4 / 1e6:.1f} MB on {table_t.device}")
    cpu_table = EmbeddingTable(fc.total_rows, fc.embedding_dim, device="cpu")
    cpu_table_t = table_t.cpu()
    # config 5's second table, rows U(-0.05, 0.05) as the trainer draws
    can_table = EmbeddingTable(CAN_ROWS, CAN_DIM, device=dev,
                               initializer_scale=0.05)
    can_t = can_table.init(torch.Generator().manual_seed(2))
    cpu_can_table = EmbeddingTable(CAN_ROWS, CAN_DIM, device="cpu")
    cpu_can_t = can_t.cpu()

    # the function holding each kernel's launch count
    counter = {"cin_stack_sum": ck.cin_stack_sum, "cin_flat": ck.cin_flat,
               "cin_stack_sum_bwd": ck.cin_stack_sum_bwd,
               "cin_flat_bwd": ck.cin_flat_bwd,
               "pair_loss_sum": pk.pair_loss_sum,
               "adagrad_dense_pass": tk.adagrad_dense_pass,
               "multi_dense": mk.multi_dense_fused,
               "linear_wg": mk.linear_wg,
               "listwise_loss_sum": lk.listwise_loss_sum,
               "adam_dense_pass": tk.adam_dense_pass,
               "pair_row_counts": pk.pair_row_counts,
               "same_group_matvec": pk.same_group_matvec,
               "group_pair_counts_binary": pk.group_pair_counts_binary,
               "gather_rows": gather_k.gather_rows,
               "scatter_add_rows": expand_k.scatter_add_rows,
               "gather_pool_rows": gather_k.gather_pool_rows}
    for v in kern.values():
        v["launches"] = v["launches_per_step"] = 0

    def counted(what: str, units: int, per_unit: dict, run, extra=None):
        """``run()`` with every launch count set to 0 just before it and
        read just after: each kernel must have launched ``per_unit`` times
        (0 where not named) for each of ``units``, and ``extra`` times
        more in all where named there; the counts go to the kernels' JSON
        line."""
        extra = extra or {}
        for fn in counter.values():
            fn.launches = 0
        result = run()
        counts = {n: fn.launches for n, fn in counter.items()}
        print(f"{what}: launches {counts}")
        for n, c in counts.items():
            if c != per_unit.get(n, 0) * units + extra.get(n, 0):
                fail(f"{what}: {n} launched {c} times, expected "
                     f"{per_unit.get(n, 0)} for each of {units} and "
                     f"{extra.get(n, 0)} more")
            kern[n]["launches"] += c
        return result

    def check_cin(model, batch) -> None:
        """Serving: the CIN layer on this run's embeddings, kernel vs
        plain."""
        ids = fc.global_ids(torch.as_tensor(batch.sparse_ids, device=dev))
        emb = table.lookup(table_t, ids)                    # (B, F, D)
        b, f, d = emb.shape
        ws = model.cin.weights()
        x0 = emb.transpose(1, 2).contiguous()               # (B, D, F)
        hs = [x0]                                           # plain layers
        for w in ws:
            hs.append(cin_contract_plain(x0, hs[-1], w))
        if model.cin_sum_channel:
            # the model's own call (output_input), then the interactions
            # alone, which every layer must visibly move
            compare("main-path CIN, output_input=True", model.cin(emb),
                    torch.cat(hs, -1).sum(-1), floor=0.0)
            x0f = x0.reshape(b * d, f)
            want = torch.cat(hs[1:], -1).sum(-1).reshape(-1)
            compare("main-path CIN, interactions only",
                    ck.cin_stack_sum(x0f, ws, output_input=False), want,
                    floor=0.0)
            scale = float(want.abs().max())
            for i, h in enumerate(hs[1:], 1):
                visible(f"layer {i}'s channel sum", h.sum(-1), scale)
        else:
            got = model.cin(emb, sum_channel=False).reshape(b, -1, d)
            got = got.split([h.shape[-1] for h in hs], dim=1)
            for i in range(1, len(hs)):
                compare(f"main-path CIN layer {i}", got[i],
                        hs[i].transpose(1, 2), floor=0.0)

    def check_cin_step(taps, sum_channel: bool) -> None:
        """Training: the CIN backward on the step's own input, weights
        and output gradient."""
        (tap,) = taps
        b, f, d = tap["x"].shape
        x0 = tap["x"].transpose(1, 2).reshape(b * d, f).contiguous()
        w0 = tap["w"]
        if sum_channel:
            g = tap["g"].reshape(-1).contiguous()
            for oi in (True, False):      # the step's call, interactions
                got = ck.cin_stack_sum_bwd(x0, w0, g, oi)
                want = ck.cin_stack_sum_bwd_plain(x0, w0, g, oi)
                compare_all(f"cin_stack_sum_bwd output_input={oi}",
                            [got[0]] + got[1], [want[0]] + want[1])
            # the interactions' dx0 (output_input=False), split into the
            # collapsed last layer's share and layer 1's: each must show
            dx0 = want[0]
            wc = w0[-1].sum(0)
            h1 = ck.cin_flat_plain(x0, x0, w0[0])
            last = g[:, None] * (h1 @ wc.t())
            scale = float(dx0.abs().max())
            visible("dx0: collapsed last layer", last, scale)
            visible("dx0: layer 1 and below", dx0 - last, scale)
        else:
            sizes = [f] + [w.shape[0] for w in w0]
            dcin = tap["g"].reshape(b, sum(sizes), d).transpose(1, 2)
            direct = dcin.reshape(b * d, -1).split(sizes, dim=1)
            hs = [x0]
            for w in w0:
                hs.append(ck.cin_flat_plain(x0, hs[-1], w))
            gk = direct[-1].contiguous()
            for i in range(len(w0), 0, -1):
                got = ck.cin_flat_bwd(x0, hs[i - 1], w0[i - 1], gk)
                want = ck.cin_flat_bwd_plain(x0, hs[i - 1], w0[i - 1], gk)
                # dx0, dprev and dW are one term each, held at their
                # own scale
                compare_all(f"cin_flat_bwd layer {i}", got, want)
                if i > 1:
                    gk = (direct[i - 1] + want[1]).contiguous()

    def check_banks_step(taps) -> None:
        """Training: each multi-expert dense call on the step's own input
        and weights."""
        if len(taps) != 6:
            fail(f"{len(taps)} multi-dense calls in a step, expected 6")
        for i, tap in enumerate(taps):
            x = tap["x"] if tap["x"].dim() == 3 else tap["x"][None]
            (w, bias), relu = tap["w"], tap["mod"].activation == "relu"
            want = mk.multi_dense_xla(x, w, bias, "relu" if relu else None)
            compare(f"multi_dense call {i} ({tuple(x.shape)} x "
                    f"{tuple(w.shape)}, relu={relu})",
                    mk.multi_dense_fused(x, w, bias, relu), want, floor=0.0)
            # the same call through the kernel's other paths: x off the
            # 16-byte grid (4-byte copies), and a shared input as one copy
            # per expert (the tile, where the gate kernel took the call)
            others = [("x misaligned", misaligned(x))]
            if x.shape[0] == 1 and w.shape[0] > 1:
                others.append(("x per expert", x.expand(
                    w.shape[0], -1, -1).contiguous()))
            for what, xo in others:
                compare(f"multi_dense call {i}, {what}",
                        mk.multi_dense_fused(xo, w, bias, relu), want,
                        floor=0.0)
            visible(f"call {i}'s product",
                    mk.multi_dense_xla(x, w, None, None),
                    float(want.abs().max()))
            if relu and not ((want == 0).any() and (want > 0).any()):
                fail(f"call {i}'s ReLU cuts nothing or everything")

    def check_can(model, batch) -> None:
        """Serving: the CAN layer on this run's embeddings and CAN rows
        against a float64 plain evaluation of the per-sample DNN, relative
        to its output's scale; then the share of that output that the
        products (not the biases) make, and the CAN output's share of the
        logits, each of which the check must see."""
        ids = torch.as_tensor(batch.sparse_ids, device=dev)
        emb = table.lookup(table_t, fc.global_ids(ids))       # (B, F, D)
        can_emb = can_table.lookup(can_t, ids[:, CAN_FIELD] % CAN_ROWS)
        hist = emb[:, :8]                                     # (B, L, D)
        got = model.can(hist, can_emb)
        h, p = hist.double(), can_emb.double()
        d, u = fc.embedding_dim, CAN_DIM // (fc.embedding_dim + 1)
        kernel, bias = p[:, :d * u].reshape(-1, d, u), p[:, d * u:]
        mask = (h != 0).any(-1, keepdim=True).double()
        prods = torch.einsum("bld,bdu->blu", h, kernel)
        want = ((prods + bias[:, None]) * mask).sum(1)
        compare("main-path CAN layer vs float64", got, want.float(), 0.0)
        visible("the products' share of the CAN output",
                (prods * mask).sum(1), float(want.abs().max()))
        dense = torch.as_tensor(batch.dense, device=dev)
        logits = model(dense, emb, can_emb)
        zero = model(dense, emb, torch.zeros_like(can_emb))   # CAN out 0
        visible("the CAN output's share of the logits", logits - zero,
                max(1.0, float(logits.abs().max())))

    def xdeepfm(sum_channel: bool):
        return lambda device: XDeepFMModel(fc, cin_sum_channel=sum_channel,
                                           device=device, seed=0)

    # every path the port runs; launches are per request and per step:
    # each request and step looks its rows up (B11), each step's dense
    # update scatters their gradients into the buffer (B12)
    LOOKUP = {"gather_rows": 1}
    UPDATE = {"gather_rows": 1, "scatter_add_rows": 1}
    cfg3 = TrainerConfig(pointwise_weight=1.0, pairwise_weight=1.0,
                         click_occurance_power=-0.5)
    # config 5 (bench_all.py:132-135): a second table, looked up and
    # updated once each a request or step beside the first
    cfg5 = TrainerConfig(pointwise_weight=1.0, pairwise_weight=0.5,
                         can_param_field=CAN_FIELD, can_dnn_dims=(16,))
    TWO = {"gather_rows": 2, "scatter_add_rows": 2}

    def can_dcn(device):
        return CANDCNModel(fc, device=device, seed=0)
    runs = (
        dict(what="config 3, cin_sum_channel=True", make=xdeepfm(True),
             heads=None, reqs=rng_batches[:5] + [small],
             serve={"cin_stack_sum": 1, **LOOKUP}, check_serve=check_cin,
             cfg=cfg3, keys={"loss", "pointwise", "pairwise"},
             taps=lambda m: [m.cin],
             check_step=lambda taps: check_cin_step(taps, True),
             train={"cin_stack_sum": 1, "cin_stack_sum_bwd": 1,
                    "pair_loss_sum": 1, "adagrad_dense_pass": 1, **UPDATE},
             steps=(2, 10)),
        dict(what="config 3, cin_sum_channel=False", make=xdeepfm(False),
             heads=None, reqs=rng_batches[5:6] + [small],
             serve={"cin_flat": 2, **LOOKUP}, check_serve=check_cin,
             cfg=cfg3, keys={"loss", "pointwise", "pairwise"},
             taps=lambda m: [m.cin],
             check_step=lambda taps: check_cin_step(taps, False),
             train={"cin_flat": 2, "cin_flat_bwd": 2, "pair_loss_sum": 1,
                    "adagrad_dense_pass": 1, **UPDATE},
             steps=(1, 3)),
        dict(what="config 4 (MultiTaskModel)",
             make=lambda device: MultiTaskModel(fc, device=device, seed=0),
             heads=2, reqs=rng_batches[:5] + [small],
             serve={"multi_dense": 6, **LOOKUP}, check_serve=None,
             cfg=TrainerConfig(pointwise_weight=1.0, listwise_weight=0.5,
                               num_tasks=2),
             keys={"loss", "pointwise", "listwise", "cvr_loss"},
             taps=lambda m: [x for x in m.modules()
                             if isinstance(x, MultiDenseLayer)],
             check_step=check_banks_step,
             train={"multi_dense": 6, "listwise_loss_sum": 1,
                    "adagrad_dense_pass": 1, **UPDATE},
             steps=(2, 10)),
        dict(what="config 2 (DCNv2Model) + lazy Adam",
             make=lambda device: DCNv2Model(fc, device=device, seed=0),
             heads=None, reqs=rng_batches[:5] + [small], serve=LOOKUP,
             check_serve=None,
             cfg=TrainerConfig(pointwise_weight=1.0, pairwise_weight=0.5,
                               click_occurance_power=-0.5,
                               sparse_optimizer="adam", sparse_lr=1e-3),
             keys={"loss", "pointwise", "pairwise"}, taps=lambda m: [],
             check_step=lambda taps: None,
             train={"pair_loss_sum": 1, "adam_dense_pass": 1, **UPDATE},
             steps=(2, 10)),
        dict(what="config 5 (CANDCNModel)", make=can_dcn, can=True,
             heads=None, reqs=rng_batches[:5] + [small],
             serve={"gather_rows": 2}, check_serve=check_can, cfg=cfg5,
             keys={"loss", "pointwise", "pairwise"}, taps=lambda m: [],
             check_step=lambda taps: None,
             train={"pair_loss_sum": 1, "adagrad_dense_pass": 2, **TWO},
             steps=(2, 10)),
        # B10's wide path on a real step's tensors: a first step only
        dict(what="config 5 (CANDCNModel) + lazy Adam", make=can_dcn,
             can=True, heads=None, serve=None, cfg=dataclasses.replace(
                 cfg5, sparse_optimizer="adam", sparse_lr=1e-3),
             keys={"loss", "pointwise", "pairwise"}, taps=lambda m: [],
             check_step=lambda taps: None,
             train={"pair_loss_sum": 1, "adam_dense_pass": 2, **TWO},
             steps=None))

    # -- 4. serve at full width ----------------------------------------------
    def serve(run) -> None:
        """The run's model through build_scorer and WireScorer u8/f16:
        launches per request, logits' shape and finiteness, wire vs raw;
        then (the counts read) the model's own check and the card against
        the same model and table on the CPU."""
        what, reqs = run["what"], run["reqs"]
        model = run["make"](dev)
        can = run.get("can", False)
        kw = (dict(can_table=can_table, can_param_field=CAN_FIELD) if can
              else {})
        state = ServingState(dict(model.named_parameters()), table_t,
                             can_t if can else None)
        fronts = {"raw": build_scorer(model, fc, table, device=dev, **kw),
                  "u8": WireScorer(model, fc, table, "u8", device=dev, **kw),
                  "f16": WireScorer(model, fc, table, "f16", device=dev,
                                    **kw)}
        for fn in fronts.values():                 # warm-up, not counted
            fn(state, reqs[0].dense, reqs[0].sparse_ids)
        torch.cuda.synchronize()

        def requests():
            times, outs = {k: [] for k in fronts}, []
            for batch in reqs:
                out = {}
                for name, fn in fronts.items():
                    t0 = time.perf_counter()
                    out[name] = fn(state, batch.dense, batch.sparse_ids)
                    torch.cuda.synchronize()
                    if len(batch.dense) == 8192:
                        times[name].append((time.perf_counter() - t0) * 1e3)
                outs.append(out)
            return times, outs

        calls = len(reqs) * len(fronts)
        # each front's requests run the towers' wgmma layers, by batch
        towers = len(fronts) * sum(tower_launches(model, len(b.dense))
                                   for b in reqs)
        times, outs = counted(f"serve {what}, {calls} requests", calls,
                              run["serve"], requests,
                              {"linear_wg": towers})
        for batch, out in zip(reqs, outs):
            raw, b = out["raw"], len(batch.dense)
            shape = (run["heads"], b) if run["heads"] else (b,)
            if tuple(raw.shape) != shape or not torch.isfinite(raw).all():
                fail(f"{what}: bad logits {tuple(raw.shape)}, expected "
                     f"{shape}")
            for mode, tol in (("f16", 2e-3), ("u8", 3e-2)):
                e = float((out[mode] - raw).abs().max())
                if e > tol:
                    fail(f"{what}: {mode} wire differs from raw by {e} > "
                         f"{tol}")
        for name, ts in times.items():
            ms = statistics.median(ts)
            print(f"  {name}: {ms:.3f} ms/request (median of {len(ts)}) "
                  f"{8192 / ms * 1e3:.0f} examples/s at B=8192 [{card}]")
        if run["check_serve"]:
            with torch.inference_mode():
                run["check_serve"](model, reqs[0])
        cpu_model = run["make"]("cpu")
        cpu_state = ServingState(dict(cpu_model.named_parameters()),
                                 cpu_table_t, cpu_can_t if can else None)
        score = build_scorer(cpu_model, fc, cpu_table, device="cpu",
                             **(dict(can_table=cpu_can_table,
                                     can_param_field=CAN_FIELD) if can
                                else {}))
        for batch, out in ((reqs[0], outs[0]), (reqs[-1], outs[-1])):
            want = score(cpu_state, batch.dense, batch.sparse_ids)
            e = float((out["raw"].cpu() - want).abs().max())
            print(f"  B={len(batch.dense)} card vs CPU plain: max_abs_err "
                  f"{e:.3e} max|logit| {float(want.abs().max()):.3e}")
            if e > REL_TOL * max(1.0, float(want.abs().max())):
                fail(f"{what}: card logits disagree with the CPU reference")

    for run in runs:
        if run["serve"] is not None:
            serve(run)
    serve_pooled(torch, np, counted, dev, card)

    # -- 5. one training step: card vs CPU, kernels on its own tensors -------
    step_batch = next(data.batches(2048, 1, seed=3))

    def one_step(run, device, cfg=None, count=False):
        """The run's first step on ``device`` from the seed's weights and
        tables (``cfg`` in place of the run's own; with ``count``, its
        launches held to the run's per step); returns what it saw and
        produced: the logits, each tapped module's input, weights before
        the step and output gradient, each table's ids and gradients, the
        metrics, grads, params and state."""
        model = run["make"](device)
        trainer = Trainer(model, fc, cfg or run["cfg"], device=device)
        can_state = None
        if trainer.can_table is not None:
            can_state = trainer.can_table.state_from(
                can_t.to(device, copy=True))
        state = trainer.init(None, table=trainer.table.state_from(
            table_t.to(device, copy=True)), can_table=can_state)
        seen = {"taps": []}

        def on_model(mod, args, out):
            seen["logits"] = out.detach()

        def on_tap(mod, args, out):
            tap = {"mod": mod, "x": args[0].detach(),
                   "w": [p.detach().clone() for p in mod.parameters()]}
            out.register_hook(lambda g: tap.__setitem__("g", g))
            seen["taps"].append(tap)

        apply = trainer.table.apply_grads

        def record_apply(st, ids, grads, lr):
            seen["gids"], seen["demb"] = ids, grads
            return apply(st, ids, grads, lr)

        trainer.table.apply_grads = record_apply
        if trainer.can_table is not None:
            can_apply = trainer.can_table.apply_grads

            def record_can(st, ids, grads, lr):
                seen["can_ids"], seen["dcan"] = ids, grads
                return can_apply(st, ids, grads, lr)

            trainer.can_table.apply_grads = record_can
        hooks = [model.register_forward_hook(on_model)] + [
            m.register_forward_hook(on_tap) for m in run["taps"](model)]
        inputs = trainer.put(step_batch)
        if count:
            state, metrics = counted(
                f"first step, {run['what']}, B=2048", 1, run["train"],
                lambda: trainer.train_step(state, *inputs))
        else:
            state, metrics = trainer.train_step(state, *inputs)
        for h in hooks:
            h.remove()
        seen["metrics"] = losses_of(run["what"], metrics)
        seen["grads"] = {n: p.grad for n, p in state.params.items()}
        seen["params"] = {n: p.detach() for n, p in state.params.items()}
        seen["state"] = state
        return seen

    def check_step(run) -> None:
        cfg = run["cfg"]
        print(f"first step, {run['what']}, B=2048: card vs CPU plain")
        card, cpu = one_step(run, dev, count=True), one_step(run, "cpu")
        if set(cpu["metrics"]) != run["keys"]:
            fail(f"{run['what']}: metrics {sorted(cpu['metrics'])}")
        for key, want in cpu["metrics"].items():
            got = card["metrics"][key]
            print(f"  {key}: card {got:.7f} cpu {want:.7f}")
            if not math.isfinite(got) or abs(got - want) > REL_TOL * abs(
                    want):
                fail(f"first-step {key} {got} != CPU {want}")
        for name, want in cpu["grads"].items():
            got = card["grads"][name]
            if got is None:
                fail(f"no gradient reached {name} on the card")
            compare(f"grad {name}", got.cpu(), want, floor=0.0, rel=1e-3)
        for name, want in cpu["params"].items():
            compare(f"{name} after Adam", card["params"][name].cpu(), want)
        # an accumulator grows by mean g^2 on 0.1, often by less than an
        # f32 ulp (7.5e-9): held to a few ulps of 0.1
        acc_tol = 2.0 ** -22
        adam = cfg.sparse_optimizer == "adam"
        parts = ((("table", REL_TOL), ("m", REL_TOL), ("v", REL_TOL)) if adam
                 else (("table", REL_TOL), ("accumulator", acc_tol)))
        # each table: (label, its state's field, the ids and row gradients
        # the step applied, its rows before the step)
        tables = [("", "table", "gids", "demb", table_t)]
        if "can_ids" in card:
            tables.append(("CAN table: ", "can_table", "can_ids", "dcan",
                           can_t))
        for label, field, ids_key, _, _ in tables:
            rows = torch.unique(cpu[ids_key])
            for what, rel in parts:
                got = getattr(getattr(card["state"], field),
                              what)[rows.to(dev)].cpu()
                want = getattr(getattr(cpu["state"], field), what)[rows]
                compare(f"{label}{len(rows)} touched rows' {what}", got,
                        want, 0.0, rel)
            if adam and not int(getattr(card["state"], field).count) == int(
                    getattr(cpu["state"], field).count) == 1:
                fail(f"{label}the Adam count is not 1 after the first step")

        print("  the kernels on this step's own tensors (card):")
        run["check_step"](card["taps"])
        # task 0's logits drive the ranking loss
        logits = card["logits"]
        logits = (logits[0] if logits.dim() == 2 else logits).contiguous()
        labels = torch.as_tensor(step_batch.labels, device=dev)
        groups = torch.as_tensor(step_batch.group_ids, device=dev)
        if cfg.pairwise_weight:
            name = "pair_loss_sum"
            power = cfg.click_occurance_power
            got = pk.pair_loss_fused(logits, labels, groups, 1.0, power)
            want = pk.pair_loss_fused_plain(logits, labels, groups, 1.0,
                                            power)
        else:
            name = "listwise_loss_sum"
            got = lk.listwise_loss_fused(logits, labels, groups)
            want = lk.listwise_loss_fused_plain(logits, labels, groups)
        if float(got[1]) != float(want[1]) or float(want[1]) == 0:
            fail(f"{name} count {float(got[1])} vs plain {float(want[1])}")
        print(f"    {name}: count {int(want[1])}")
        compare_all(f"{name} (loss, count, dlogits)", got, want)
        for label, _, ids_key, grads_key, start in tables:
            ids = card[ids_key].reshape(-1).long()
            dense_g = torch.zeros_like(start)
            dense_g.index_add_(0, ids, card[grads_key].reshape(
                -1, start.shape[1]))
            rows = torch.unique(ids)
            st0 = ShardedEmbeddingTable(
                *start.shape, device=dev,
                optimizer=cfg.sparse_optimizer).state_from(start)
            if adam:
                touched = torch.zeros(len(start), dtype=torch.bool,
                                      device=dev)
                touched.index_fill_(0, ids, True)
                cnt = torch.ones((), dtype=torch.int32, device=dev)
                got = [start.clone(), st0.m.clone(), st0.v.clone()]
                want = [x.clone() for x in got]
                tk.adam_dense_pass(*got, dense_g, touched, cnt,
                                   cfg.sparse_lr)
                tk.adam_dense_pass_plain(*want, dense_g, touched, cnt,
                                         cfg.sparse_lr, 0.9, 0.999, 1e-7)
                for name, a, b, old in zip(("rows", "m", "v"), got, want,
                                           (start, st0.m, st0.v)):
                    compare(f"{label}adam_dense_pass updated {name}",
                            a[rows], b[rows], 0.0)
                    visible(f"the {name}' update", b[rows] - old[rows],
                            float(b[rows].abs().max()))
                continue
            tb, ac = start.clone(), st0.accumulator.clone()
            t2, a2 = tb.clone(), ac.clone()
            tk.adagrad_dense_pass(tb, ac, dense_g, cfg.sparse_lr)
            tk.adagrad_dense_pass_plain(t2, a2, dense_g, cfg.sparse_lr)
            compare(f"{label}adagrad_dense_pass updated rows", tb[rows],
                    t2[rows], 0.0)
            visible("the rows' update", t2[rows] - start[rows],
                    float(t2[rows].abs().max()))
            compare(f"{label}adagrad_dense_pass accumulators", ac[rows],
                    a2[rows], 0.0, rel=acc_tol)
            # the mean g^2 a row adds, which on 0.1 can be below an ulp
            # (config 5's main table): the same pass from zero
            # accumulators, its sums at their own scale
            z, z2 = torch.zeros_like(ac), torch.zeros_like(a2)
            tk.adagrad_dense_pass(start.clone(), z, dense_g, cfg.sparse_lr)
            tk.adagrad_dense_pass_plain(start.clone(), z2, dense_g,
                                        cfg.sparse_lr)
            compare(f"{label}adagrad_dense_pass accumulators from zero",
                    z[rows], z2[rows], 0.0)
            visible("the accumulators' increase", z2[rows],
                    float(z2[rows].abs().max()))
        if adam:
            # the same step through the sparse path, on the card
            sparse = one_step(run, dev, dataclasses.replace(
                cfg, sparse_update_mode="sparse"))
            for label, field, ids_key, _, _ in tables:
                rows = torch.unique(card[ids_key])
                for what in ("table", "m", "v"):
                    compare(f"{label}sparse vs dense update: touched rows' "
                            f"{what}",
                            getattr(getattr(sparse["state"], field),
                                    what)[rows],
                            getattr(getattr(card["state"], field),
                                    what)[rows], 0.0)

    for run in runs:
        check_step(run)

    # -- 6. train at full width ----------------------------------------------
    batches = list(data.batches(8192, 13, seed=5))

    def train(run) -> None:
        """Warm-up steps, then timed steps (host clock, each ending in a
        synchronize) with exact launches; every loss finite and > 0."""
        if run["steps"] is None:
            return
        (warm, timed), what = run["steps"], run["what"]
        model = run["make"](dev)
        trainer = Trainer(model, fc, run["cfg"], device=dev)
        state = trainer.init(torch.Generator().manual_seed(1))
        for batch in batches[:warm]:
            state, _ = trainer.train_step(state, *trainer.put(batch))
        torch.cuda.synchronize()

        def steps(state):
            times, metrics = [], []
            for batch in batches[warm:warm + timed]:
                t0 = time.perf_counter()
                state, m = trainer.train_step(state, *trainer.put(batch))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                metrics.append(m)
            return times, metrics

        times, metrics = counted(
            f"train {what}: {warm} warm-up + {timed} timed steps at B=8192",
            timed, run["train"], lambda: steps(state))
        for name, per in run["train"].items():
            kern[name]["launches_per_step"] = per
        for i, m in enumerate(metrics):
            vals = losses_of(what, m)
            print(f"  step {warm + i}: " + " ".join(
                f"{k} {v:.6f}" for k, v in sorted(vals.items()))
                + f" {times[i]:.3f} ms")
            if set(vals) != run["keys"] or not all(
                    math.isfinite(x) and x > 0 for x in vals.values()):
                fail(f"{what}: step {warm + i} has a bad loss {vals}")
        ms = statistics.median(times)
        print(f"  {ms:.3f} ms/step (median of {timed}), {8192 / ms * 1e3:.0f}"
              f" examples/s at B=8192 [{card}]")
        # an estimate: phase 3's kernel times (its own inputs, timed
        # alone) against this step; profile_training measures the step's
        # own device times
        parts = {name: kern[name]["ms"] * per / MS_COVERS.get(name, 1)
                 for name, per in run["train"].items()}
        print("    split estimated from phase 3's kernel times:")
        for name, t in parts.items():
            print(f"    {name}: ~{t:.4f} ms = ~{t / ms:.1%} of the step")
        print(f"    rest (host, library calls, copies): "
              f"~{ms - sum(parts.values()):.4f} ms = "
              f"~{1 - sum(parts.values()) / ms:.1%}")

    for run in runs:
        train(run)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB")

    # -- 7. the public pairwise loss as an entry point ------------------------
    lb = next(data.batches(8192, 1, seed=7))
    x_cpu = torch.randn(8192, generator=gen) * 2
    mask_cpu = (torch.rand(8192, generator=gen) > 0.1).float()
    groups2 = [torch.as_tensor(lb.group_ids), torch.as_tensor(lb.domain_idx)]
    entry_cases = (
        ("graded labels, 2 groups, mask, power -0.5", False,
         torch.as_tensor(lb.labels + lb.cvr_labels), groups2, False,
         {"pair_loss_sum": 1}),
        ("the same with the wrong-order filter", True,
         torch.as_tensor(lb.labels + lb.cvr_labels), groups2, False,
         {"pair_loss_sum": 1}),
        ("binary labels, 1 group, binary_labels=True", False,
         torch.as_tensor(lb.labels), groups2[:1], True,
         {"pair_loss_sum": 1}))
    # the CPU's reference: the blocked form (what B >= 4,096 takes there)
    # and the dense (B, B) form, whose dlogits are autograd's of the loss
    # itself (the blocked BPR's are derived by hand)
    for what, wrong, labels, groups, binary, per in entry_cases:
        out = {}
        for d, form in ((dev, None), ("cpu", "blocked"), ("cpu", "dense")):
            xd = x_cpu.to(d).requires_grad_()

            def call():
                loss, cnt = pairwise_loss(
                    xd, labels.to(d), [g.to(d) for g in groups],
                    only_use_wrong_order_pair=wrong, return_num_pair=True,
                    click_occurance_power=-0.5, mask=mask_cpu.to(d),
                    binary_labels=binary)
                return (loss,) + (cnt,) + torch.autograd.grad(loss, xd)

            if form is None:
                out[d] = counted(f"pairwise_loss B=8192, {what}", 1, per,
                                 call)
                continue
            saved = pw_mod.BLOCKED_MIN_BATCH
            if form == "dense":
                pw_mod.BLOCKED_MIN_BATCH = 1 << 40
            try:
                out[form] = call()
            finally:
                pw_mod.BLOCKED_MIN_BATCH = saved
        got = out[dev]
        for form in ("blocked", "dense"):
            want = out[form]
            if float(got[1]) != float(want[1]) or float(want[1]) == 0:
                fail(f"pairwise_loss {what}: count {float(got[1])} vs CPU "
                     f"{form} {float(want[1])}")
            print(f"  {int(want[1])} pairs; loss card {float(got[0]):.7f} "
                  f"cpu {form} {float(want[0]):.7f}")
            compare(f"pairwise_loss {what}: loss vs CPU {form}",
                    got[0].detach().cpu(), want[0].detach(), 0.0)
            compare(f"pairwise_loss {what}: dlogits vs CPU {form}",
                    got[2].cpu(), want[2], 0.0)
    lab_d = torch.as_tensor(lb.labels, device=dev)
    g_d, m_d = groups2[0].to(dev), mask_cpu.to(dev)
    gpc = counted("group_pair_counts_binary B=8192", 1,
                  {"group_pair_counts_binary": 1},
                  lambda: pk.group_pair_counts_binary(g_d, lab_d, m_d))
    via = counted("pair_row_counts -> same_group_matvec B=8192", 1,
                  {"pair_row_counts": 1, "same_group_matvec": 1},
                  lambda: pk.same_group_matvec(g_d, pk.pair_row_counts(
                      x_cpu.to(dev), lab_d, g_d, m_d)))
    compare("group_pair_counts_binary vs pair_row_counts -> "
            "same_group_matvec", gpc, via, 0.0, rel=0.0)
    if not float(gpc.max()) > 0:
        fail("group_pair_counts_binary found no pair")

    # -- 8. the training entry point ------------------------------------------
    synthetic_ms = train_cli_phase(torch, counted, card)

    # -- 9. the training entry point on a data file ---------------------------
    file_cli_phase(torch, counted, card, synthetic_ms)

    # -- 10. the multi-process path in a NCCL group of one --------------------
    mesh_phase(torch, counted, card, fc, runs, batches, synthetic_ms, dev)

    # -- 11. the layer and loss library ---------------------------------------
    library_phase(torch, counted, card, dev, fc, data, table, table_t,
                  cpu_table, cpu_table_t)

    # -- 12. slot features and the table's leftovers --------------------------
    slot_phase(torch, counted, card, dev, fc, data, table, table_t,
               cpu_table, cpu_table_t)

    # -- 13. result -----------------------------------------------------------
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the "
          f"first phase to the result, the build included [{card}]")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_per_step")
    print(json.dumps({"kernels": [{k: v[k] for k in keys}
                                  for v in kern.values()]}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
