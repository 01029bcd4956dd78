#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU (an H100, sm_90a).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure ends the run with a
non-zero exit code and no result line:

1. device  — requires a CUDA device; prints the nvidia-smi name and power
             limit line and torch's device name.
2. build   — compiles the nine sources of ``graphaibench_tpu_torch/csrc``
             (``ell_spmm.cu``: K1; ``fused_gat.cu``: the five passes of
             the fused GAT attention v2; ``ell_edge.cu``: the three passes
             over per-edge values that v1 runs on; ``ell_pull.cu``: K8,
             ``neighbor_reduce``, the analytics' pull step; ``tc_count.cu``:
             K9, triangle counting's DAG intersection count;
             ``kcore_hindex.cu``: K10, k-core's h-index sweep;
             ``cgr_decode.cu``: K12, the four CGR decode passes;
             ``vbyte_decode.cu``: K11, the byte codecs' three decode
             passes; ``coloring.cu``: K14, coloring's first-fit step) with
             nvcc,
             side by side, and loads them; prints the build seconds and
             the compiler's register report for each kernel.
3. kernel  — K1: on rmat(17, 16) with self-loops, for F in {128, 16} and both
             weight views (forward and transpose), holds the kernel
             against its plain PyTorch version and times both, beside the
             card's bound for the same work and the library call
             (torch.sparse.mm on a CSR tensor of the same graph and
             weights), which is timed here and used nowhere in the port.
             Then F = 7 (the kernel's scalar instantiation), F = 1-3 (its
             narrow one), and the graph without self-loops, which has rows
             of degree 0, behind an allocator dirtied with NaN: all against
             the plain version.
             The GAT passes (gat_rowmax, gat_v2_fwd, gat_v2_bwd_sl,
             gat_v2_bwd_h, and gat_v2_bwd, the backward in one pass): the
             same graph, F in {128, 16}, each kernel against its plain
             version on the same inputs, timed beside its bound (no
             single PyTorch call computes any of them, so there is no
             library time); then F = 7, 256 and 33 (float columns,
             several tiles, both) and the graph without self-loops
             behind the dirtied allocator; then the whole
             differentiable op, output and three gradients, against the
             port's unfused path (sddmm_add, segment_softmax, spmm) under
             autograd at rmat13.
             The passes over per-edge values (ell_row_reduce in its three
             kinds, gat_v1_fwd, sddmm_dot_ell): the same graph with a
             random 0/1 mask as edge weights, F in {128, 16}, each kernel
             against its plain version, timed beside its bound and, where
             one PyTorch call computes the same function (index_add_,
             scatter_reduce_, torch.sparse.sampled_addmm), that call;
             gat_v1_fwd also with the scores it writes for the backward;
             then F = 7, 33, 12 and 256 (float columns, more columns than
             a group has lanes, a group with an idle lane, several
             columns a lane and several tiles) and the graph without
             self-loops behind the dirtied allocator; then the v1 op
             (gat_attention_spmm), output and three gradients, against
             the unfused path at rmat13.
4. small   — the port's Model trained 5 steps on the GPU and on the CPU
             (plain versions) at rmat11 (ELL forced) and rmat13, for gcn,
             sage, gat and ggnn; the trajectories must agree. Then
             train_sampled for gcn (COO strategy) and gat (dense
             strategy) and inductive training for gat, GPU against CPU,
             and a save/restore round trip on the card.
5. main    — the GCN main path: Model(make_config("gcn", 2, 128, 128, 16,
             lr=0.01), ds, device="cuda").train(5) on rmat17, then
             evaluate("test"); counts the kernel's launches. Then the GAT
             main path at the same widths (2 layers, 128/128/16, no
             l2norm/dense head), with the GAT kernels' launch counts (per
             step gat_rowmax and gat_v2_fwd twice, gat_v2_bwd once, for the
             hidden layer, gat_v2_bwd_sl and gat_v2_bwd_h once, for the
             output layer; 4 in evaluation, no K1 launch), then sage at
             those widths and ggnn (make_config("ggnn", 1, 128, 128, 16))
             with K1's counts. Then 5 GAT steps at the same widths through
             apply_model with its default trivial_w and a random 0/1 mask
             as edge weights (the v1 fused attention): per step 10
             ell_row_reduce, 2 gat_v1_fwd, 2 sddmm_dot_ell and 2 K1
             launches. Then 5 epochs of train_sampled each for gcn and gat
             at subg_size 32768 (COO strategy, l2norm + dense head), with
             the sampler-wait, step and evaluation seconds of OpTimers
             and the launches of its two full-graph evaluations. Every
             count is set to 0 just before its path and read just
             after.
6. epochs  — the GCN and the GAT model on after those 5 warm-up steps:
             the median of 20 epochs with the kernels, and with their
             plain versions swapped in, in the order kernel, plain,
             plain, kernel.
7. profile — 10 more epochs of each under torch.profiler: device time per
             epoch by kernel, and the device's busy share of the profiled
             wall time (the profiler slows the host, so that share is a
             floor). The v1 path (20 timed steps, 10 profiled) and the
             sampled paths (3 profiled epochs) are profiled inside the
             main phase, right after they are driven.
8. analytics — on rmat(19, 16) (symmetric, the JAX package's analytics
             size): K8 against its plain version in every case (each kind
             for int32 and float32 vals, float32 also with edge values
             packed and as an (ne,) array), three cases timed beside the
             bound and, for the float32 sum, torch.sparse.mm (an SpMV);
             then every case at rmat13 behind an allocator dirtied with
             NaN. Then, every count set to 0 just before them, bfs,
             sssp_bellman_ford with symmetric and with asymmetric weights,
             pagerank, connected_components and the Afforest route, each
             held to scipy or a float64 numpy power iteration, with
             seconds per warm solve, sweeps and K8 launches (one a sweep);
             one BFS under the profiler. Then K9 against its plain version
             at rmat19 (timed beside its bound) and at rmat13 behind the
             dirtied allocator, and triangle_count held to scipy's count
             (19,736,616 on rmat(19, 16, seed=0)), one cold solve and warm
             ones, one K9 launch a count, and K9 on a graph with a row
             wider than its hash tables held to plain and scipy; K10 against
             its plain version on one sweep from the degrees at rmat19
             (timed beside its bound, its device ms by kernel) and at
             rmat13 behind the dirtied allocator, and on rmat13 joined to a
             star wider than a hub block's histogram, k_core_hindex (one
             K10 launch a sweep, 37 sweeps at rmat19, the solve's summed
             device ms) and k_core_peel (one K8 launch a peel) equal to the
             serial oracle, as k_core_hindex is on the star graph; bc_single_source held to a float64
             Brandes written with scipy (rtol 1e-4), one K8 launch a level
             forward and back, and at rmat13 to the serial oracle. Every
             count is set to 0 just before each solver and read just after.
             Then bfs and bfs_frontier on grid2d(512), a directed rmat13
             through bfs_host's push route, ``cli analytics
             bfs|sssp|pr|cc|tc|bc|kcore`` in seven processes on a dataset
             written by the port's save_graph, and ``cli info`` on it.
             Prints its seconds.
9. compress — the analytics graph through sort_and_clean, encoded in CGR
             (zeta_k 2, res_seg_len 256, bit-aligned; then with intervals
             in 64-bit interval segments) by the native encoder, with the
             encode seconds, bytes and ratio; with the reference's 32-bit
             interval segments, whose items outgrow their slots on this
             graph, the device route must refuse the stream (ValueError)
             and the host decode it exactly; each stream decoded on the card by cgr_device_prep and
             cgr_device_run, every count set to 0 just before them, equal to
             the CSR exactly, with prep and run seconds, decoded edges/s and
             the K12 launches (2 cgr_gamma and 1 cgr_residual; with
             intervals 4 cgr_gamma, 1 cgr_interval, 1 cgr_residual, 1
             cgr_merge). Each K12 kernel against its plain version on the
             same lanes at rmat19 (timed beside its bound) and at rmat13
             behind the dirtied allocator; cgr_residual under the prep's
             tables and under those it builds itself, on the plain
             stream's lanes and the interval stream's residual lanes;
             cgr_gamma also on the interval stream's residual headers as
             the prep finds them and in a random order. The
             same graph in StreamVByte,
             VarintGB and hybrid (threshold 32, StreamVByte chunks) by the
             host encoders (seconds, bytes, ratio), each decoded on the card
             by its prep and run, every count set to 0 just before them,
             equal to the CSR exactly, with prep and run seconds, decoded
             edges/s and the launches (1 svb_decode; 1 vgb_tags and 1
             vgb_values; for hybrid 1 cgr_residual and 1 svb_decode); each
             K11 kernel against its plain version at rmat19 (timed beside its
             bound) and at rmat13 behind the dirtied allocator, with
             svb_decode's and vgb_values' long-row and tile routes apart,
             and cgr_residual on hybrid's low rows (timed as its own case).
             rmat13 joined to a star of 50,000 leaves numbered after the
             hub, in VarintGB (the hub a long row of many rounds), in plain
             CGR (many residual segments) and in CGR with 64-bit interval
             segments (the hub two intervals, taken by the device route):
             vgb_tags, vgb_values, cgr_residual and cgr_merge against their
             plain versions, with their tables and without, the decodes
             against the CSR.
             triangle_count of the decoded graph (19,736,616),
             triangle_count_streaming equal to it, with its seconds, blocks,
             pairs and K9 launches (one a pair), and its peak memory over the
             baseline, which must stay below the CSR's bytes; bfs_streaming
             equal to bfs from vertex 0, with its peak beside the CSR's
             bytes. Then the CLI on rmat(13, 8): ``compress`` in the four
             schemes and CGR with ``-a word -p``, ``verify`` and
             ``decompress`` of each, ``info`` on the CGR prefix,
             ``analytics tc`` and ``bfs`` on the CGR, VarintGB and hybrid
             prefixes, ``analytics tc`` on the StreamVByte one (each decoded
             on the card) and ``GAB_TC_STREAM=1 analytics tc``, each Correct.
10. sharded — the sharded trainer (``parallel/``) on rmat17 at the main
             path's widths, GCN and GAT (2 layers, 128/128/16): (a) in this
             process as the one rank of an nccl group, 5 steps, losses
             within rtol 1e-4 of Model's, the weights' distance from
             Model's printed beside the spread of a second Model run;
             then 5 steps from fresh weights, each followed by a Model
             step from the trainer's weights and optimizer state, the
             gradients within rtol 1e-4 and atol 1e-6 and the weights
             within atol 1e-4 of Model's,
             the launches per step Model's (K1 3 for GCN; for GAT
             gat_rowmax and gat_v2_fwd 2, gat_v2_bwd, gat_v2_bwd_sl and
             gat_v2_bwd_h 1), device time per step under the profiler
             beside Model's, and the peak memory of each trainer's set-up
             and of its steps, each over what was allocated just before
             it; (b) two ranks
             spawned on the one card over gloo (the halo exchange
             host-staged), 3 steps, each rank's loss and the summed
             weights held to Model's alike (rank 0 followed by Model),
             both ranks equal, with
             halo_counts, h_max, the launches per step (K1 6: own and halo
             tables, forward and adjoint) and halo_probe's seconds; (c)
             each rank's rectangular tables at P = 2, of rmat17 (those
             (b) trains on) at F = 128 and 16 and of rmat13 at F = 128,
             16 and 7: K1 on the own, halo and unified tables and their
             transposes, the five GAT passes on the unified table and its
             transpose, each against its plain version behind a dirtied
             allocator.
11. tp_dp  — the tensor-parallel trainer, data-parallel GraphSAINT and
             the shard files at the main path's widths on rmat17: (a) two
             ranks on the one card over gloo (host-staged) as (1 graph x 2
             model), GCN and GAT (l2norm and dense head, as make_config
             gives GAT), 3 steps, each rank's losses (rtol 1e-4) and the
             summed weights (atol as the sharded phase's) held to Model
             on the card, the ranks equal, the launches a step a rank (K1
             3 for GCN at F = 64 and 16; GAT's passes at F = 64, the
             backward as one pass or two by FG._single_pass), the
             transport, the reduce-scatter route and each rank's device
             ms a step beside Model's; (b) four ranks as (2 x 2), GCN, 2
             steps, held alike (K1 6 a step a rank); (c) the rank tables
             at P = 1 and 2 at F = 64 and 5 (K1 on the own, halo and
             unified tables and their transposes, the five GAT passes),
             each against its plain version behind a dirtied allocator;
             (d) two data-parallel GraphSAINT ranks (GCN, subg_size
             32768), 3 steps: the ranks equal, the first step's averaged
             gradients held to the serial mean of the two subgraphs'
             gradients computed in this process (rtol 1e-4, atol 1e-6),
             the seconds a step with the sampler's wait; (e) the (a) GCN
             trainer rebuilt from shard files in a temporary directory:
             its first loss that of the in-memory trainer (within rtol
             1e-6: K1 adds a split row's pieces with atomics, in an order
             no launch fixes).
12. dist_analytics — the distributed solvers (``parallel/dist_analytics.py``)
             on the analytics graph, rmat(19, 16) symmetric: BFS, SSSP
             (random asymmetric weights), CC, k-core, BC from vertex 0,
             PageRank and the two triangle counts, (a) at one nccl rank
             in this process and (b) at two gloo ranks spawned on the one
             card (the halo exchange host-staged), each solver twice
             (checked, then warm), every count set to 0 just before each:
             BFS, CC, k-core and the counts equal to the single-device
             solvers' answers on the card, SSSP within rtol 1e-5,
             PageRank within rtol 1e-4, atol 1e-7 (its iterations equal),
             BC within the analytics phase's tolerance; two ranks equal to
             one alike, with equal sweep, iteration and level counts; the
             set-up and solve seconds, seconds a pull, launches a solve by
             kernel, the transport and each rank's peak memory. (c) The
             2-D count's real layout, which s = isqrt(P) = 1 never
             reaches: the four blocks of a 2 x 2 grid of the DAG, laid out
             as their ranks lay them out, each counted with K9 and its
             plain version, summing to the single-device count. (d) K8 in
             the solvers' four cases (int32 min, int32 sum, float32 sum,
             float32 min-plus with packed slot weights) on each rank's
             forward table at P = 2, and K1 at F = 1 on its own and halo
             tables, against their plain versions behind a NaN-dirtied
             allocator; rank 0's timed beside the bound, the plain version
             and, for the float32 sum and K1, torch.sparse.mm.
13. remat  — ``cfg.remat`` (each gconv layer under torch.utils.checkpoint)
             on rmat17: GCN, GAT (no head) and GGNN at 2 x 128 and SAGE at
             3 x 256, feat_drop 0.5: for each, the loss and every gradient
             of one step with remat held to those without it, from one
             dropout generator state (rtol 1e-4 of each tensor's largest:
             the recompute's atomics add in another order), and GAT's
             unfused path at score_drop 0.3 alike, with the spread of two
             runs without remat beside it; then 3 steps each way, every
             count set to 0 just before them and read just after: K1 3 and
             4 a step (GCN), 5 and 8 (SAGE), 1 and 2 (GGNN); GAT's
             gat_rowmax and gat_v2_fwd 2 and 4, the backward's passes 1
             each way; each step's host ms and its peak memory over what
             the model holds, with remat and without.
14. p15a   — the device analytics solvers on the analytics graph,
             rmat(19, 16) symmetric: K14 first_fit against its plain
             version on the solve's first round, on random colours with
             60% of the rows active and on random colours below 3 (every
             colour taken), exactly, at rmat19 and at rmat13 behind the
             NaN-dirtied allocator, timed beside its bound; color, every
             count set to 0 just before it, valid by coloring_valid, one K14
             launch a round, with its rounds and seconds, K14's device ms
             summed over a warm solve and the active rows of its first five
             rounds (its loop repeated with the rows read, equal to
             color's colours); cf_train on
             seeded ratings, its RMSE falling, one sddmm_dot_ell and one K1
             launch an iteration, and at rmat16 equal to its CPU run
             within rtol 1e-4; boruvka_mst's total equal to scipy's minimum
             spanning tree (and at rmat13 to kruskal_oracle); khop_sample
             and random_walk, every drawn pair an edge; deepwalk and
             node2vec at rmat14, finite; knn_search against a float64
             brute force; ``cli analytics color|cf|sample|embed`` side by
             side, each Correct on the card.
15. p15b   — the pattern solvers. The NLF's SpMM on K1 at rmat(13, 16)
             with 4 seeded labels (unit weights, the (nv, 4) one-hot)
             behind the NaN-dirtied allocator, equal to the plain
             index_add_ exactly, timed beside its bound, its plain version,
             index_add_ and torch.sparse.mm; neighborhood_label_frequency,
             one K1 launch, equal to the host route. motif_counts(g, 3 and
             4) and induced_motif_counts at rmat13, every count equal to an
             exact oracle of scipy's int64 sparse products; motif_counts(g,
             4) at rmat(14, 16) (16,384 vertices, the dense path's full
             width) timed cold and warm with its device ms by kernel and
             its peak memory, its triangle equal to K9's triangle_count and
             its wedge and 3-star to the degree forms. fsm at rmat10 on the
             card equal to the same call on the CPU; at rmat13 timed, two
             K1 launches (one NLF each for the edges and the wedges), its
             edge supports equal to the fsm route's edge-list check. ``cli
             analytics motif <dir> 4`` and ``analytics fsm <dir>`` side by
             side on rmat(12, 16) with vertex labels, each Correct on the
             card.
16. result — a JSON line of the twenty kernels, then the last line
             {"ok": true, "device": {...}}. Each phase prints its seconds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from graphaibench_tpu_torch import GnnDataset, native, rmat
from graphaibench_tpu_torch import parallel as PAR
from graphaibench_tpu_torch.analytics import ann as ANNM
from graphaibench_tpu_torch.analytics import bc as BCM
from graphaibench_tpu_torch.analytics import cc as CCM
from graphaibench_tpu_torch.analytics import cf as CFM
from graphaibench_tpu_torch.analytics import coloring as COL
from graphaibench_tpu_torch.analytics import embedding as EMBM
from graphaibench_tpu_torch.analytics import fsm as FSMM
from graphaibench_tpu_torch.analytics import kcore as KCM
from graphaibench_tpu_torch.analytics import khop as KHOPM
from graphaibench_tpu_torch.analytics import motif as MOTM
from graphaibench_tpu_torch.analytics import mst as MSTM
from graphaibench_tpu_torch.analytics import pr as PRM
from graphaibench_tpu_torch.analytics import tc as TCM
from graphaibench_tpu_torch.analytics import tc_stream as TS
from graphaibench_tpu_torch.analytics import traversal as TR
from graphaibench_tpu_torch.analytics import verifiers
from graphaibench_tpu_torch.compress import cgr as CGR
from graphaibench_tpu_torch.compress import cgr_device as CD
from graphaibench_tpu_torch.compress import device_decode as DD
from graphaibench_tpu_torch.compress import hybrid as HYB
from graphaibench_tpu_torch.compress import vbyte as VB
from graphaibench_tpu_torch.graph import labels as LAB
from graphaibench_tpu_torch.graph.csr import CSRGraph, from_edges
from graphaibench_tpu_torch.graph.generators import grid2d
from graphaibench_tpu_torch.graph.io import save_graph
from graphaibench_tpu_torch.graph.transforms import (
    is_symmetric,
    orientation,
    reverse,
    sort_and_clean,
)
from graphaibench_tpu_torch.nn import Model, make_config
from graphaibench_tpu_torch.nn.layers import apply_model, init_params
from graphaibench_tpu_torch.nn.losses import masked_softmax_loss
from graphaibench_tpu_torch.nn.model import aggregation_weights, prepare_graph
from graphaibench_tpu_torch.nn.optim import OPTIMIZERS
from graphaibench_tpu_torch.ops import _build
from graphaibench_tpu_torch.ops import cgr_decode as K12
from graphaibench_tpu_torch.ops import ell_edge as EE
from graphaibench_tpu_torch.ops import ell_pull as K8
from graphaibench_tpu_torch.ops import ell_spmm as K1
from graphaibench_tpu_torch.ops import first_fit as FF
from graphaibench_tpu_torch.ops import fused_gat as FG
from graphaibench_tpu_torch.ops import hindex as K10
from graphaibench_tpu_torch.ops import math as gmath
from graphaibench_tpu_torch.ops import tc_count as K9
from graphaibench_tpu_torch.ops import vbyte_decode as K11
from graphaibench_tpu_torch.ops.device_graph import (
    pack_edge_values,
    pack_slot_values,
    to_device_graph,
    undirected_pairs,
)
from graphaibench_tpu_torch.ops.segment import segment_softmax
from graphaibench_tpu_torch.ops.spmm import sddmm_add, spmm
from graphaibench_tpu_torch.parallel import shard_ell as SE
from graphaibench_tpu_torch.utils.timers import OP_EVAL, OP_SAMPLE, OP_STEP, OpTimers

SCALE, EDGE_FACTOR = 17, 16
FEAT, HIDDEN, CLASSES = 128, 128, 16
EPOCHS = 5
BUCKETS = 5              # widths 4, 8, 16, 32, 64 at rmat17
# One SpMM is one kernel launch over all buckets.
SPMMS_PER_STEP = 3       # two forward, one adjoint (layer 1's input is constant)
SPMMS_PER_EVAL = 2
# Kernel vs plain: the kernel adds split rows' pieces (degree > 64) with
# atomics, in an order that changes from run to run, and sums each row in
# another order than the plain version's reduction; both are float32.
# Rows that are not split are stored, not added, and repeat bit for bit.
KERNEL_RTOL = KERNEL_ATOL = 1e-4
# The GAT passes against their plain versions: the same float32 reordering
# (a lane sums its columns' products over the slots before the group adds
# its lanes; atomics on split rows). A hub row sums thousands of terms of
# the size of the largest outputs, and the error of a float32 sum grows
# with the size of its terms, so the absolute tolerance is 1e-4 of the
# largest |plain| value (at least 1e-4); the row max is exact.
GAT_RTOL = GAT_ATOL_SCALE = 1e-4
GAT_KERNELS = {   # name -> line of the JAX pass it replaces
    "gat_rowmax": 285, "gat_v2_fwd": 309, "gat_v2_bwd_sl": 391,
    "gat_v2_bwd_h": 413, "gat_v2_bwd": 373}     # 373: both passes, _v2_bwd
GAT_WIDTHS = (7, 256, 33)   # untimed, behind the dirtied allocator
GAT_SMALL_SCALE = 13     # the whole op against the unfused path
EDGE_KERNELS = {  # name -> file:line of the JAX program it replaces
    "ell_row_reduce": "graphaibench_tpu/ops/segment.py:16",
    "gat_v1_fwd": "graphaibench_tpu/ops/fused_gat.py:36",
    "sddmm_dot_ell": "graphaibench_tpu/ops/spmm.py:307"}
MASK_KEEP = 0.7          # share of edges the random 0/1 mask keeps
EDGE_WIDTHS = (7, 33, 12, 256)   # untimed, behind the dirtied allocator
# Launches of one v1 GAT step per layer: forward the row max, the row sum
# of exp and gat_v1_fwd; backward K1 (dx), sddmm_dot_ell, the softmax
# adjoint's row sum, and the two row sums of sddmm_add's adjoint.
V1_ROW_REDUCES_PER_LAYER = (2, 3)      # forward, backward
SUBG_SIZE = 32768        # sampled main path: n_pad > 4096, the COO strategy
SAMPLED_VAL_INTERVAL = 2  # evaluations after epochs 2 and 4
SAMPLED_PROFILED_EPOCHS = 3
# Launches of the GAT main path (2 layers): per layer one gat_rowmax and
# one gat_v2_fwd forward; backward, by the size rule of
# ops/fused_gat.py::_single_pass, one gat_v2_bwd for the hidden layer
# (F = 128) and one gat_v2_bwd_sl and one gat_v2_bwd_h for the output layer
# (F = 16).
GAT_LAYERS = 2
GAT_STEP_LAUNCHES = {"gat_rowmax": GAT_LAYERS, "gat_v2_fwd": GAT_LAYERS,
                     "gat_v2_bwd": 1, "gat_v2_bwd_sl": 1, "gat_v2_bwd_h": 1}
# The card's published peaks (H100 SXM data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# Small-model trajectories, GPU vs CPU: the same float32 reordering,
# compounded over 5 Adam steps.
TRAJ_RTOL, TRAJ_ATOL = 1e-4, 1e-5
TIMED_CALLS = 20         # back-to-back calls between one pair of events
TIMED_BATCHES = 7
TIMED_EPOCHS = 20
PROFILED_EPOCHS = 10
# The analytics phase: the JAX package's analytics size, rmat(19, 16)
# symmetric; K8 also behind a dirtied allocator at rmat13; the
# high-diameter grid; a directed input; the CLI on a small dataset.
ANALYTICS_SCALE = 19
PULL_DIRTY_SCALE = 13
PULL_REPLACES = "graphaibench_tpu/ops/segment.py:124"
# K8 against its plain version: min, max and int32 sums exact; a float32
# sum adds in another order (atomics on split rows, in an order that
# changes from run to run): rtol 1e-5, atol 1e-6 of the largest |plain|.
PULL_FSUM_RTOL = 1e-5
PULL_FSUM_ATOL_SCALE = 1e-6
PULL_TIMED = ("float32 min packed", "int32 min", "float32 sum", "int32 sum")
PULL_HEAD = "float32 sum"          # the timed case with a library call
SOLVES = 3                         # warm solves timed after the checked one
SSSP_RTOL = 1e-5                   # run_benchmark's tolerance
PR_L1 = 1e-4                       # the solver's epsilon
GRID_SIDE = 512
DIRECTED_SCALE = 13
CLI_KERNELS = ("bfs", "sssp", "pr", "cc", "tc", "bc", "kcore")
# the CLI's dataset: rmat(13, 8), within the 200,000 edges up to which
# run_benchmark checks a triangle count against the serial count
CLI_EDGE_FACTOR = 8
TC_REPLACES = "graphaibench_tpu/analytics/tc.py:64"
HINDEX_REPLACES = "graphaibench_tpu/analytics/kcore.py:66"
TC_RMAT19 = 19_736_616     # scipy's count on rmat(19, 16, seed=0)
KCORE_SWEEPS_RMAT19 = 37   # the JAX package's sweeps on rmat(19, 16, seed=0)
# K9's wide row: a DAG row of more ids than the widest group's hash table
# takes (256 of 512 slots), the destination of many edges; K10's wide hub:
# a star of more leaves than a hub block's histogram (2,048 bins) and than
# the first design's 48 Ki values in shared memory, joined to rmat13
TC_WIDE_ROW = 1500
HINDEX_STAR_LEAVES = 50_000
# BC against the float64 reference: sigma and delta are float32 sums
BC_RTOL, BC_ATOL = 1e-4, 1e-6
# The compress phase: the analytics graph in CGR, plain and with intervals,
# decoded through K12 (name -> the JAX program it replaces); each decode's
# launches (prep and run); the CLI's dataset and schemes.
CGR_KERNELS = {
    "cgr_gamma": "graphaibench_tpu/compress/cgr_device.py:139",
    "cgr_interval": "graphaibench_tpu/compress/cgr_device.py:163",
    "cgr_residual": "graphaibench_tpu/compress/cgr_device.py:221",
    "cgr_merge": "graphaibench_tpu/compress/cgr_device.py:198",
}
CGR_DECODE_LAUNCHES = {
    False: {"cgr_gamma": 2, "cgr_residual": 1},
    True: {"cgr_gamma": 4, "cgr_interval": 1, "cgr_residual": 1,
           "cgr_merge": 1}}
# the default config, the same with intervals in 64-bit interval segments,
# and with the reference's 32-bit ones, which the device route refuses on
# this graph (an interval item outgrows its slot) and the host decodes
CGR_STREAMS = {
    "plain": CGR.CgrConfig(),
    "interval": CGR.CgrConfig(use_interval=True, itv_seg_len=64),
    "interval_seg32": CGR.CgrConfig(use_interval=True),
}
# integer operations a decoded code takes (leading zeros, two window shifts,
# the value's shift, the bias, nat2int or the gap, the store's address, the
# advance), over the float32 rate: the card's int32 rate is not in the data
# sheet
OPS_PER_CODE = 8
# the byte codecs decoded through K11 (name -> the JAX program it replaces),
# each decode's launches (the hybrid's low-degree rows go through K12's
# cgr_residual), and the integer operations a decoded value takes (its
# length, its offset, its bytes, the mask, the gap's sum, the store)
VBYTE_KERNELS = {
    "svb_decode": "graphaibench_tpu/compress/device_decode.py:47",
    "vgb_tags": "graphaibench_tpu/compress/device_decode.py:207",
    "vgb_values": "graphaibench_tpu/compress/device_decode.py:249",
}
VBYTE_DECODE_LAUNCHES = {
    "streamvbyte": {"svb_decode": 1},
    "varintgb": {"vgb_tags": 1, "vgb_values": 1},
    "hybrid": {"cgr_residual": 1, "svb_decode": 1},
}
OPS_PER_VALUE = 8
# the leaves of the star joined to rmat13 whose hub is a long VarintGB row
# and, in CGR with intervals, one long interval
DECODE_STAR_LEAVES = 50_000
# The sharded phase: GCN and GAT of the main path through the sharded
# trainer, one rank (nccl) for SHARDED_STEPS steps and two ranks on the one
# card (gloo, the exchange host-staged) for SHARDED_STEPS_TWO, held to
# Model's losses (rtol) and weights (atol); the launches per step on each
# rank: at P = 1 the halo tables are empty and the counts are Model's; at
# P = 2 K1 runs on the own and the halo table, forward (both layers) and
# adjoint (layer 2). Then each rank's rectangular tables, kernel against
# plain behind a dirtied allocator: those the two-rank run trains on
# (rmat17, P = 2, F = 128 and 16) and those of rmat13, P = 2.
SHARDED_STEPS = 5
SHARDED_STEPS_TWO = 3
SHARDED_RTOL = 1e-4
# Weights after free-running steps: atomics add split rows' pieces (and
# the single backward pass's d_sl) in an order that changes from run to
# run, and each Adam step turns the noise of a gradient near 0 into up to
# lr / sqrt(eps) times it, which the next steps compound. Two runs of
# Model itself differ by up to 7.6e-6 (GCN) and 9.0e-4 (GAT) after 5
# steps on an H100, as far as a 0.1% fault in one of GAT's gradients
# moves them (tools/sharded_probe.py, PERF.md). So the sharded phase
# prints that distance beside Model's own spread and holds the trainer
# where nothing compounds: Model follows it, taking its weights and its
# optimizer's state before each step, and both step. There the gradients
# are held element by element to the tensor-parallel phase's limits
# (TP_GRAD_RTOL, TP_GRAD_ATOL) and the weights within SHARDED_FOLLOW_ATOL,
# lr / sqrt(eps) = 100 times TP_GRAD_ATOL: the most one Adam step can make
# of a gradient difference at TP_GRAD_ATOL. The tensor-parallel trainers
# hold their weights after TP_STEPS to SHARDED_ATOL.
SHARDED_ATOL = {"gcn": 1e-4, "gat": 5e-4}
SHARDED_FOLLOW_ATOL = 1e-4
SHARDED_STEP_LAUNCHES = {"gcn": {"ell_spmm": SPMMS_PER_STEP},
                         "gat": GAT_STEP_LAUNCHES}
SHARDED_TWO_RANK_LAUNCHES = {"gcn": {"ell_spmm": 6}, "gat": GAT_STEP_LAUNCHES}
SHARDED_RECT_SCALE = 13
SHARDED_RECT_WIDTHS = (128, 16, 7)
SHARDED_MAIN_RECT_WIDTHS = (128, 16)
SHARDED_SPAWN_TIMEOUT_S = 600
# The tp_dp phase: the tensor-parallel trainer at the main path's widths,
# (1 graph x 2 model) ranks for GCN and GAT (l2norm and dense head, as
# make_config gives GAT) and (2 x 2) for GCN, two and four gloo ranks on
# the one card, held to Model like the sharded phase and, on the first
# step's summed gradients, within the gradient tolerance of the CPU tests
# (Adam would hide a constant factor in them); the rank tables'
# kernels at the column blocks' width (64) and a ragged one; two
# data-parallel GraphSAINT ranks, the first step's averaged gradients held
# to the serial mean within the gradient tolerance of the CPU tests; the
# (1 x 2) GCN trainer rebuilt from shard files.
TP_M = 2
TP_STEPS = 3
TP_HALO_STEPS = 2
TP_KERNEL_WIDTHS = (HIDDEN // TP_M, 5)
TP_GRAD_RTOL, TP_GRAD_ATOL = 1e-4, 1e-6
# the file-built trainer's first loss: the same tables and weights as the
# in-memory one's, but K1 adds the pieces of a split row with atomics, in
# an order a launch does not fix, so its float sums may differ in the
# last bits from run to run (the CPU tests hold it exactly)
TP_FILE_RTOL = 1e-6
DP_RANKS = 2
DP_STEPS = 3
# The dist_analytics phase: the distributed solvers on the analytics graph
# at one nccl rank and at DIST_RANKS gloo ranks sharing the card, BC from
# one source; BFS's "unreached" in their form; PageRank against the
# single-device solver within the CPU tests' tolerance against JAX (K1's
# and K8's float sums add in other orders).
DIST_RANKS = 2
DIST_BC_SOURCE = 0
DIST_INF = 2**30
DIST_PR_RTOL, DIST_PR_ATOL = 1e-4, 1e-7
# the CLI's analytics on each scheme's prefix, decoded on the card
REMAT_FEAT_DROP = 0.5
REMAT_SCORE_DROP = 0.3
REMAT_SAGE_LAYERS, REMAT_SAGE_HIDDEN = 3, 256   # the convergence recipe
REMAT_STEPS = 3
# remat gradients against plain, over each tensor's largest: the recompute
# runs K1 and gat_v2_bwd again, whose atomics add in no fixed order
REMAT_GRAD_RTOL = 1e-4
# launches a step, without remat and with it, by arch (held on the CPU by
# tests/test_torch_remat.py): a remat step runs a layer's forward SpMM or
# GAT v2 passes again where the backward needs a tensor saved after them
REMAT_STEP_LAUNCHES = {
    "gcn": ({"ell_spmm": 3}, {"ell_spmm": 4}),
    "sage": ({"ell_spmm": 5}, {"ell_spmm": 8}),
    "ggnn": ({"ell_spmm": 1}, {"ell_spmm": 2}),
    "gat": ({"gat_rowmax": 2, "gat_v2_fwd": 2, "gat_v2_bwd": 1,
             "gat_v2_bwd_sl": 1, "gat_v2_bwd_h": 1},
            {"gat_rowmax": 4, "gat_v2_fwd": 4, "gat_v2_bwd": 1,
             "gat_v2_bwd_sl": 1, "gat_v2_bwd_h": 1}),
}
FIRST_FIT_REPLACES = "graphaibench_tpu/analytics/coloring.py:23"
CF_CPU_SCALE = 16          # cf_train on the card against the CPU
CF_RTOL = 1e-4
WALK_LENGTH = 10
EMBED_SCALE = 14           # deepwalk and node2vec: 16,384 vertices
KNN_N, KNN_Q, KNN_K = 100_000, 256, 10
KNN_GAP = 1e-3             # float64 scores this far apart order alike
P15A_CLI = (("color",), ("cf",), ("sample",), ("embed", "deepwalk"),
            ("embed", "node2vec"))
P15B_SCALE = 13            # NLF on K1, motif against the oracle, FSM timed
P15B_FULL_SCALE = 14       # motif k = 4 at 16,384 vertices: the dense width
P15B_FSM_CPU_SCALE = 10    # fsm on the card against the CPU
P15B_CLI_SCALE = 12        # ne 101,406: the motif route checks to 200,000
P15B_LABELS = 4
# rmat(13, 16, seed=0): 6T, tr(A^4) and 24 K4 in scipy's int64 products
P15B_ORACLE_SUMS = (1_692_990, 196_745_886, 12_979_728)
CLI_DECODED = {"cgr": ("tc", "bfs"), "streamvbyte": ("tc",),
               "varintgb": ("tc", "bfs"), "hybrid": ("tc", "bfs")}
CLI_SCHEMES = {"cgr": ("-s", "cgr"), "cgr_word_p": ("-s", "cgr", "-a", "word",
                                                    "-p"),
               "streamvbyte": ("-s", "streamvbyte"),
               "varintgb": ("-s", "varintgb"), "hybrid": ("-s", "hybrid")}


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device: "
                           "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    name = torch.cuda.get_device_name(0)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device 0: {name}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = _build.build()
    for name in libs:
        _build.load_library(name)
    dt = time.perf_counter() - t0
    print(f"[build] {[so.name for so in libs.values()]} in {dt:.2f} s")
    for name, so in libs.items():
        for line in so.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[build] {name}: {line.strip()}")


def _batch_ms(fn, calls: int = TIMED_CALLS,
              batches: int = TIMED_BATCHES) -> float:
    """Device time of one call: ``calls`` back-to-back calls between one
    pair of events, divided by the count; the median of ``batches``. One
    event pair per call would read the host's enqueue for a kernel this
    short. The inputs stay as the last call left them in L2."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _kernel_device_ms(fn, kernel: str, calls: int = TIMED_CALLS,
                      at_least_ms: float | None = None):
    """Device time of one launch of the kernel whose name contains
    ``kernel``: the mean over ``calls`` calls of ``fn`` under
    torch.profiler. ``_batch_ms`` reads the host's enqueue instead where a
    call's host work (allocating and initialising outputs, the ctypes
    call) outlasts a short kernel. A trace is read only when the kernel's
    events are none of them empty and, with ``at_least_ms`` (for a kernel
    that holds most of its call's batch time), their mean is no less; an
    event the profiler drops does not move the mean. The profiler now and
    then hands back no device event, or events it timed short, so it is
    asked up to five times; None, with the reason printed, when no trace
    passed."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    why = "no device event"
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and kernel in e.name]
        if not us:
            continue
        ms = statistics.mean(us) / 1e3
        if min(us) <= 0:
            why = f"an empty event of {len(us)}"
        elif at_least_ms is not None and ms < at_least_ms:
            why = f"{ms:.4f} ms, below {at_least_ms:.4f}"
        else:
            return ms
    print(f"[profile] {kernel}: no device time read ({why})")
    return None


def _device_ms_by_name(fn, calls: int,
                       at_least_ms: float | None = None) -> dict:
    """Device ms a call of ``fn`` of every kernel (and memset or copy) it
    launches, by name, over ``calls`` calls under torch.profiler; asked up
    to five times, as ``_kernel_device_ms``, while no device event comes
    back or, with ``at_least_ms``, the names' sum a call falls below it;
    {}, with the reason printed, when no trace passed."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    why = "no device event"
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us()
        if not by:
            continue
        total = sum(by.values()) / calls / 1e3
        if at_least_ms is not None and total < at_least_ms:
            why = f"{total:.4f} ms a call, below {at_least_ms:.4f}"
        else:
            return {k: v / calls / 1e3 for k, v in sorted(by.items())}
    print(f"[profile] no device times read ({why})")
    return {}


def _bound(dg, f: int) -> tuple[float, str, int]:
    """The least time the card could take for one SpMM at width ``f``,
    in ms, what bounds it, and the bytes: x read once, the slot ids and
    weights, row ids and split flags read once, the output written once,
    over the memory rate; against 2 FLOP per slot and feature over the
    float32 rate. Slots count the ELL layout's padding: it is the input."""
    slots = sum(b.nbr.numel() for b in dg.ell)
    rows = sum(b.rows for b in dg.ell)
    nbytes = 2 * dg.nv * f * 4 + slots * 8 + rows * 4 + dg.nv
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = 2 * slots * f / F32_FLOP_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations", nbytes


def _compare(dg, w, x, what: str, dirty: bool = False) -> float:
    """Max |kernel - plain| on one input; raises beyond the tolerance.
    With ``dirty``, the allocator's free block of the output's size is
    filled with NaN first, so a row the kernel does not write shows."""
    if dirty:
        junk = torch.full((dg.nv, x.shape[1]), float("nan"), device="cuda")
        del junk
    out_k = K1.ell_spmm(dg, w, x)
    out_p = K1.ell_spmm_plain(dg, w, x)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    if not torch.allclose(out_k, out_p, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
        raise RuntimeError(f"kernel disagrees with plain at {what}: "
                           f"max |diff| {err}")
    again = K1.ell_spmm(dg, w, x)
    unsplit = dg.is_split == 0
    if not torch.equal(again[unsplit], out_k[unsplit]):
        raise RuntimeError(f"unsplit rows did not repeat bit for bit at {what}")
    return err


def phase_kernel(g) -> tuple[list[dict], float]:
    gp = prepare_graph(g, "gcn")
    dg = to_device_graph(gp, device="cuda")
    raw = torch.from_numpy(aggregation_weights(gp, "gcn")).cuda()
    wp = pack_edge_values(dg, raw)
    slots = sum(b.nbr.numel() for b in dg.ell)
    print(f"[kernel] rmat{SCALE} nv={dg.nv} ne={dg.ne} slots={slots} "
          f"buckets={[(b.width, b.rows) for b in dg.ell]} "
          f"split_rows={int(dg.is_split.sum())} zero_rows={dg.zero_rows.numel()}")
    if len(dg.ell) != BUCKETS:
        raise RuntimeError(f"expected {BUCKETS} buckets, got {len(dg.ell)}")
    # the library call's operands: the same graph and weights as one CSR
    # tensor per view (the graph is symmetric, so the transpose has the
    # same structure and the permuted weights)
    csr = {view: torch.sparse_csr_tensor(dg.row_ptr, dg.col_idx, vals,
                                         size=(dg.nv, dg.nv))
           for view, vals in (("fwd", raw), ("t", raw[dg.trans_perm.long()]))}
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for f in (FEAT, CLASSES):
        x = torch.randn(dg.nv, f, device="cuda", generator=gen)
        bound_ms, bound_by, nbytes = _bound(dg, f)
        for view in ("fwd", "t"):
            w = getattr(wp, view)
            err = _compare(dg, w, x, f"F={f} view={view}")
            if not w.launch_table.vec_ok:
                raise RuntimeError("the main path's buckets must take the "
                                   "kernel's vector instantiation")
            out_l = torch.sparse.mm(csr[view], x)
            if not torch.allclose(out_l, K1.ell_spmm_plain(dg, w, x),
                                  rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
                raise RuntimeError(f"torch.sparse.mm disagrees with plain at "
                                   f"F={f} view={view}")
            ms = _batch_ms(lambda: K1.ell_spmm(dg, w, x))
            plain_ms = _batch_ms(lambda: K1.ell_spmm_plain(dg, w, x),
                                 calls=5, batches=3)
            library_ms = _batch_ms(lambda: torch.sparse.mm(csr[view], x))
            device_ms = _kernel_device_ms(lambda: K1.ell_spmm(dg, w, x),
                                          "ell_spmm_kernel")
            case = {"F": f, "view": view, "tile": K1._tile_floats(dg.nv, f),
                    "max_abs_err": err, "ms": ms, "device_ms": device_ms,
                    "plain_ms": plain_ms, "library_ms": library_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "bound_bytes": nbytes, "share_of_bound": bound_ms / ms,
                    "edges_per_s": dg.ne / (ms * 1e-3)}
            print(f"[kernel] {json.dumps(case)}")
            cases.append(case)
    # F = 7 takes the kernel's scalar instantiation (F % 4 != 0)
    x7 = torch.randn(dg.nv, 7, device="cuda", generator=gen)
    err7 = _compare(dg, wp.fwd, x7, "F=7 (scalar)", dirty=True)
    print(f"[kernel] F=7 scalar instantiation: max_abs_err {err7}, "
          f"{_batch_ms(lambda: K1.ell_spmm(dg, wp.fwd, x7)):.4f} ms")
    # F < 4 takes its narrow instantiation (a thread a virtual row)
    errn = []
    for f in (1, 2, 3):
        xn = torch.randn(dg.nv, f, device="cuda", generator=gen)
        errn.append(_compare(dg, wp.fwd, xn, f"F={f} (narrow)", dirty=True))
    print(f"[kernel] F=1-3 narrow instantiation: max_abs_err {max(errn)}, "
          f"F=3 {_batch_ms(lambda: K1.ell_spmm(dg, wp.fwd, xn)):.4f} ms")
    # no self-loops (the SAGE preparation): rows of degree 0 have no
    # virtual row, so only the wrapper's zeroing covers them
    gs = prepare_graph(g, "sage")
    dgs = to_device_graph(gs, device="cuda")
    empty = int((dgs.deg == 0).sum())
    if empty == 0:
        raise RuntimeError("the graph without self-loops has no row of "
                           "degree 0: the case checks nothing")
    wps = pack_edge_values(dgs, torch.from_numpy(
        aggregation_weights(gs, "sage")).cuda())
    errs = []
    for f in (CLASSES, 7, 1):
        xs = torch.randn(dgs.nv, f, device="cuda", generator=gen)
        for view in ("fwd", "t"):
            errs.append(_compare(dgs, getattr(wps, view), xs,
                                 f"no self-loops F={f} view={view}", dirty=True))
    print(f"[kernel] no self-loops: {empty} rows of degree 0, "
          f"{dgs.zero_rows.numel()} zeroed rows, dirtied allocator, "
          f"F in (16, 7, 1) x (fwd, t): max_abs_err {max(errs)}")
    return cases, max(err7, *errn, *errs)


def _gat_close(got, want, what: str) -> float:
    """Max |kernel - plain|; raises beyond rtol 1e-4 and an absolute
    tolerance of 1e-4 of the largest |plain| (at least 1e-4)."""
    err = float((got - want).abs().max())
    atol = GAT_ATOL_SCALE * max(1.0, float(want.abs().max()))
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{what}: the kernel's output is not finite")
    if not torch.allclose(got, want, rtol=GAT_RTOL, atol=atol):
        raise RuntimeError(f"{what}: kernel disagrees with plain, "
                           f"max |diff| {err} (atol {atol})")
    return err


def _gat_bounds(dg, f: int) -> dict[str, tuple[float, str, int]]:
    """Per GAT pass: the least time the card could take, in ms, what
    bounds it, and the bytes. Bytes: every input read once and every
    output written once — the ids of the real slots (the passes skip the
    pads), the row ids, valid counts and split flags, the (nv,) vectors
    and the (nv, F) matrices. Operations: per real slot the multiply-adds
    over F and some ten scalar ones (exp counted as one)."""
    rows = sum(b.rows for b in dg.ell)
    ids = dg.ne * 4 + rows * 8 + dg.nv
    vec, mat = dg.nv * 4, dg.nv * f * 4
    work = {
        "gat_rowmax": (ids + 2 * vec, dg.ne),
        "gat_v2_fwd": (ids + 4 * vec + 2 * mat, dg.ne * (2 * f + 6)),
        "gat_v2_bwd_sl": (ids + 6 * vec + 2 * mat, dg.ne * (2 * f + 10)),
        "gat_v2_bwd_h": (ids + 6 * vec + 3 * mat, dg.ne * (4 * f + 12)),
        # as gat_v2_bwd_h, and d_sl written
        "gat_v2_bwd": (ids + 7 * vec + 3 * mat, dg.ne * (4 * f + 13)),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = ops / F32_FLOP_PER_S * 1e3
        out[name] = (max(by_bytes, by_ops),
                     "bytes" if by_bytes >= by_ops else "operations", nbytes)
    return out


def _gat_passes(dg, f: int, gen, what: str, dirty: bool, timed: bool):
    """The five kernels against their plain versions on one graph and
    width, each on the same inputs (the later passes take the plain
    forward's m, zinv and out). Returns {name: case}."""
    nv = dg.nv
    sl = torch.randn(nv, device="cuda", generator=gen)
    sr = torch.randn(nv, device="cuda", generator=gen)
    h = torch.randn(nv, f, device="cuda", generator=gen)
    ct = torch.randn(nv, f, device="cuda", generator=gen)

    def run(fn, *args):
        if dirty:   # a row the kernel does not write shows as NaN
            junk = [torch.full((nv, f), float("nan"), device="cuda"),
                    torch.full((nv,), float("nan"), device="cuda")]
            del junk
        return fn(dg, *args)

    m0_p = FG.gat_rowmax_plain(dg, sr)
    m0 = run(FG.gat_rowmax, sr)
    if not torch.equal(m0, m0_p):
        raise RuntimeError(f"{what}: gat_rowmax differs from plain")
    m = FG._leaky(sl + torch.where(torch.isfinite(m0_p), m0_p,
                                   torch.zeros_like(m0_p)))
    acc_p, z_p = FG.gat_v2_fwd_plain(dg, sl, sr, m, h)
    acc, z = run(FG.gat_v2_fwd, sl, sr, m, h)
    zinv = 1.0 / torch.clamp(z_p, min=FG.Z_FLOOR)
    inner = (ct * acc_p * zinv[:, None]).sum(1)
    bwd = (sl, sr, m, zinv, inner, h, ct)
    d_sl_p = FG.gat_v2_bwd_sl_plain(dg, *bwd)
    d_sl = run(FG.gat_v2_bwd_sl, *bwd)
    d_h_p, d_sr_p = FG.gat_v2_bwd_h_plain(dg, *bwd)
    d_h, d_sr = run(FG.gat_v2_bwd_h, *bwd)
    one = run(FG.gat_v2_bwd, *bwd)
    one_p = FG.gat_v2_bwd_plain(dg, *bwd)
    torch.cuda.synchronize()
    errs = {
        "gat_rowmax": 0.0,
        "gat_v2_fwd": max(_gat_close(acc, acc_p, f"{what} acc"),
                          _gat_close(z, z_p, f"{what} z")),
        "gat_v2_bwd_sl": _gat_close(d_sl, d_sl_p, f"{what} d_sl"),
        "gat_v2_bwd_h": max(_gat_close(d_h, d_h_p, f"{what} d_h"),
                            _gat_close(d_sr, d_sr_p, f"{what} d_sr")),
        "gat_v2_bwd": max(
            _gat_close(got, want, f"{what} single pass {name}")
            for got, want, name in zip(one, one_p, ("d_sl", "d_sr", "d_h"))),
    }
    # the single pass's plain version against the two passes' plain versions
    for got, want, name in zip(one_p, (d_sl_p, d_sr_p, d_h_p),
                               ("d_sl", "d_sr", "d_h")):
        _gat_close(got, want, f"{what} plain single pass {name}")
    cases = {name: {"F": f, "max_abs_err": err} for name, err in errs.items()}
    for name in GAT_KERNELS:
        if name != "gat_rowmax":
            rule = (FG._fwd_tile_floats if name == "gat_v2_fwd"
                    else FG._bwd_tile_floats)
            cases[name]["tile"] = rule(nv, f) if f % 4 == 0 else min(f, 32)
    if not timed:
        return cases
    calls = {
        "gat_rowmax": (FG.gat_rowmax, FG.gat_rowmax_plain, (sr,)),
        "gat_v2_fwd": (FG.gat_v2_fwd, FG.gat_v2_fwd_plain, (sl, sr, m, h)),
        "gat_v2_bwd_sl": (FG.gat_v2_bwd_sl, FG.gat_v2_bwd_sl_plain, bwd),
        "gat_v2_bwd_h": (FG.gat_v2_bwd_h, FG.gat_v2_bwd_h_plain, bwd),
        "gat_v2_bwd": (FG.gat_v2_bwd, FG.gat_v2_bwd_plain, bwd),
    }
    bounds = _gat_bounds(dg, f)
    for name, (kernel, plain, args) in calls.items():
        ms = _batch_ms(lambda: kernel(dg, *args))
        # the single pass is gat_v2_bwd_h's kernel with d_sl to add into
        device_ms = _kernel_device_ms(
            lambda: kernel(dg, *args),
            f"{'gat_v2_bwd_h' if name == 'gat_v2_bwd' else name}_kernel")
        plain_ms = _batch_ms(lambda: plain(dg, *args), calls=3, batches=3)
        bound_ms, bound_by, nbytes = bounds[name]
        cases[name].update(
            ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=None,
            bound_ms=bound_ms,
            bound_by=bound_by, bound_bytes=nbytes,
            share_of_bound=bound_ms / ms, edges_per_s=dg.ne / (ms * 1e-3))
        print(f"[kernel] {name} {json.dumps(cases[name])}")
    return cases


def _gat_unfused(dg, sl, sr, h):
    logits = gmath.leaky_relu(sddmm_add(dg, sl, sr), 0.2)
    return spmm(dg, segment_softmax(dg, logits), h, "ell")


def phase_gat_kernels(g) -> dict[str, dict]:
    """{kernel: {"cases": [timed cases], "max_abs_err": over every case}}."""
    dg = to_device_graph(prepare_graph(g, "gat"), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    res = {name: {"cases": [], "max_abs_err": 0.0} for name in GAT_KERNELS}

    def fold(cases, timed):
        for name, case in cases.items():
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"],
                                           case["max_abs_err"])
            if timed:
                res[name]["cases"].append(case)

    for f in (FEAT, CLASSES):
        fold(_gat_passes(dg, f, gen, f"F={f}", dirty=False, timed=True), True)
    # F = 7: float columns; 256: two tiles; 33: float columns in two tiles
    for f in GAT_WIDTHS:
        fold(_gat_passes(dg, f, gen, f"F={f}", dirty=True, timed=False), False)
    dgs = to_device_graph(prepare_graph(g, "sage"), device="cuda")
    if int((dgs.deg == 0).sum()) == 0:
        raise RuntimeError("the graph without self-loops has no row of "
                           "degree 0: the case checks nothing")
    for f in (CLASSES, 7):
        fold(_gat_passes(dgs, f, gen, f"no self-loops F={f}", dirty=True,
                         timed=False), False)
    print(f"[kernel] GAT passes at F in {GAT_WIDTHS} and on the graph "
          f"without self-loops ({int((dgs.deg == 0).sum())} rows of degree 0, dirtied "
          f"allocator): max_abs_err "
          f"{ {n: r['max_abs_err'] for n, r in res.items()} }")

    # the whole differentiable op against the port's unfused path
    gs = prepare_graph(rmat(GAT_SMALL_SCALE, 8, seed=1), "gat")
    dg13 = to_device_graph(gs, device="cuda")
    ct = torch.randn(dg13.nv, CLASSES, device="cuda", generator=gen)
    outs = []
    base = [torch.randn(dg13.nv, device="cuda", generator=gen),
            torch.randn(dg13.nv, device="cuda", generator=gen),
            torch.randn(dg13.nv, CLASSES, device="cuda", generator=gen)]
    # the op as its size rule runs it here (two backward passes), with the
    # single pass forced, and the unfused path
    rule = FG._single_pass
    for fn, single in ((FG.gat_attention_spmm_v2, False),
                       (FG.gat_attention_spmm_v2, True), (_gat_unfused, False)):
        sl, sr, h = (t.clone().requires_grad_(True) for t in base)
        FG._single_pass = (lambda nv, f: True) if single else rule
        try:
            out = fn(dg13, sl, sr, h)
            (out * ct).sum().backward()
        finally:
            FG._single_pass = rule
        outs.append((out.detach(), sl.grad, sr.grad, h.grad))
    errs = [max(_gat_close(a, c, f"fused vs unfused {what}"),
                _gat_close(b, c, f"fused (single pass) vs unfused {what}"))
            for a, b, c, what in zip(*outs, ("out", "d_sl", "d_sr", "d_h"))]
    print(f"[kernel] gat_attention_spmm_v2 (backward in two passes and in "
          f"one) vs the unfused path at rmat{GAT_SMALL_SCALE} F={CLASSES}: "
          f"max_abs_err out/d_sl/d_sr/d_h {errs}")
    return res


def _edge_bounds(dg, f: int) -> dict[str, tuple[float, str, int]]:
    """Per pass over per-edge values: the least time the card could take,
    in ms, what bounds it, and the bytes. Bytes: every input read once and
    every output written once — per real slot its edge id and, for the two
    wide passes, its neighbour id (the passes skip the pads), the row ids
    and valid counts, the split flags where rows are combined, the (ne,)
    and (nv,) vectors and the (nv, F) matrices. Operations: per real slot
    the multiply-adds over F and a few scalar ones (exp counted as one)."""
    rows = sum(b.rows for b in dg.ell)
    eids = dg.ne * 4 + rows * 8
    evec, vec, mat = dg.ne * 4, dg.nv * 4, dg.nv * f * 4
    work = {
        "ell_row_reduce max": (eids + dg.nv + evec + vec, dg.ne),
        "ell_row_reduce sum": (eids + dg.nv + evec + vec, dg.ne),
        "ell_row_reduce sumexp": (eids + dg.nv + evec + 2 * vec, 2 * dg.ne),
        "gat_v1_fwd": (eids + dg.ne * 4 + dg.nv + 2 * evec + 2 * vec + 2 * mat,
                       dg.ne * (2 * f + 4)),
        "gat_v1_fwd with scores": (
            eids + dg.ne * 4 + dg.nv + 3 * evec + 2 * vec + 2 * mat,
            dg.ne * (2 * f + 4)),
        "sddmm_dot_ell": (eids + dg.ne * 4 + 2 * mat + evec, dg.ne * 2 * f),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = ops / F32_FLOP_PER_S * 1e3
        out[name] = (max(by_bytes, by_ops),
                     "bytes" if by_bytes >= by_ops else "operations", nbytes)
    return out


def _edge_passes(dg, f: int, gen, what: str, dirty: bool, timed: bool,
                 reduces: bool = True):
    """The three kernels of csrc/ell_edge.cu against their plain versions
    on one graph and width, each on the same inputs (gat_v1_fwd takes the
    plain passes' m and zinv, and is held to its plain version with and
    without the scores), with a random 0/1 mask as edge weights.
    Returns {case name: case}; ``reduces`` says whether ell_row_reduce,
    which does not depend on F, is among them."""
    nv, ne = dg.nv, dg.ne
    logits = 2.0 * torch.randn(ne, device="cuda", generator=gen)
    mask = (torch.rand(ne, device="cuda", generator=gen) < MASK_KEEP).float()
    x = torch.randn(nv, f, device="cuda", generator=gen)
    ct = torch.randn(nv, f, device="cuda", generator=gen)

    def run(fn, *args):
        if dirty:   # an element the kernel does not write shows as NaN
            junk = [torch.full((nv, f), float("nan"), device="cuda"),
                    torch.full((nv,), float("nan"), device="cuda"),
                    torch.full((ne,), float("nan"), device="cuda")]
            del junk
        return fn(dg, *args)

    m_p = EE.ell_row_reduce_plain(dg, logits, "max")
    m = torch.where(torch.isfinite(m_p), m_p, torch.zeros_like(m_p))
    z_p = EE.ell_row_reduce_plain(dg, logits, "sumexp", m)
    zinv = 1.0 / torch.clamp(z_p, min=FG.Z_FLOOR)
    errs = {}
    if reduces:
        if not torch.equal(run(EE.ell_row_reduce, logits, "max"), m_p):
            raise RuntimeError(f"{what}: ell_row_reduce max differs from plain")
        errs["ell_row_reduce max"] = 0.0
        errs["ell_row_reduce sum"] = _gat_close(
            run(EE.ell_row_reduce, logits, "sum"),
            EE.ell_row_reduce_plain(dg, logits, "sum"), f"{what} row sum")
        errs["ell_row_reduce sumexp"] = _gat_close(
            run(EE.ell_row_reduce, logits, "sumexp", m), z_p,
            f"{what} row sumexp")
    v1 = (logits, mask, x, m, zinv)
    out_p, scores_p = EE.gat_v1_fwd_plain(dg, *v1, True)
    errs["gat_v1_fwd"] = _gat_close(run(EE.gat_v1_fwd, *v1), out_p,
                                    f"{what} gat_v1_fwd")
    out_s, scores = run(EE.gat_v1_fwd, *v1, True)
    errs["gat_v1_fwd with scores"] = max(
        _gat_close(out_s, out_p, f"{what} gat_v1_fwd beside its scores"),
        _gat_close(scores, scores_p, f"{what} gat_v1_fwd's scores"))
    raw_p = EE.sddmm_dot_ell_plain(dg, ct, x)
    errs["sddmm_dot_ell"] = _gat_close(run(EE.sddmm_dot_ell, ct, x), raw_p,
                                       f"{what} sddmm_dot_ell")
    torch.cuda.synchronize()
    cases = {name: {"F": f, "max_abs_err": err} for name, err in errs.items()}
    if not timed:
        return cases
    # the one PyTorch call that computes the same function, where there is
    # one; timed here and used nowhere on a CUDA graph with ELL buckets
    src = dg.edge_src.long()
    pattern = torch.sparse_csr_tensor(dg.row_ptr, dg.col_idx,
                                      torch.zeros(ne, device="cuda"),
                                      size=(nv, nv))
    xt = x.t().contiguous()
    library = {
        "ell_row_reduce max": lambda: torch.full(
            (nv,), float("-inf"), device="cuda").scatter_reduce_(
                0, src, logits, "amax"),
        "ell_row_reduce sum": lambda: torch.zeros(nv, device="cuda").index_add_(
            0, src, logits),
        "sddmm_dot_ell": lambda: torch.sparse.sampled_addmm(
            pattern, ct, xt, beta=0.0),
    }
    for name, want in (("ell_row_reduce max", m_p),
                       ("ell_row_reduce sum",
                        EE.ell_row_reduce_plain(dg, logits, "sum")),
                       ("sddmm_dot_ell", raw_p)):
        got = library[name]()
        got = got.values() if got.layout == torch.sparse_csr else got
        _gat_close(got, want, f"{what} library call for {name}")
    calls = {
        "ell_row_reduce max": (EE.ell_row_reduce, EE.ell_row_reduce_plain,
                               (logits, "max")),
        "ell_row_reduce sum": (EE.ell_row_reduce, EE.ell_row_reduce_plain,
                               (logits, "sum")),
        "ell_row_reduce sumexp": (EE.ell_row_reduce, EE.ell_row_reduce_plain,
                                  (logits, "sumexp", m)),
        "gat_v1_fwd": (EE.gat_v1_fwd, EE.gat_v1_fwd_plain, v1),
        "gat_v1_fwd with scores": (EE.gat_v1_fwd, EE.gat_v1_fwd_plain,
                                   (*v1, True)),
        "sddmm_dot_ell": (EE.sddmm_dot_ell, EE.sddmm_dot_ell_plain, (ct, x)),
    }
    bounds = _edge_bounds(dg, f)
    for name in cases:
        kernel, plain, args = calls[name]
        ms = _batch_ms(lambda: kernel(dg, *args))
        device_ms = _kernel_device_ms(lambda: kernel(dg, *args),
                                      f"{name.split()[0]}_kernel")
        plain_ms = _batch_ms(lambda: plain(dg, *args), calls=3, batches=3)
        library_ms = _batch_ms(library[name]) if name in library else None
        bound_ms, bound_by, nbytes = bounds[name]
        cases[name].update(
            ms=ms, device_ms=device_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            bound_bytes=nbytes, share_of_bound=bound_ms / ms,
            edges_per_s=ne / (ms * 1e-3))
        if name.startswith("gat_v1") or name.startswith("sddmm"):
            cases[name]["tile"] = (EE._v1_tile_floats(nv, f)
                                   if name.startswith("gat_v1") else f)
        print(f"[kernel] {name} {json.dumps(cases[name])}")
    return cases


def _v1_unfused(dg, logits, w, x):
    return spmm(dg, segment_softmax(dg, logits) * w, x, "ell")


def phase_edge_kernels(g) -> dict[str, dict]:
    """{kernel: {"cases": [timed cases], "max_abs_err": over every case}}
    for ell_row_reduce (cases: its three kinds), gat_v1_fwd (cases: F = 128
    and 16, each without and with the scores) and sddmm_dot_ell (cases:
    F = 128 and 16)."""
    dg = to_device_graph(prepare_graph(g, "gat"), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    res = {name: {"cases": [], "max_abs_err": 0.0} for name in EDGE_KERNELS}

    def fold(cases, timed):
        for name, case in cases.items():
            kernel = name.split()[0]
            res[kernel]["max_abs_err"] = max(res[kernel]["max_abs_err"],
                                             case["max_abs_err"])
            if timed:
                res[kernel]["cases"].append(dict(case, case=name))

    for f in (FEAT, CLASSES):
        fold(_edge_passes(dg, f, gen, f"F={f}", dirty=False, timed=True,
                          reduces=f == FEAT), True)
    # F = 7 and 33: float columns, 33 more of them than a group has lanes;
    # 12: three columns of V in a group of four lanes; 256: more float4
    # columns a lane than sddmm_dot_ell keeps in registers, two tiles for
    # gat_v1_fwd
    for f in EDGE_WIDTHS:
        fold(_edge_passes(dg, f, gen, f"F={f}", dirty=True, timed=False,
                          reduces=f == EDGE_WIDTHS[0]), False)
    dgs = to_device_graph(prepare_graph(g, "sage"), device="cuda")
    empty = int((dgs.deg == 0).sum())
    if empty == 0:
        raise RuntimeError("the graph without self-loops has no row of "
                           "degree 0: the case checks nothing")
    for f in (CLASSES, 7):
        fold(_edge_passes(dgs, f, gen, f"no self-loops F={f}", dirty=True,
                          timed=False), False)
    print(f"[kernel] passes over per-edge values at F in {EDGE_WIDTHS} and on "
          f"the graph without self-loops ({empty} rows of degree 0, dirtied allocator, "
          f"0/1 mask): max_abs_err "
          f"{ {n: r['max_abs_err'] for n, r in res.items()} }")

    # the v1 op and its three gradients against the port's unfused path
    dg13 = to_device_graph(prepare_graph(rmat(GAT_SMALL_SCALE, 8, seed=1),
                                         "gat"), device="cuda")
    ct = torch.randn(dg13.nv, CLASSES, device="cuda", generator=gen)
    base = [torch.randn(dg13.ne, device="cuda", generator=gen),
            (torch.rand(dg13.ne, device="cuda", generator=gen)
             < MASK_KEEP).float(),
            torch.randn(dg13.nv, CLASSES, device="cuda", generator=gen)]
    outs = []
    for fn in (FG.gat_attention_spmm, _v1_unfused):
        l, w, x = (t.clone().requires_grad_(True) for t in base)
        out = fn(dg13, l, w, x)
        (out * ct).sum().backward()
        outs.append((out.detach(), l.grad, w.grad, x.grad))
    errs = [_gat_close(a, b, f"v1 fused vs unfused {what}")
            for a, b, what in zip(*outs, ("out", "d_logits", "d_edge_w", "d_x"))]
    print(f"[kernel] gat_attention_spmm (v1, 0/1 mask) vs the unfused path at "
          f"rmat{GAT_SMALL_SCALE} F={CLASSES}: max_abs_err "
          f"out/d_logits/d_edge_w/d_x {errs}")
    return res


def _dataset(g, feat: int, classes: int, seed: int = 0) -> GnnDataset:
    """bench.py's in-memory dataset shape: normal features, uniform
    labels, train on the first half, validate/test on the second."""
    rng = np.random.default_rng(seed)
    nv = g.nv
    half = nv // 2
    ones = np.ones(nv, dtype=np.uint8)
    return GnnDataset(
        graph=g, feats=rng.standard_normal((nv, feat)).astype(np.float32),
        labels=rng.integers(0, classes, nv).astype(np.int32),
        train_mask=ones, val_mask=ones, test_mask=ones, num_classes=classes,
        train_range=(0, half, half), val_range=(half, nv, nv - half),
        test_range=(half, nv, nv - half))


def phase_small() -> None:
    for arch in ("gcn", "sage", "gat", "ggnn"):
        for scale, impl in ((11, "ell"), (13, "auto")):
            ds = _dataset(rmat(scale, 8, seed=1), 32, 4)
            cfg = make_config(arch, 2, 32, 16, 4, lr=0.01, spmm_impl=impl)
            runs = {}
            for dev in ("cuda", "cpu"):
                m = Model(cfg, ds, device=dev)
                log = m.train(EPOCHS, verbose=False)
                params = [p.detach().cpu().numpy()
                          for p in m.params.parameters()]
                runs[dev] = (np.array([(l, a) for l, a, _ in log]), params)
            np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0],
                                       rtol=TRAJ_RTOL, atol=TRAJ_ATOL)
            for pc, pp in zip(runs["cuda"][1], runs["cpu"][1]):
                np.testing.assert_allclose(pc, pp, rtol=TRAJ_RTOL,
                                           atol=TRAJ_ATOL)
            print(f"[small] {arch} rmat{scale} spmm_impl={impl}: GPU losses "
                  f"{runs['cuda'][0][:, 0].tolist()} match the CPU run")


def _params_np(model) -> list:
    return [p.detach().cpu().numpy() for p in model.params.parameters()]


def _assert_same_run(a, b, what: str) -> None:
    """Two (trajectory, parameters) pairs within the trajectory tolerance."""
    np.testing.assert_allclose(a[0], b[0], rtol=TRAJ_RTOL, atol=TRAJ_ATOL,
                               err_msg=what)
    for pa, pb in zip(a[1], b[1]):
        np.testing.assert_allclose(pa, pb, rtol=TRAJ_RTOL, atol=TRAJ_ATOL,
                                   err_msg=what)


def phase_small_trainer() -> None:
    """GPU against CPU for what the trainer does beyond full-batch steps:
    sampled training (gcn above 4096 padded vertices: the COO strategy;
    gat below: the dense one), inductive training, and a save/restore
    round trip on the card."""
    for arch, scale, subg in (("gcn", 13, 5000), ("gat", 11, 600)):
        ds = _dataset(rmat(scale, 8, seed=1), 32, 4)
        cfg = make_config(arch, 2, 32, 16, 4, lr=0.01, subg_size=subg)
        runs = {}
        for dev in ("cuda", "cpu"):
            m = Model(cfg, ds, device=dev, inductive=True)
            log = m.train_sampled(3, subg, verbose=False, seed=5)
            runs[dev] = (np.array([(l, a) for l, a, _ in log]), _params_np(m))
        _assert_same_run(runs["cuda"], runs["cpu"], f"sampled {arch}")
        print(f"[small] train_sampled {arch} rmat{scale} subg_size={subg}: GPU "
              f"losses {runs['cuda'][0][:, 0].tolist()} match the CPU run")

    g = rmat(13, 8, seed=1)
    ds = _dataset(g, 32, 4)
    ds.train_mask = (np.arange(g.nv) % 3 != 0).astype(np.uint8)
    cfg = make_config("gat", 2, 32, 16, 4, lr=0.01)
    runs = {}
    for dev in ("cuda", "cpu"):
        m = Model(cfg, ds, device=dev, inductive=True)
        log = m.train(EPOCHS, verbose=False)
        runs[dev] = (np.array([(l, a) for l, a, _ in log]), _params_np(m))
    _assert_same_run(runs["cuda"], runs["cpu"], "inductive gat")
    print(f"[small] inductive gat rmat13 (training graph ne="
          f"{m.training.host.ne} of {m.full.host.ne}): GPU losses "
          f"{runs['cuda'][0][:, 0].tolist()} match the CPU run")

    # save after 2 steps, restore into a fresh Model, 2 more: the state
    # comes back bit for bit, and the run goes on as the uninterrupted
    # one within the trajectory tolerance (split rows are added with
    # atomics, so two runs on the card are not bit-equal)
    cfg = make_config("gcn", 2, 32, 16, 4, lr=0.01)
    whole = Model(cfg, ds, device="cuda")
    want = whole.train(4, verbose=False)
    first = Model(cfg, ds, device="cuda")
    got = first.train(2, verbose=False)
    with tempfile.TemporaryDirectory() as tmp:
        path = first.save(tmp, step=2)
        second = Model(cfg, ds, device="cuda")
        second.restore(tmp, step=2)
    for a, b in zip(first.params.parameters(), second.params.parameters()):
        if not (torch.equal(a, b) and b.is_cuda):
            raise RuntimeError("restore did not bring the parameters back")
    saved, back = first.opt.state_dict(), second.opt.state_dict()
    for name in ("m", "v"):
        if not all(torch.equal(a, b) for a, b in zip(saved[name], back[name])):
            raise RuntimeError(f"restore did not bring Adam's {name} back")
    if float(saved["b1_t"]) != float(back["b1_t"]):
        raise RuntimeError("restore did not bring Adam's b1_t back")
    got += second.train(2, verbose=False)
    _assert_same_run((np.array([(l, a) for l, a, _ in got]), _params_np(second)),
                     (np.array([(l, a) for l, a, _ in want]), _params_np(whole)),
                     "save/restore")
    print(f"[small] save/restore on the card ({path.rsplit('/', 1)[-1]}): 2 + 2 "
          f"steps match 4 uninterrupted steps")


def _zero_counts() -> None:
    K1.LAUNCHES = 0
    for counts in (FG.LAUNCHES, EE.LAUNCHES, K8.LAUNCHES, K9.LAUNCHES,
                   K10.LAUNCHES, K12.LAUNCHES, K11.LAUNCHES, FF.LAUNCHES):
        for name in counts:
            counts[name] = 0


def _counts() -> dict[str, int]:
    return {"ell_spmm": K1.LAUNCHES, **FG.LAUNCHES, **EE.LAUNCHES,
            **K8.LAUNCHES, **K9.LAUNCHES, **K10.LAUNCHES, **K12.LAUNCHES,
            **K11.LAUNCHES, **FF.LAUNCHES}


def _drive(g, cfg, want_train: dict, want_eval: dict):
    """One main path: set-up, every launch count set to 0, ``EPOCHS``
    training steps, the counts read, evaluation, the counts read again.
    Raises unless the losses are finite and fall, the logits are finite
    and of shape (nv, classes), and each kernel was launched as often as
    the design implies (``want_*``: per step and per evaluation; a kernel
    not named must not be launched). Returns (model, launches)."""
    tag = f"[main {cfg.arch}]"
    ds = _dataset(g, cfg.dim_init, cfg.num_cls)
    t0 = time.perf_counter()
    model = Model(cfg, ds, device="cuda")
    torch.cuda.synchronize()
    print(f"{tag} Model set-up {time.perf_counter() - t0:.2f} s "
          f"(nv={model.full.device.nv} ne={model.full.device.ne})")
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    log = model.train(EPOCHS)
    train = _counts()
    acc = model.evaluate("test")
    total = _counts()
    losses = [l for l, _, _ in log]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"{tag} non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"{tag} loss did not decrease: {losses}")
    for name, n in total.items():
        want_t = EPOCHS * want_train.get(name, 0)
        want_e = want_eval.get(name, 0)
        if train[name] != want_t or n - train[name] != want_e:
            raise RuntimeError(
                f"{tag} {name}: {train[name]} launches in training and "
                f"{n - train[name]} in evaluate, expected {want_t} and "
                f"{want_e}")
    if not 0.0 <= acc <= 1.0:
        raise RuntimeError(f"{tag} test accuracy {acc} outside [0, 1]")
    with torch.no_grad():
        logits = apply_model(model.cfg, model.params, model.full.device,
                             model.full.edge_w_agg, model.feats,
                             trivial_w=True)
    if tuple(logits.shape) != (g.nv, cfg.num_cls) or not bool(
            torch.isfinite(logits).all()):
        raise RuntimeError(f"{tag} bad logits: shape {tuple(logits.shape)}")
    epoch_ms = statistics.median(dt for _, _, dt in log) * 1e3
    print(f"{tag} losses {losses} test_acc {acc:.4f}")
    print(f"{tag} launches in training {train}, with evaluation {total}; "
          f"epoch median {epoch_ms:.3f} ms (warm-up epochs included); peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return model, total


def phase_main(g):
    """The GCN path, then this port's other three architectures at the
    same widths. Returns the GCN and GAT models and the launch counts of
    their paths."""
    gcn, n_gcn = _drive(
        g, make_config("gcn", 2, FEAT, HIDDEN, CLASSES, lr=0.01),
        {"ell_spmm": SPMMS_PER_STEP}, {"ell_spmm": SPMMS_PER_EVAL})
    gat, n_gat = _drive(
        g, make_config("gat", GAT_LAYERS, FEAT, HIDDEN, CLASSES, lr=0.01,
                       use_l2norm=False, use_dense=False),
        GAT_STEP_LAUNCHES,
        {"gat_rowmax": GAT_LAYERS, "gat_v2_fwd": GAT_LAYERS})
    # SAGE: as GCN, 3 SpMMs a step (layer 1's input is constant). GGNN
    # with dim_init == dim_hid does not project: one SpMM of the constant
    # features a step, no adjoint.
    _drive(g, make_config("sage", 2, FEAT, HIDDEN, CLASSES, lr=0.01),
           {"ell_spmm": SPMMS_PER_STEP}, {"ell_spmm": SPMMS_PER_EVAL})
    _drive(g, make_config("ggnn", 1, FEAT, HIDDEN, CLASSES, lr=0.01),
           {"ell_spmm": 1}, {"ell_spmm": 1})
    launches = {"ell_spmm": n_gcn["ell_spmm"],
                **{name: n_gat[name] for name in GAT_KERNELS}}
    return gcn, gat, launches


def _assert_counts(tag: str, got: dict, want: dict) -> None:
    """Every kernel launched as often as ``want`` says; one not named,
    not at all."""
    for name, n in got.items():
        if n != want.get(name, 0):
            raise RuntimeError(f"{tag} {name}: {n} launches, expected "
                               f"{want.get(name, 0)} (all counts: {got})")


def phase_main_v1(g) -> tuple[dict[str, int], dict]:
    """The v1 main path: ``EPOCHS`` GAT steps at full width through
    ``apply_model`` with its default ``trivial_w`` and a random 0/1 mask
    as edge weights, then one evaluation forward; then ``TIMED_EPOCHS``
    more steps on the host clock and ``PROFILED_EPOCHS`` under the
    profiler. Returns the launch counts of training and evaluation
    together, and the step's host-clock ms, device ms, device ops and the
    peak memory in GiB."""
    tag = "[main gat v1]"
    cfg = make_config("gat", GAT_LAYERS, FEAT, HIDDEN, CLASSES, lr=0.01,
                      use_l2norm=False, use_dense=False)
    ds = _dataset(g, FEAT, CLASSES)
    model = Model(cfg, ds, device="cuda")
    dg = model.full.device
    gen = torch.Generator(device="cuda").manual_seed(3)
    mask = (torch.rand(dg.ne, device="cuda", generator=gen) < MASK_KEEP).float()
    begin, end, _ = ds.train_range
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    losses, times = [], []

    def steps(n: int) -> None:
        for _ in range(n):
            t0 = time.perf_counter()
            model.opt.zero_grad()
            logits = apply_model(cfg, model.params, dg, mask, model.feats,
                                 train=True)
            loss, rep, _ = masked_softmax_loss(logits, model.labels, begin,
                                               end, model.masks["train"])
            loss.backward()
            model.opt.step()
            losses.append(float(rep.detach()))     # waits for the device
            times.append(time.perf_counter() - t0)

    steps(EPOCHS)
    train = _counts()
    fwd, bwd = V1_ROW_REDUCES_PER_LAYER
    _assert_counts(f"{tag} training", train, {
        "ell_row_reduce": EPOCHS * GAT_LAYERS * (fwd + bwd),
        "gat_v1_fwd": EPOCHS * GAT_LAYERS,
        "sddmm_dot_ell": EPOCHS * GAT_LAYERS,
        "ell_spmm": EPOCHS * GAT_LAYERS})       # K1: dx, once per layer
    with torch.no_grad():
        logits = apply_model(cfg, model.params, dg, mask, model.feats)
    total = _counts()
    _assert_counts(f"{tag} evaluation",
                   {k: total[k] - train[k] for k in total},
                   {"ell_row_reduce": GAT_LAYERS * fwd,
                    "gat_v1_fwd": GAT_LAYERS})
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"{tag} losses not finite or not falling: {losses}")
    if tuple(logits.shape) != (g.nv, CLASSES) or not bool(
            torch.isfinite(logits).all()):
        raise RuntimeError(f"{tag} bad logits: shape {tuple(logits.shape)}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"{tag} losses {losses}")
    print(f"{tag} launches in training {train}, with one evaluation forward "
          f"{total}; step median {statistics.median(times) * 1e3:.3f} ms "
          f"(warm-up steps included); peak memory {peak_gib:.4f} GiB")
    steps(TIMED_EPOCHS)
    step_ms = statistics.median(times[EPOCHS:]) * 1e3
    print(f"{tag} median of {TIMED_EPOCHS} more steps {step_ms:.4f} ms")
    device_ms, device_ops = phase_profile("gat v1", steps, PROFILED_EPOCHS,
                                          step_ms)
    return total, {"step_ms": step_ms, "device_ms": device_ms,
                   "device_ops": device_ops, "peak_gib": peak_gib}


def phase_main_sampled(g) -> None:
    """The sampled main path: ``EPOCHS`` epochs of ``train_sampled`` each
    for gcn and gat at full width, ``SUBG_SIZE`` vertices a subgraph,
    with the stage seconds of OpTimers and the launches of its full-graph
    evaluations (the sampled step itself runs on a graph without ELL
    buckets: plain PyTorch, no kernel of this port)."""
    evals = len(range(SAMPLED_VAL_INTERVAL, EPOCHS, SAMPLED_VAL_INTERVAL))
    per_eval = {"gcn": {"ell_spmm": SPMMS_PER_EVAL},
                "gat": {"gat_rowmax": GAT_LAYERS, "gat_v2_fwd": GAT_LAYERS}}
    for arch in ("gcn", "gat"):
        tag = f"[main sampled {arch}]"
        cfg = make_config(arch, 2, FEAT, HIDDEN, CLASSES, lr=0.01,
                          subg_size=SUBG_SIZE)
        timers = OpTimers()
        t0 = time.perf_counter()
        model = Model(cfg, _dataset(g, FEAT, CLASSES), device="cuda",
                      inductive=True, timers=timers)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        log = model.train_sampled(EPOCHS, SUBG_SIZE,
                                  val_interval=SAMPLED_VAL_INTERVAL)
        counts = _counts()
        _assert_counts(tag, counts, {k: evals * n
                                     for k, n in per_eval[arch].items()})
        # every epoch trains on another subgraph (and the labels are
        # random), so the losses need not fall within 5 epochs
        losses = [l for l, _, _ in log]
        if not all(np.isfinite(losses)):
            raise RuntimeError(f"{tag} non-finite loss: {losses}")
        acc = model.evaluate("test")
        if not 0.0 <= acc <= 1.0:
            raise RuntimeError(f"{tag} test accuracy {acc} outside [0, 1]")
        if (timers.counts[OP_SAMPLE], timers.counts[OP_STEP],
                timers.counts[OP_EVAL]) != (EPOCHS, EPOCHS, evals + 1):
            raise RuntimeError(f"{tag} timer counts {dict(timers.counts)}")
        print(f"{tag} set-up {setup:.2f} s; losses {losses} test_acc {acc:.4f}; "
              f"launches of {evals} evaluations {counts}")
        epoch_ms = statistics.median(dt for _, _, dt in log) * 1e3
        print(f"{tag} epoch median {epoch_ms:.3f} ms; "
              f"OpTimers seconds over {EPOCHS} epochs: sampler wait "
              f"{timers.times[OP_SAMPLE]:.4f}, step {timers.times[OP_STEP]:.4f}, "
              f"evaluation x{evals + 1} {timers.times[OP_EVAL]:.4f}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        phase_profile(f"sampled {arch}",
                      lambda n, m=model: m.train_sampled(
                          n, SUBG_SIZE, verbose=False, seed=EPOCHS),
                      SAMPLED_PROFILED_EPOCHS, epoch_ms)


class _plain_kernels:
    """While active, the wrappers send CUDA tensors to the kernels' plain
    versions (for timing the plain versions on the main path)."""

    def __enter__(self):
        self.saved = (K1._ell_spmm_cuda, FG.gat_rowmax, FG.gat_v2_fwd,
                      FG.gat_v2_bwd_sl, FG.gat_v2_bwd_h, FG.gat_v2_bwd)
        K1._ell_spmm_cuda = lambda table, w_slots, x: K1.ell_spmm_plain(
            table.graph, w_slots, x)
        FG.gat_rowmax = FG.gat_rowmax_plain
        FG.gat_v2_fwd = FG.gat_v2_fwd_plain
        FG.gat_v2_bwd_sl = FG.gat_v2_bwd_sl_plain
        FG.gat_v2_bwd_h = FG.gat_v2_bwd_h_plain
        FG.gat_v2_bwd = FG.gat_v2_bwd_plain

    def __exit__(self, *exc):
        (K1._ell_spmm_cuda, FG.gat_rowmax, FG.gat_v2_fwd, FG.gat_v2_bwd_sl,
         FG.gat_v2_bwd_h, FG.gat_v2_bwd) = self.saved


def _epoch_median_ms(model, plain: bool) -> float:
    """Median epoch time over TIMED_EPOCHS, with the kernels or with
    their plain versions."""
    if plain:
        with _plain_kernels():
            log = model.train(TIMED_EPOCHS, verbose=False)
    else:
        log = model.train(TIMED_EPOCHS, verbose=False)
    if not all(np.isfinite([l for l, _, _ in log])):
        raise RuntimeError("non-finite loss in the timed epochs")
    return statistics.median(dt for _, _, dt in log) * 1e3


def phase_epochs(model) -> float:
    tag = f"[epochs {model.cfg.arch}]"
    runs = [(plain, _epoch_median_ms(model, plain))
            for plain in (False, True, True, False)]
    kernel = [ms for plain, ms in runs if not plain]
    plain = [ms for plain, ms in runs if plain]
    print(f"{tag} median of {TIMED_EPOCHS} epochs, kernel/plain/plain/"
          f"kernel: {[round(ms, 4) for _, ms in runs]} ms; kernel "
          f"{statistics.mean(kernel):.4f} ms, plain "
          f"{statistics.mean(plain):.4f} ms")
    return statistics.mean(kernel)


def phase_profile(tag: str, run, epochs: int, epoch_ms: float,
                  unit: str = "epoch"):
    """``run(epochs)`` under torch.profiler: device time per epoch by
    kernel and the device's busy share; ``epoch_ms`` is the unprofiled
    epoch on the host clock, from another run. Returns (device ms per
    epoch, device ops per epoch), or (None, None) without device events.
    ``unit`` names what ``run`` repeats in the printed lines."""
    from torch.profiler import ProfilerActivity, profile

    tag = f"[profile {tag}]"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(epochs)
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        print(f"{tag} the profiler recorded no device events: device "
              "time and busy share not measured")
        return None, None
    busy, end = 0.0, float("-inf")
    for e in sorted(dev, key=lambda e: e.time_range.start):
        lo, hi = max(e.time_range.start, end), e.time_range.end
        busy += max(hi - lo, 0.0)
        end = max(end, hi)
    by_name: dict[str, list] = {}
    for e in dev:
        item = by_name.setdefault(e.name, [0, 0.0])
        item[0] += 1
        item[1] += e.time_range.elapsed_us()
    device_ms = busy / epochs / 1e3
    print(f"{tag} {epochs} {unit}s: device busy "
          f"{device_ms:.4f} ms/{unit}, {len(dev) / epochs:.1f} "
          f"device ops/{unit}, busy share {busy / wall_us:.4f} of the "
          f"profiled wall time; {device_ms / epoch_ms:.4f} of the unprofiled "
          f"{epoch_ms:.4f} ms {unit} (device time and wall time from two runs)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (n, us) in top:
        print(f"{tag} {us / epochs / 1e3:.4f} ms/{unit} "
              f"{us / busy:.4f} of device time, {n / epochs:g}/{unit}: "
              f"{name[:90]}")
    return device_ms, len(dev) / epochs


# ---- the analytics phase ---------------------------------------------------

def _pull_bound(dg, edge_vals: bool) -> tuple[float, str, int]:
    """The least time the card could take for one neighbor_reduce, in ms,
    what bounds it, and the bytes: per real slot its neighbour id and, with
    edge values, its value (the pads are the layout's, not the function's);
    the row id and count of each virtual row; the split flags; vals read
    once and out written once. Against one operation a slot (two with edge
    values) over the float32 rate (int32 at that rate too: the card's int32
    rate is not in the data sheet)."""
    rows = sum(b.rows for b in dg.ell)
    nbytes = dg.ne * (8 if edge_vals else 4) + rows * 8 + dg.nv * 9
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = dg.ne * (2 if edge_vals else 1) / F32_FLOP_PER_S * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations", nbytes)


def _pull_close(got, want, what: str) -> float:
    """Max |kernel - plain|: equal for min, max and int32 sums; a float32
    sum within rtol 1e-5 and an absolute 1e-6 of the largest |plain|."""
    if got.dtype != want.dtype:
        raise RuntimeError(f"{what}: {got.dtype} against plain's {want.dtype}")
    if not what.startswith("float32 sum"):
        if not torch.equal(got, want):
            raise RuntimeError(f"{what}: neighbor_reduce differs from plain in "
                               f"{int((got != want).sum())} rows")
        return 0.0
    atol = PULL_FSUM_ATOL_SCALE * float(want.abs().max())
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=PULL_FSUM_RTOL, atol=atol):
        raise RuntimeError(f"{what}: neighbor_reduce disagrees with plain, "
                           f"max |diff| {err} (atol {atol})")
    return err


def _pull_cases(dg, gen, what: str, dirty: bool, timed: bool) -> dict:
    """K8 against its plain version on one graph in every case: each kind
    for int32 and float32 vals, float32 also with edge values packed and
    as an (ne,) array. Returns {case: {"max_abs_err", and where timed the
    times beside the bound}}."""
    nv, ne = dg.nv, dg.ne
    vals = {"int32": torch.randint(-10**6, 10**6, (nv,), dtype=torch.int32,
                                   device="cuda", generator=gen),
            "float32": torch.randn(nv, device="cuda", generator=gen)}
    ev = torch.rand(ne, device="cuda", generator=gen) + 0.25
    packed = K8.pack_neighbor_edge_vals(dg, ev)
    forms = {"": None, " packed": packed, " flat": ev}
    specs = {f"{dtype} {kind}{form}": (vals[dtype], kind, e)
             for dtype in vals for kind in K8.KINDS for form, e in forms.items()
             if dtype == "float32" or e is None}
    cases = {}
    for name, (v, kind, e) in specs.items():
        if dirty:   # a row the kernel does not write shows as NaN
            junk = torch.full((nv,), float("nan"), device="cuda")
            del junk
        got = K8.neighbor_reduce(dg, v, kind, e)
        want = K8.neighbor_reduce_plain(dg, v, kind,
                                        None if e is None else packed)
        torch.cuda.synchronize()
        cases[name] = {"max_abs_err": _pull_close(got, want, name)}
    if not timed:
        return cases
    # the one PyTorch call that computes a float32 sum over the neighbours,
    # an SpMV of the graph's CSR matrix; timed here and used nowhere
    ones = torch.sparse_csr_tensor(dg.row_ptr, dg.col_idx,
                                   torch.ones(ne, device="cuda"), size=(nv, nv))
    col = vals["float32"][:, None]
    # none for the min cases: torch.sparse.mm's reduce="amin" runs only on
    # the CPU, so on the card a min is a gather and a scatter_reduce_ (two
    # calls), and nothing computes the min-plus of packed edge values; none
    # timed for the int32 sum (k_core_peel's), whose SpMV would be int32
    library = {"float32 sum": lambda: torch.sparse.mm(ones, col)}
    _pull_close(library["float32 sum"]()[:, 0],
                K8.neighbor_reduce_plain(dg, vals["float32"], "sum"),
                "float32 sum: the library call")
    for name in PULL_TIMED:
        v, kind, e = specs[name]
        slots = None if e is None else packed
        ms = _batch_ms(lambda: K8.neighbor_reduce(dg, v, kind, e))
        # the sweep holds most of its batch time at this size: a reading
        # below half of it is the profiler's, not the kernel's
        device_ms = _kernel_device_ms(
            lambda: K8.neighbor_reduce(dg, v, kind, e), "neighbor_reduce_kernel",
            at_least_ms=ms / 2)
        plain_ms = _batch_ms(lambda: K8.neighbor_reduce_plain(dg, v, kind, slots),
                             calls=3, batches=3)
        library_ms = _batch_ms(library[name]) if name in library else None
        bound_ms, bound_by, nbytes = _pull_bound(dg, e is not None)
        cases[name].update(
            ms=ms, device_ms=device_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            bound_bytes=nbytes, share_of_bound=bound_ms / ms,
            share_of_bound_device=(bound_ms / device_ms if device_ms
                                   else None),
            edges_per_s=ne / (ms * 1e-3))
        print(f"[analytics] neighbor_reduce {name} {json.dumps(cases[name])}")
    return cases


def phase_pull_kernel(dg) -> dict:
    """K8 against its plain version at the analytics size (timed), then on
    rmat13 behind an allocator dirtied with NaN. Returns {"cases": the
    timed cases, "max_abs_err": over every case}."""
    split, empty = int(dg.is_split.sum()), int((dg.deg == 0).sum())
    print(f"[analytics] rmat{ANALYTICS_SCALE} nv={dg.nv} ne={dg.ne} "
          f"buckets={[(b.width, b.rows) for b in dg.ell]} split_rows={split} "
          f"edgeless_rows={empty}")
    if not split or not empty:
        raise RuntimeError("the analytics graph must have split and edgeless "
                           "rows: the cases would check less")
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = _pull_cases(dg, gen, f"rmat{ANALYTICS_SCALE}", dirty=False,
                        timed=True)
    small = to_device_graph(rmat(PULL_DIRTY_SCALE, EDGE_FACTOR, seed=0),
                            device="cuda")
    dirty = _pull_cases(small, gen, f"rmat{PULL_DIRTY_SCALE}", dirty=True,
                        timed=False)
    # a hub joined to every rmat13 vertex and to 50,000 leaves: 58,192
    # neighbours, 910 virtual rows of one output row
    star = to_device_graph(_star_joined(rmat(PULL_DIRTY_SCALE, EDGE_FACTOR,
                                             seed=0), HINDEX_STAR_LEAVES),
                           device="cuda")
    hub = _pull_cases(star, gen, f"rmat{PULL_DIRTY_SCALE} + star", dirty=True,
                      timed=False)
    err = max(c["max_abs_err"] for c in (*cases.values(), *dirty.values(),
                                         *hub.values()))
    print(f"[analytics] neighbor_reduce: {len(cases)} cases at "
          f"rmat{ANALYTICS_SCALE}, {len(dirty)} at rmat{PULL_DIRTY_SCALE} "
          f"and {len(hub)} at rmat{PULL_DIRTY_SCALE} joined to a star of "
          f"{HINDEX_STAR_LEAVES} leaves (widest row "
          f"{int(star.deg.max())}), behind a NaN-dirtied allocator, agree "
          f"with plain, max_abs_err {err}")
    return {"cases": [dict(cases[n], case=n) for n in PULL_TIMED],
            "max_abs_err": err}


class _sweeps:
    """While active, counts the solvers' calls of neighbor_reduce: one a
    sweep of their pull route."""

    def __enter__(self):
        self.n = 0

        def counted(*args, **kw):
            self.n += 1
            return K8.neighbor_reduce(*args, **kw)

        for module in (TR, PRM, CCM, BCM, KCM):
            module.neighbor_reduce = counted
        return self

    def __exit__(self, *exc):
        for module in (TR, PRM, CCM, BCM, KCM):
            module.neighbor_reduce = K8.neighbor_reduce


def _scipy_csr(g, w=None):
    from scipy.sparse import csr_matrix

    data = np.ones(g.ne) if w is None else w.astype(np.float64)
    return csr_matrix((data, g.col_idx, g.row_ptr), shape=(g.nv, g.nv))


def _bfs_ref(g, source: int = 0) -> np.ndarray:
    """Depths from scipy, -1 where unreached."""
    from scipy.sparse.csgraph import shortest_path

    d = shortest_path(_scipy_csr(g), directed=True, unweighted=True,
                      indices=source)
    return np.where(np.isfinite(d), d, -1).astype(np.int32)


def _sssp_ref(g, w, source: int = 0) -> np.ndarray:
    from scipy.sparse.csgraph import dijkstra

    return dijkstra(_scipy_csr(g, w), directed=True, indices=source)


def _cc_ref(g) -> np.ndarray:
    """scipy's components, each named by its least vertex id."""
    from scipy.sparse.csgraph import connected_components

    _, lab = connected_components(_scipy_csr(g), directed=False)
    _, first = np.unique(lab, return_index=True)
    return first[lab].astype(np.int32)


def _pagerank_ref(g) -> tuple[np.ndarray, int]:
    """A float64 power iteration with the solver's rule and constants:
    new_i = (1 - d) / nv + d * sum over j in N(i) of s_j / max(deg_j, 1),
    until the L1 change falls below epsilon or after MAX_ITER."""
    nv = g.nv
    src = np.repeat(np.arange(nv), np.diff(g.row_ptr))
    deg = np.maximum(np.diff(g.row_ptr), 1)
    s = np.full(nv, 1.0 / nv)
    for it in range(1, PRM.MAX_ITER + 1):
        new = ((1 - PRM.K_DAMP) / nv + PRM.K_DAMP * np.bincount(
            src, weights=(s / deg)[g.col_idx], minlength=nv))
        err = np.abs(new - s).sum()
        s = new
        if err < PRM.EPSILON:
            break
    return s, it


def _solve_seconds(fn, solves: int = SOLVES) -> float:
    """Median host-clock seconds of ``solves`` calls, each ending in a
    sync."""
    times = []
    for _ in range(solves):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _solve(tag: str, ne: int | None, fn, check, solves: int = SOLVES) -> dict:
    """One solve held to its reference by ``check`` (which raises, or
    returns what to print), with its sweeps and neighbor_reduce launches;
    then ``solves`` timed ones (host clock, ending in a sync). ``ne``: the
    edges a sweep covers, for edges x sweeps / s (None: not one graph)."""
    with _sweeps() as sw:
        before = K8.LAUNCHES["neighbor_reduce"]
        out = fn()
        torch.cuda.synchronize()
        launches = K8.LAUNCHES["neighbor_reduce"] - before
    info = {"solver": tag, **check(out), "sweeps": sw.n, "launches": launches}
    if launches != sw.n:
        raise RuntimeError(f"[analytics] {tag}: {launches} neighbor_reduce "
                           f"launches in {sw.n} pull sweeps")
    s = _solve_seconds(fn, solves)
    info.update(s_per_solve=s, edges_x_sweeps_per_s=(
        None if ne is None else ne * sw.n / s))
    print(f"[analytics] {json.dumps(info)}")
    return info


def _exact(got, want, what: str) -> None:
    if not np.array_equal(got, want):
        raise RuntimeError(f"[analytics] {what} differs from the reference in "
                           f"{int((got != want).sum())} vertices")


def phase_solvers(g, dg) -> int:
    """The solvers at the analytics size through the calls run_benchmark
    makes, each against a reference independent of both packages (scipy,
    numpy), timed; then one BFS under the profiler. Returns the
    neighbor_reduce launches of the checked and timed solves, every count
    set to 0 just before them."""
    nv, ne = g.nv, g.ne
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    # one weight per undirected edge: an edge and its reverse take the draw
    # at the lower edge id (trans_perm maps an edge to its reverse)
    rev = dg.trans_perm.cpu().numpy()
    w_sym = rng.uniform(0.1, 2.0, ne).astype(np.float32)[
        np.minimum(np.arange(ne), rev)]
    w_asym = rng.uniform(0.1, 2.0, ne).astype(np.float32)
    ref_bfs, ref_cc = _bfs_ref(g), _cc_ref(g)
    ref_sssp = {"symmetric": _sssp_ref(g, w_sym),
                "asymmetric": _sssp_ref(g, w_asym)}
    ref_pr, ref_iters = _pagerank_ref(g)
    print(f"[analytics] references (scipy, numpy float64) in "
          f"{time.perf_counter() - t0:.2f} s: reached {int((ref_bfs >= 0).sum())}, "
          f"depth {ref_bfs.max()}, {len(np.unique(ref_cc))} components, "
          f"pagerank {ref_iters} iterations")

    def check_bfs(dist):
        dist = dist.cpu().numpy()
        _exact(dist, ref_bfs, "bfs")
        return {"reached": int((dist >= 0).sum()), "max_depth": int(dist.max())}

    def check_sssp(kind):
        def check(dist):
            dist = dist.cpu().numpy()
            if not np.allclose(dist, ref_sssp[kind], rtol=SSSP_RTOL,
                               equal_nan=True):
                raise RuntimeError(f"[analytics] sssp ({kind} weights) differs "
                                   "from dijkstra beyond rtol 1e-5")
            return {"reached": int(np.isfinite(dist).sum())}
        return check

    def check_pr(res):
        scores, iters = res
        l1 = float(np.abs(scores.cpu().numpy() - ref_pr).sum())
        if l1 >= PR_L1 or abs(iters - ref_iters) > 1:
            raise RuntimeError(f"[analytics] pagerank: L1 {l1} from the float64 "
                               f"reference, {iters} iterations against {ref_iters}")
        return {"iterations": iters, "l1_from_float64": l1}

    def check_cc(comp):
        comp = comp if isinstance(comp, np.ndarray) else comp.cpu().numpy()
        _exact(comp, ref_cc, "cc")
        return {"components": int(len(np.unique(comp)))}

    weights = {k: torch.from_numpy(w).cuda()
               for k, w in (("symmetric", w_sym), ("asymmetric", w_asym))}
    _zero_counts()
    per_solve = {}
    bfs = per_solve["bfs"] = _solve("bfs", ne, lambda: TR.bfs(dg, 0),
                                    check_bfs)
    if bfs["sweeps"] != ref_bfs.max() + 1:
        raise RuntimeError(f"[analytics] bfs took {bfs['sweeps']} sweeps for "
                           f"depth {ref_bfs.max()}")
    for kind, w in weights.items():
        per_solve[f"sssp {kind}"] = _solve(
            f"sssp_bellman_ford {kind} weights", ne,
            lambda w=w: TR.sssp_bellman_ford(dg, w, 0), check_sssp(kind))
    pr = per_solve["pagerank"] = _solve("pagerank", ne,
                                        lambda: PRM.pagerank(dg), check_pr)
    if pr["sweeps"] != pr["iterations"]:
        raise RuntimeError("[analytics] pagerank's sweeps are not its iterations")
    per_solve["cc"] = _solve("connected_components", ne,
                             lambda: CCM.connected_components(dg), check_cc)
    _solve("connected_components_afforest", None,
           lambda: CCM.connected_components_afforest(g, device="cuda"), check_cc)
    counts = _counts()
    launches = counts["neighbor_reduce"]
    if launches == 0:
        raise RuntimeError("[analytics] the solvers launched no neighbor_reduce")
    print(f"[analytics] neighbor_reduce launches a solve: "
          f"{json.dumps({k: v['launches'] for k, v in per_solve.items()})}")
    _assert_counts("[analytics]", counts, {"neighbor_reduce": launches})
    print(f"[analytics] launches of the solves above {counts}")
    phase_profile(f"bfs rmat{ANALYTICS_SCALE}",
                  lambda n: [TR.bfs(dg, 0) for _ in range(n)], 1,
                  bfs["s_per_solve"] * 1e3, unit="solve")
    return launches


def phase_grid_and_directed() -> None:
    """The high-diameter grid through bfs and bfs_frontier, and a directed
    rmat through bfs_host, which takes the push route."""
    g = grid2d(GRID_SIDE)
    dg = to_device_graph(g, device="cuda", with_transpose=False)
    ref = _bfs_ref(g)

    def check(dist):
        # "sweeps" below counts the pull sweeps; bfs_frontier takes a
        # sparse (push) sweep for each other level
        _exact(dist.cpu().numpy(), ref, f"grid2d({GRID_SIDE}) bfs")
        return {"max_depth": int(ref.max()), "levels": int(ref.max()) + 1}

    for name, fn in (("bfs", TR.bfs), ("bfs_frontier", TR.bfs_frontier)):
        _solve(f"{name} grid2d({GRID_SIDE})", g.ne, lambda fn=fn: fn(dg, 0),
               check, solves=1)
    g = rmat(DIRECTED_SCALE, 8, seed=0, undirected=False)
    if is_symmetric(g):
        raise RuntimeError("the directed rmat came out symmetric")
    before = K8.LAUNCHES["neighbor_reduce"]
    dist = TR.bfs_host(g, 0, device="cuda")
    if K8.LAUNCHES["neighbor_reduce"] != before:
        raise RuntimeError("bfs_host pulled over a directed graph")
    _exact(dist, _bfs_ref(g), f"directed rmat{DIRECTED_SCALE} bfs_host")
    print(f"[analytics] directed rmat({DIRECTED_SCALE}, 8): bfs_host took the "
          f"push route (no ELL buckets, no neighbor_reduce launch), reached "
          f"{int((dist >= 0).sum())} of {g.nv}, equal to scipy")


def phase_analytics_cli() -> None:
    """``python -m graphaibench_tpu_torch.cli analytics <k> <dir> 0`` for
    the seven solvers on a small dataset written by the port's save_graph,
    without --device, side by side: each must print ``device = cuda`` and
    ``Correct`` and exit 0. Then ``cli info <dir>``."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "GAB_SHARDS"}
    cli = [sys.executable, "-m", "graphaibench_tpu_torch.cli"]
    with tempfile.TemporaryDirectory() as tmp:
        save_graph(rmat(PULL_DIRTY_SCALE, CLI_EDGE_FACTOR, seed=0), tmp)
        t0 = time.perf_counter()
        procs = {k: subprocess.Popen(
            [*cli, "analytics", k, tmp, "0"], cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for k in CLI_KERNELS}
        try:
            outs = {k: p.communicate(timeout=600) for k, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        dt = time.perf_counter() - t0
        info = subprocess.run([*cli, "info", tmp], cwd=root, env=env,
                              capture_output=True, text=True, timeout=300)
    for k, (out, err) in outs.items():
        lines = out.splitlines()
        if (procs[k].returncode != 0 or "device = cuda" not in lines
                or "Correct" not in lines):
            raise RuntimeError(f"cli analytics {k}: exit {procs[k].returncode}"
                               f"\n{out}\n{err[-3000:]}")
        runtime = next(l for l in lines if l.startswith("runtime"))
        print(f"[analytics] cli analytics {k} rmat({PULL_DIRTY_SCALE}, "
              f"{CLI_EDGE_FACTOR}): device = cuda, Correct, {runtime}")
    print(f"[analytics] the {len(CLI_KERNELS)} CLI runs side by side in "
          f"{dt:.2f} s")
    lines = info.stdout.splitlines()
    if info.returncode != 0 or not lines or not lines[0].startswith("|V| "):
        raise RuntimeError(f"cli info: exit {info.returncode}\n{info.stdout}"
                           f"\n{info.stderr[-3000:]}")
    print(f"[analytics] cli info: {' / '.join(lines)}")


def _dirty(n: int) -> None:
    """Fill the allocator's free block of ``n`` floats with NaN, so that
    a value a kernel does not write shows."""
    junk = torch.full((n,), float("nan"), device="cuda")
    del junk


def _tc_bound(dag) -> tuple[float, str, int]:
    """The least time the card could take for one count, in ms, what bounds
    it, and the bytes: the DAG's row pointers and ids and the counted edge
    list read once, the total written once; against the compares the binary
    searches of these edges need (for each edge, the shorter row's length
    times the steps of a search of the longer: the data's count), over the
    float32 rate (int32 at that rate too: the card's int32 rate is not in
    the data sheet)."""
    rp = dag.row_ptr.long()
    deg = rp[1:] - rp[:-1]
    a, b = deg[dag.src.long()], deg[dag.dst.long()]
    steps = torch.ceil(torch.log2(torch.maximum(a, b).double() + 1))
    ops = float((torch.minimum(a, b).double() * steps).sum())
    nbytes = 4 * (dag.nv + 1) + 4 * dag.ne + 8 * dag.src.numel() + 8
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_FLOP_PER_S * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations", nbytes)


def _scipy_triangles(g) -> int:
    """Triangles of an undirected graph from its degree-ordered DAG's
    adjacency L: (L @ L) .* L summed, exact in int64."""
    from scipy.sparse import csr_matrix

    dag = orientation(g)
    lo = csr_matrix((np.ones(dag.ne, np.int64), dag.col_idx, dag.row_ptr),
                    shape=(dag.nv, dag.nv))
    return int((lo @ lo).multiply(lo).sum())


def _tc_wide_row() -> dict:
    """K9 on a graph laid out on the card whose row 0 holds TC_WIDE_ROW
    ids, more than any group's hash table takes, and repeats two of them,
    with an edge into 0 from every fifth vertex: held to plain and to
    scipy's (L @ L) .* L of the same graph, which counts repeated ids with
    their multiplicity as compare-all does."""
    from scipy.sparse import csr_matrix

    rng = np.random.default_rng(11)
    nv = 5_000
    rows = [np.sort(np.r_[rng.choice(np.arange(1, nv), TC_WIDE_ROW,
                                     replace=False), [5, 7]])]
    for v in range(1, nv):
        hi = min(nv, v + 400)
        k = min(int(rng.integers(0, 30)), hi - v - 1)
        into = [0] if v % 5 == 0 else []
        rows.append(np.sort(np.r_[into, rng.choice(np.arange(v + 1, hi), k,
                                                   replace=False)]))
    rp = np.r_[0, np.cumsum([len(r) for r in rows])].astype(np.int64)
    col = np.concatenate(rows).astype(np.int32)
    lo = csr_matrix((np.ones(len(col), np.int64), col, rp), shape=(nv, nv))
    want = int((lo @ lo).multiply(lo).sum())
    dag = K9.dag_edges(rp, col, device="cuda")
    got, plain = int(K9.tc_count(dag)), int(K9.tc_count_plain(dag))
    if got != want or plain != want:
        raise RuntimeError(f"[analytics] the wide row's graph: tc_count "
                           f"{got}, plain {plain}, scipy {want}")
    return {"widest_row": int(np.diff(rp).max()), "triangles": got}


def phase_tc(g) -> dict:
    """K9 against its plain version at the analytics size (timed beside its
    bound) and at rmat13 behind the dirtied allocator; then
    triangle_count, every count set to 0 just before it, held to scipy's
    count (and to the known total at rmat(19, 16, seed=0)), one cold solve
    (orientation, sorting, the device layout) and warm ones. Returns K9's
    entry data."""
    t0 = time.perf_counter()
    want = _scipy_triangles(g)
    print(f"[analytics] scipy counts {want} triangles in "
          f"{time.perf_counter() - t0:.2f} s")
    if ANALYTICS_SCALE == 19 and want != TC_RMAT19:
        raise RuntimeError(f"[analytics] scipy counts {want} triangles on "
                           f"rmat(19, 16), not {TC_RMAT19}")
    TCM._TC_CACHE.clear()
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = TCM.triangle_count(g, device="cuda")
    cold = time.perf_counter() - t0
    launches = _counts()
    _assert_counts("[analytics] triangle_count", launches, {"tc_count": 1})
    if n != want:
        raise RuntimeError(f"[analytics] triangle_count {n}, scipy {want}")
    warm = _solve_seconds(lambda: TCM.triangle_count(g, device="cuda"))
    dag = TCM._tc_device_state(g, "cuda")
    got = K9.tc_count(dag)
    plain = K9.tc_count_plain(dag)
    if int(got) != int(plain):
        raise RuntimeError(f"[analytics] tc_count {int(got)}, plain "
                           f"{int(plain)}")
    small = rmat(PULL_DIRTY_SCALE, EDGE_FACTOR, seed=0)
    sdag = TCM._tc_device_state(small, "cuda")
    _dirty(2)             # the block the kernel's 8-byte total comes from
    got_s, plain_s = int(K9.tc_count(sdag)), int(K9.tc_count_plain(sdag))
    if got_s != plain_s or got_s != _scipy_triangles(small):
        raise RuntimeError(f"[analytics] rmat{PULL_DIRTY_SCALE}: tc_count "
                           f"{got_s}, plain {plain_s}")
    wide = _tc_wide_row()
    bound_ms, bound_by, nbytes = _tc_bound(dag)
    ms = _batch_ms(lambda: K9.tc_count(dag))
    info = {
        "triangles": n, "scipy": want, "launches_per_solve":
        launches["tc_count"], "cold_s": cold, "warm_s_per_solve": warm,
        "dag_edges": dag.ne, "counted_edges": int(dag.src.numel()),
        "tasks": dag.tasks.numel() - 1, "class_start": list(dag.class_start),
        "wide_row": wide, "ms": ms,
        "device_ms": _kernel_device_ms(lambda: K9.tc_count(dag),
                                       "tc_count_kernel"),
        "plain_ms": _batch_ms(lambda: K9.tc_count_plain(dag), calls=1,
                              batches=3),
        "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes,
        "share_of_bound": bound_ms / ms, f"rmat{PULL_DIRTY_SCALE}": got_s}
    print(f"[analytics] tc_count {json.dumps(info)}")
    return dict(info, launches=launches["tc_count"], max_abs_err=0)


def _hindex_bound(layout, core) -> tuple[float, str, int]:
    """The least time the card could take for one sweep, in ms, what bounds
    it, and the bytes: row pointers, ids, the row order and core read once,
    the new values and the count written once; against a compare a slot
    for each step of the row's search on [0, min(deg, core)] (the data's
    count), over the float32 rate (int32 at that rate too)."""
    rp = layout.row_ptr.long()
    deg = rp[1:] - rp[:-1]
    steps = torch.ceil(torch.log2(torch.minimum(deg, core.long()).double()
                                  + 1))
    ops = float((deg.double() * steps).sum())
    nbytes = 4 * (layout.nv + 1) + 4 * layout.ne + 12 * layout.nv + 4
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_FLOP_PER_S * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations", nbytes)


def _hindex_compare(layout, core, what: str) -> None:
    new, changed = K10.hindex_sweep(layout, core)
    want, want_changed = K10.hindex_sweep_plain(layout, core)
    torch.cuda.synchronize()
    if not torch.equal(new, want) or int(changed) != int(want_changed):
        raise RuntimeError(f"[analytics] {what}: hindex_sweep differs from "
                           f"plain in {int((new != want).sum())} rows, "
                           f"changed {int(changed)} against "
                           f"{int(want_changed)}")


class _hsweeps:
    """While active, counts k_core_hindex's sweeps."""

    def __enter__(self):
        self.n = 0
        self.saved = KCM._hindex_sweep

        def counted(core, layout):
            self.n += 1
            return self.saved(core, layout)

        KCM._hindex_sweep = counted
        return self

    def __exit__(self, *exc):
        KCM._hindex_sweep = self.saved


def _star_joined(g, leaves: int):
    """``g`` and one more vertex joined to every vertex of ``g`` and to
    ``leaves`` leaves of its own."""
    src, dst = g.coo()
    hub = g.nv
    nbrs = np.r_[np.arange(g.nv), hub + 1 + np.arange(leaves)]
    return from_edges(np.r_[src, np.full(len(nbrs), hub), nbrs],
                      np.r_[dst, nbrs, np.full(len(nbrs), hub)],
                      g.nv + 1 + leaves)


def phase_kcore(g, dg) -> dict:
    """K10 against its plain version on one sweep from the degrees at the
    analytics size (timed beside its bound, by kernel) and at rmat13 behind
    the dirtied allocator, and on rmat13 joined to a star wider than a hub
    block's histogram (k_core_hindex there held to the serial oracle); then
    k_core_hindex (its summed device ms a solve) and k_core_peel, every
    count set to 0 just before each, held to the serial oracle exactly.
    Returns K10's entry data."""
    t0 = time.perf_counter()
    want = verifiers.kcore_serial(g)
    print(f"[analytics] kcore_serial in {time.perf_counter() - t0:.2f} s: "
          f"max coreness {want.max()}")
    layout = KCM.hindex_state(g, device="cuda", with_plain=True)
    deg = dg.deg.clone()
    _hindex_compare(layout, deg, f"rmat{ANALYTICS_SCALE}")
    small = rmat(PULL_DIRTY_SCALE, EDGE_FACTOR, seed=0)
    slay = KCM.hindex_state(small, device="cuda", with_plain=True)
    score = torch.from_numpy(small.degrees().astype(np.int32)).cuda()
    _dirty(small.nv)      # the block the sweep's output comes from
    _hindex_compare(slay, score, f"rmat{PULL_DIRTY_SCALE}")
    star = _star_joined(small, HINDEX_STAR_LEAVES)
    stlay = KCM.hindex_state(star, device="cuda", with_plain=True)
    sdeg = torch.from_numpy(star.degrees().astype(np.int32)).cuda()
    _hindex_compare(stlay, sdeg, f"rmat{PULL_DIRTY_SCALE} and a star")
    # a seeded core up to twice the widest row: the star's answer and many
    # rows' are past their first pass's bins, which takes more passes
    gen = torch.Generator(device="cuda").manual_seed(9)
    _hindex_compare(stlay, torch.randint(
        0, 2 * stlay.hub_width, (star.nv,), dtype=torch.int32,
        device="cuda", generator=gen),
        f"rmat{PULL_DIRTY_SCALE} and a star, a random core")
    _exact(KCM.k_core_hindex(star, layout=stlay).cpu().numpy(),
           verifiers.kcore_serial(star), f"k_core_hindex, rmat"
           f"{PULL_DIRTY_SCALE} and a star of {HINDEX_STAR_LEAVES} leaves")
    print(f"[analytics] hindex_sweep from the degrees equals plain at "
          f"rmat{ANALYTICS_SCALE} (classes {list(layout.class_start)}, widest "
          f"hub {layout.hub_width}), at rmat{PULL_DIRTY_SCALE} behind a "
          f"NaN-dirtied allocator, and with a hub of {stlay.hub_width} "
          f"neighbours, where k_core_hindex equals kcore_serial")
    _zero_counts()
    with _hsweeps() as sw:
        core = KCM.k_core_hindex(g, device="cuda")
        torch.cuda.synchronize()
    launches = _counts()
    _assert_counts("[analytics] k_core_hindex", launches,
                   {"hindex_sweep": sw.n})
    _exact(core.cpu().numpy(), want, "k_core_hindex")
    if ANALYTICS_SCALE == 19 and sw.n != KCORE_SWEEPS_RMAT19:
        raise RuntimeError(f"[analytics] k_core_hindex took {sw.n} sweeps on "
                           f"rmat(19, 16), not {KCORE_SWEEPS_RMAT19}")
    solve_by = _device_ms_by_name(lambda: KCM.k_core_hindex(g, layout=layout),
                                  1)
    info = {"solver": "k_core_hindex", "sweeps": sw.n,
            "solve_device_ms": (sum(v for k, v in solve_by.items()
                                    if "hindex" in k) if solve_by else None),
            "solve_device_ms_by_name": solve_by,
            "launches": launches["hindex_sweep"],
            "s_per_solve": _solve_seconds(
                lambda: KCM.k_core_hindex(g, device="cuda")),
            "s_per_solve_prebuilt_layout": _solve_seconds(
                lambda: KCM.k_core_hindex(g, layout=layout))}
    _zero_counts()
    with _sweeps() as pw:
        peel = KCM.k_core_peel(dg)
        torch.cuda.synchronize()
    counts = _counts()
    _assert_counts("[analytics] k_core_peel", counts,
                   {"neighbor_reduce": pw.n})
    _exact(peel.cpu().numpy(), want, "k_core_peel")
    peel_s = _solve_seconds(lambda: KCM.k_core_peel(dg), solves=1)
    bound_ms, bound_by, nbytes = _hindex_bound(layout, deg)
    ms = _batch_ms(lambda: K10.hindex_sweep(layout, deg))
    by_name = _device_ms_by_name(lambda: K10.hindex_sweep(layout, deg),
                                 TIMED_CALLS)
    info.update(
        max_coreness=int(want.max()), peel_neighbor_reduce=pw.n,
        peel_s=peel_s, ms=ms,
        device_ms=(sum(v for k, v in by_name.items() if "hindex" in k)
                   if by_name else None),
        device_ms_by_name=by_name,
        plain_ms=_batch_ms(lambda: K10.hindex_sweep_plain(layout, deg),
                           calls=1, batches=3),
        bound_ms=bound_ms, bound_by=bound_by, bound_bytes=nbytes,
        share_of_bound=bound_ms / ms)
    print(f"[analytics] k-core {json.dumps(info)}")
    return dict(info, max_abs_err=0)


def _brandes_f64(g, source: int) -> tuple[np.ndarray, int]:
    """Level-synchronous Brandes in float64 with scipy on a symmetric
    graph: path counts by frontier SpMVs, dependencies level by level
    back. Returns (delta, levels)."""
    a = _scipy_csr(g)
    nv = g.nv
    dist = np.full(nv, -1, np.int64)
    dist[source] = 0
    sigma = np.zeros(nv)
    sigma[source] = 1.0
    frontier = dist == 0
    lvl = 0
    while frontier.any():
        reach = a @ np.where(frontier, sigma, 0.0)
        frontier = (reach > 0) & (dist < 0)
        sigma[frontier] = reach[frontier]
        dist[frontier] = lvl + 1
        lvl += 1
    delta = np.zeros(nv)
    for k in range(lvl - 1, 0, -1):
        on = (dist == k) & (sigma > 0)
        acc = a @ np.where(on, (1.0 + delta) / np.where(on, sigma, 1.0), 0.0)
        delta += np.where(dist == k - 1, sigma * acc, 0.0)
    delta[source] = 0.0
    return delta, lvl - 1


def _bc_close(got: np.ndarray, want: np.ndarray, what: str) -> float:
    err = float(np.abs(got - want).max())
    if not np.allclose(got, want, rtol=BC_RTOL, atol=BC_ATOL):
        raise RuntimeError(f"[analytics] {what}: max |diff| {err} beyond "
                           f"rtol {BC_RTOL}, atol {BC_ATOL}")
    return err


def phase_bc(g, dg) -> dict:
    """bc_single_source from vertex 0 at the analytics size, every count
    set to 0 just before it, held to a float64 Brandes written with scipy,
    with its levels and neighbor_reduce launches (one a level, forward and
    back); at rmat13 held to the serial oracle."""
    ref, levels = _brandes_f64(g, 0)
    _zero_counts()
    with _sweeps() as sw:
        got = BCM.bc_single_source(dg, 0)
        torch.cuda.synchronize()
    counts = _counts()
    _assert_counts("[analytics] bc_single_source", counts,
                   {"neighbor_reduce": sw.n})
    # forward: a sweep a level and one that finds nothing; back: one a level
    # below the deepest
    if sw.n != 2 * levels + 1:
        raise RuntimeError(f"[analytics] bc_single_source: {sw.n} sweeps for "
                           f"{levels} levels")
    err = _bc_close(got.cpu().numpy(), ref, f"bc rmat{ANALYTICS_SCALE}")
    small = rmat(PULL_DIRTY_SCALE, EDGE_FACTOR, seed=0)
    sdg = to_device_graph(small, device="cuda", with_transpose=False)
    err_s = _bc_close(BCM.bc_single_source(sdg, 0).cpu().numpy(),
                      verifiers.bc_serial(small, [0]),
                      f"bc rmat{PULL_DIRTY_SCALE} against bc_serial")
    info = {"solver": "bc_single_source", "levels": levels, "sweeps": sw.n,
            "launches": counts["neighbor_reduce"], "max_abs_err": err,
            f"rmat{PULL_DIRTY_SCALE}_max_abs_err": err_s,
            "s_per_solve": _solve_seconds(
                lambda: BCM.bc_single_source(dg, 0))}
    print(f"[analytics] {json.dumps(info)}")
    return info


def phase_analytics() -> tuple[dict, dict, dict, object, object]:
    """K8, K9, K10 and the analytics solvers. Returns the kernels' entry
    data: K8's timed cases, its largest error and the launches of the pull
    solvers' path; K9's and K10's from their phases; and the graph, on the
    host and on the card, for the compress phase."""
    t0 = time.perf_counter()
    g = rmat(ANALYTICS_SCALE, EDGE_FACTOR, seed=0)
    t1 = time.perf_counter()
    dg = to_device_graph(g, device="cuda")
    torch.cuda.synchronize()
    print(f"[analytics] rmat({ANALYTICS_SCALE}, {EDGE_FACTOR}) generated in "
          f"{t1 - t0:.2f} s, on the card in {time.perf_counter() - t1:.2f} s")
    if not is_symmetric(g):
        raise RuntimeError("the analytics graph must be symmetric")
    pull = phase_pull_kernel(dg)
    launches = phase_solvers(g, dg)
    tc = phase_tc(g)
    kcore = phase_kcore(g, dg)
    phase_bc(g, dg)
    phase_grid_and_directed()
    phase_analytics_cli()
    print(f"[analytics] phase took {time.perf_counter() - t0:.2f} s")
    return dict(pull, launches=launches), tc, kcore, g, dg


# ---- the compress phase ----------------------------------------------------

def _bound_of(nbytes: float, ops: float) -> tuple[float, str, float]:
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_FLOP_PER_S * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations", nbytes)


def _vgb_tags_bound(vgb) -> tuple[float, str, float]:
    """vgb_tags' bound on a VarintGB prep: the stream read once, the row
    tables (first tag byte, group count, first group) read once, the tag
    positions written once, over the memory rate, against OPS_PER_VALUE a
    group over the float32 rate."""
    n_g = vgb["n_g"]
    return _bound_of(vgb["stream"].numel() + 12 * vgb["nv"] + 4 * n_g,
                     n_g * OPS_PER_VALUE)


def _svb_decode_bound(stream_bytes: int, rows: int,
                      values: int) -> tuple[float, str, float]:
    """svb_decode's bound: the stream read once, the row tables (key start,
    count, output slot) read once, the ids written once, over the memory
    rate, against OPS_PER_VALUE a value over the float32 rate."""
    return _bound_of(stream_bytes + 12 * rows + 4 * values,
                     values * OPS_PER_VALUE)


def _vgb_values_bound(vgb) -> tuple[float, str, float]:
    """vgb_values' bound on a VarintGB prep: the stream read once, the tag
    positions and the row tables (first group, count, first slot) read
    once, the ids written once, over the memory rate, against
    OPS_PER_VALUE a value over the float32 rate."""
    ne = vgb["ne"]
    return _bound_of(vgb["stream"].numel() + 4 * vgb["n_g"] + 12 * vgb["nv"]
                     + 4 * ne, ne * OPS_PER_VALUE)


def _cgr_residual_bound(lanes: int, ids: int,
                        bits: float) -> tuple[float, str, float]:
    """cgr_residual's bound on ``lanes`` lanes writing ``ids`` ids from
    ``bits`` bits of codes (the lanes' final positions less their first):
    the lane tables (position, count, vertex, first slot) read and the
    final positions written once, the ids written once, the code bits read
    once, over the memory rate, against OPS_PER_CODE a code over the
    float32 rate."""
    return _bound_of(20 * lanes + 4 * ids + bits / 8, ids * OPS_PER_CODE)


def _cgr_merge_bound(prep) -> tuple[float, str, float]:
    """cgr_merge's bound on a CGR prep with intervals: the residuals, the
    row tables (row pointer, residual count, interval pointer), the
    intervals (left, length, the lengths' prefix) read once, the row's ids
    written once, against OPS_PER_CODE for every eighth id."""
    nv, ne, n_itv = prep["nv"], prep["ne"], prep["n_itv"]
    nres = float(prep["nres"].long().sum())
    return _bound_of(4 * nres + 12 * nv + 8 + 12 * n_itv + 4 + 4 * ne,
                     ne / 8 * OPS_PER_CODE)


def _interval_residuals(itv, what: str):
    """cgr_residual on an interval stream's residual lanes, under the
    prep's tables and under those it builds itself, against the plain
    version: each lane's final bit, and the residuals (which leave the
    interval ids' slots as allocated) merged by the plain merge. Returns
    the residual buffer and cgr_merge's operands."""
    lanes = [itv[k] for k in ("data_p", "counts", "lane_v_d", "base")]
    ne, k = itv["ne"], itv["zeta_k"]
    pres, ppfin = K12.cgr_residual_plain(itv["stream"], *lanes, ne, k)
    rest = (itv["row_ptr_d"], itv["nres"], itv["itv_ptr"], itv["left"],
            itv["length"], itv["itv_pre"])
    want = K12.cgr_merge_plain(pres, *rest)
    for tables in (itv["res_tables"], {}):
        res, pfin = K12.cgr_residual(itv["stream"], *lanes, ne, k, **tables)
        torch.cuda.synchronize()
        if (not torch.equal(pfin, ppfin)
                or not torch.equal(K12.cgr_merge_plain(res, *rest), want)):
            raise RuntimeError(f"{what}: cgr_residual on the interval "
                               f"stream's lanes differs from plain "
                               f"({'with' if tables else 'without'} its "
                               f"tables)")
    return res, (res, *rest)


def _k12_cases(plain_prep, itv_prep, tag: str, timed: bool) -> dict:
    """Each K12 kernel against its plain version on the lanes of the two
    streams' preps: cgr_gamma on every residual segment's count (and the
    vertices' headers), cgr_residual on the plain stream's lanes (where
    they cover every slot) and on the interval stream's residual lanes,
    each under the prep's tables and under those it builds itself,
    cgr_interval on the interval stream's interval lanes, cgr_merge on that
    stream's residual buffer. Exact, int32. With
    ``timed``, each beside its bound: the bytes the data needs (positions
    and lane tables read, outputs written, the stream bits decoded) and
    OPS_PER_CODE a code. Untimed, each output block is dirtied with NaN
    first."""
    out = {}
    stream = plain_prep["stream"]

    def check(name, got, want):
        for a, b in zip(got, want):
            if not torch.equal(a, b):
                raise RuntimeError(f"[compress] {tag}: {name} differs from "
                                   f"plain in {int((a != b).sum())} of "
                                   f"{a.numel()}")

    def run(name, fn, plain, n_out, bound):
        if not timed:
            _dirty(n_out)
        got = fn()
        torch.cuda.synchronize()
        check(name, got if isinstance(got, tuple) else (got,),
              plain() if isinstance(got, tuple) else (plain(),))
        if not timed:
            return
        bound_ms, bound_by, nb = bound
        ms = _batch_ms(fn)
        out[name] = {"case": f"{name} {tag}", "ms": ms,
                     "device_ms": _kernel_device_ms(fn, f"{name}_kernel"),
                     "plain_ms": _batch_ms(plain, calls=1, batches=3),
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_bytes": nb, "share_of_bound": bound_ms / ms}
        print(f"[compress] {json.dumps(out[name])}")

    seg = torch.from_numpy(plain_prep["seg_start"].astype(np.int32)).cuda()
    _, nxt = K12.cgr_gamma(stream, seg, K12.COUNT)
    bits = float((nxt.long() - seg.long()).sum())
    run("cgr_gamma", lambda: K12.cgr_gamma(stream, seg, K12.COUNT),
        lambda: K12.cgr_gamma_plain(stream, seg, K12.COUNT), 2 * seg.numel(),
        _bound_of(12 * seg.numel() + bits / 8, seg.numel() * OPS_PER_CODE))
    bit_off = plain_prep["bit_off"]
    got = K12.cgr_gamma(stream, bit_off, K12.HEADER)
    check("cgr_gamma header", got,
          K12.cgr_gamma_plain(stream, bit_off, K12.HEADER))
    # the interval stream's residual headers (0 for a vertex without an
    # interval section, out of order), as the prep finds them and in a
    # random order
    istream = itv_prep["stream"]
    ilanes = itv_prep["itv_lanes"]
    n_itv, m = int(itv_prep["left"].numel()), itv_prep["min_itv_len"]
    _, _, ipfin = K12.cgr_interval(istream, *ilanes, n_itv, m)
    res_pos = torch.from_numpy(CD.residual_header_pos(
        np.bincount(ilanes[2].cpu().numpy(), minlength=itv_prep["nv"]),
        ipfin.cpu().numpy()).astype(np.int32)).cuda()
    shuffled = res_pos[torch.randperm(res_pos.numel(), device="cuda",
                                      generator=torch.Generator(
                                          device="cuda").manual_seed(0))]
    for what, pos in (("res_pos", res_pos), ("res_pos shuffled", shuffled)):
        if not timed:
            _dirty(2 * pos.numel())
        got = K12.cgr_gamma(istream, pos, K12.HEADER)
        torch.cuda.synchronize()
        check(f"cgr_gamma {what}", got,
              K12.cgr_gamma_plain(istream, pos, K12.HEADER))
    lanes = [plain_prep[k] for k in ("data_p", "counts", "lane_v_d", "base")]
    ne, k = plain_prep["ne"], plain_prep["zeta_k"]
    rt = plain_prep["res_tables"]
    _, pfin = K12.cgr_residual(stream, *lanes, ne, k, **rt)
    bits = float((pfin.long() - lanes[0].long()).sum())
    n_l = lanes[0].numel()
    run("cgr_residual", lambda: K12.cgr_residual(stream, *lanes, ne, k, **rt),
        lambda: K12.cgr_residual_plain(stream, *lanes, ne, k), ne + n_l,
        _cgr_residual_bound(n_l, ne, bits))
    check("cgr_residual under the tables it builds itself",
          K12.cgr_residual(stream, *lanes, ne, k),
          K12.cgr_residual_plain(stream, *lanes, ne, k))
    bits = float((ipfin.long() - ilanes[0].long()).sum())
    n_i = ilanes[0].numel()
    run("cgr_interval", lambda: K12.cgr_interval(istream, *ilanes, n_itv, m),
        lambda: K12.cgr_interval_plain(istream, *ilanes, n_itv, m),
        2 * n_itv + n_i,
        _bound_of(20 * n_i + 8 * n_itv + bits / 8, 2 * n_itv * OPS_PER_CODE))
    _, margs = _interval_residuals(itv_prep, f"[compress] {tag}")
    tables = itv_prep["merge_tables"]
    run("cgr_merge", lambda: K12.cgr_merge(*margs, **tables),
        lambda: K12.cgr_merge_plain(*margs), itv_prep["ne"],
        _cgr_merge_bound(itv_prep))
    return out


def _refused(cg, gs) -> None:
    """The interval stream at the reference's itv_seg_len of 32 holds
    interval segments whose one item outgrows the slot (a left 2^19 away
    takes a 39-bit gamma): the device route must refuse it with ValueError,
    before any decode pass, and the host must decode it exactly."""
    _zero_counts()
    try:
        CD.cgr_device_prep(cg, device="cuda")
    except ValueError as e:
        reason = str(e)
    else:
        raise RuntimeError("[compress] the device route took an interval "
                           "stream with oversized 32-bit segments")
    launches = {k: v for k, v in _counts().items() if v}
    if set(launches) - {"cgr_gamma"}:
        raise RuntimeError(f"[compress] refused after {launches}")
    t0 = time.perf_counter()
    host = CGR.decode_graph(cg, degrees=gs.degrees())
    if not np.array_equal(host.col_idx, gs.col_idx):
        raise RuntimeError("[compress] the host decode of the refused "
                           "stream differs from the CSR")
    print(f"[compress] interval_seg32: the device route refuses it ({reason};"
          f" launches {launches}); the native host decode equals the CSR, "
          f"{time.perf_counter() - t0:.2f} s")


def _decode(cg, gs, col_ref, tag: str) -> tuple[dict, dict]:
    """cgr_device_prep and cgr_device_run on the card, every count set to 0
    just before them: the CSR must come out exactly, through the kernels
    the stream's shape needs. Returns (prep, info)."""
    itv = cg.cfg.use_interval
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prep = CD.cgr_device_prep(cg, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    row_ptr, col = CD.cgr_device_run(prep)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = _counts()
    want = CGR_DECODE_LAUNCHES[itv]
    _assert_counts(f"[compress] {tag} decode", launches, want)
    if not np.array_equal(row_ptr, gs.row_ptr) or not torch.equal(col,
                                                                   col_ref):
        raise RuntimeError(f"[compress] {tag}: the device decode differs from "
                           f"the CSR")
    warm = _solve_seconds(lambda: CD.cgr_device_run(prep))
    info = {"stream": tag, "bytes": cg.nbytes,
            "ratio": cg.compression_ratio(), "prep_s": t1 - t0,
            "run_s": t2 - t1, "warm_run_s": warm,
            "decoded_edges_per_s": gs.ne / warm, "launches": want,
            "intervals": prep["n_itv"], "lanes": int(prep["data_p"].numel())}
    print(f"[compress] {json.dumps(info)}")
    return prep, info


# the prep (host work and uploads) and the run (the kernels) of each byte
# codec's device decode
VBYTE_ROUTES = {
    "streamvbyte": (DD.streamvbyte_device_prep, DD.streamvbyte_device_run),
    "varintgb": (DD.varintgb_device_prep, DD.varintgb_device_run),
    "hybrid": (DD.hybrid_device_prep, DD.hybrid_device_run),
}


def _vbyte_encode(gs) -> dict:
    """The graph in StreamVByte, VarintGB and hybrid (threshold 32,
    StreamVByte chunks) by the host encoders, with each encode's seconds,
    bytes and ratio."""
    out = {}
    for scheme in VBYTE_ROUTES:
        t0 = time.perf_counter()
        obj = (HYB.encode_graph(gs) if scheme == "hybrid"
               else VB.encode_graph(gs, scheme))
        out[scheme] = (obj, time.perf_counter() - t0)
        print(f"[compress] {scheme}: host encode {out[scheme][1]:.2f} s, "
              f"{len(obj.data)} bytes, ratio {obj.compression_ratio():.4f}x")
    return out


def _vbyte_decode(scheme: str, obj, gs, col_ref) -> tuple[dict, dict]:
    """The scheme's device prep and run on the card, every count set to 0
    just before them: the CSR must come out exactly, through the kernels
    the scheme needs. Returns (prep, info)."""
    prep_fn, run_fn = VBYTE_ROUTES[scheme]
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prep = prep_fn(obj, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    col = run_fn(prep)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    want = VBYTE_DECODE_LAUNCHES[scheme]
    _assert_counts(f"[compress] {scheme} decode", _counts(), want)
    if not np.array_equal(prep["row_ptr"], gs.row_ptr) or not torch.equal(
            col, col_ref):
        raise RuntimeError(f"[compress] {scheme}: the device decode differs "
                           f"from the CSR")
    del col
    warm = _solve_seconds(lambda: run_fn(prep))
    info = {"stream": scheme, "bytes": len(obj.data),
            "ratio": obj.compression_ratio(), "prep_s": t1 - t0,
            "run_s": t2 - t1, "warm_run_s": warm,
            "decoded_edges_per_s": gs.ne / warm, "launches": want}
    print(f"[compress] {json.dumps(info)}")
    return prep, info


def _col(ne: int) -> torch.Tensor:
    return torch.empty(ne, dtype=torch.int32, device="cuda")


def _high_bytes(hg) -> int:
    """The bytes of a hybrid's StreamVByte chunks: what svb_decode reads."""
    return int(np.diff(hg.offsets)[np.asarray(hg.degrees)
                                   >= hg.threshold].sum())


def _vgb_value_routes(stream, tagpos, rows, ne: int, tag: str) -> dict:
    """vgb_values' two routes apart, each against the plain version on the
    same rows: the rows above VGB_LONG_GROUPS groups alone (a block each,
    widest first) and the others alone (tiles), each under the tables
    vgb_value_tables builds for them; then every row under the tables the
    kernel builds itself. Returns the rows and groups of each route."""
    ng = (rows[1].long() + 3) >> 2
    info = {}
    for route, keep in (("long", ng > K11.VGB_LONG_GROUPS),
                        ("tiles", ng <= K11.VGB_LONG_GROUPS)):
        sub = tuple(a[keep].contiguous() for a in rows)
        tables = K11.vgb_value_tables(*sub)
        got = K11.vgb_values(stream, tagpos, *sub, _col(ne).fill_(-1),
                             **tables)
        want = K11.vgb_values_plain(stream, tagpos, *sub, _col(ne).fill_(-1))
        if not torch.equal(got, want):
            raise RuntimeError(f"[compress] {tag}: vgb_values' {route} route "
                               f"differs from plain in "
                               f"{int((got != want).sum())} slots")
        info[route] = {"rows": int(keep.sum()), "groups": int(ng[keep].sum()),
                       "long_blocks": int(tables["long_rows"].numel()),
                       "tiles": int(tables["tiles"].shape[0]) - 1}
    got = K11.vgb_values(stream, tagpos, *rows, _col(ne).fill_(-1))
    if not torch.equal(got, K11.vgb_values_plain(stream, tagpos, *rows,
                                                 _col(ne).fill_(-1))):
        raise RuntimeError(f"[compress] {tag}: vgb_values under the tables "
                           f"it builds itself differs from plain")
    print(f"[compress] {tag}: vgb_values' long rows and tiles apart equal "
          f"plain {json.dumps(info)}")
    return info


def _svb_routes(stream, rows, ne: int, tag: str) -> dict:
    """svb_decode's two routes apart, each against the plain version on the
    same rows: the rows above SVB_LONG_VALUES values alone (a block each,
    widest first) and the others alone (tiles), each under the tables
    svb_tables builds for them; then every row under the tables the
    kernel builds itself. Returns the rows and values of each route."""
    n = rows[1]
    info = {}
    for route, keep in (("long", n > K11.SVB_LONG_VALUES),
                        ("tiles", n <= K11.SVB_LONG_VALUES)):
        sub = tuple(a[keep].contiguous() for a in rows)
        tables = K11.svb_tables(sub[1])
        routed = (int(tables["long_rows"].numel()),
                  int(tables["tiles"].numel()) - 1)
        got = K11.svb_decode(stream, *sub, _col(ne).fill_(-1), **tables)
        want = K11.svb_decode_plain(stream, *sub, _col(ne).fill_(-1))
        if not torch.equal(got, want):
            raise RuntimeError(f"[compress] {tag}: svb_decode's {route} route "
                               f"differs from plain in "
                               f"{int((got != want).sum())} slots")
        info[route] = {"rows": int(keep.sum()), "values": int(n[keep].sum()),
                       "long_blocks": routed[0], "tiles": routed[1]}
    got = K11.svb_decode(stream, *rows, _col(ne).fill_(-1))
    if not torch.equal(got, K11.svb_decode_plain(stream, *rows,
                                                 _col(ne).fill_(-1))):
        raise RuntimeError(f"[compress] {tag}: svb_decode under the tables it "
                           f"builds itself differs from plain")
    print(f"[compress] {tag}: svb_decode's long rows and tiles apart equal "
          f"plain {json.dumps(info)}")
    return info


def _k11_cases(svb, vgb, tag: str, timed: bool, hyb=None) -> dict:
    """Each K11 kernel against its plain version on the rows of the
    StreamVByte and VarintGB preps: svb_decode on every row (and, given the
    hybrid prep ``hyb``, on hybrid's high rows, and K12's cgr_residual on
    its low rows, under the prep's tables and under those it builds
    itself), under the prep's tables, and each of its routes apart;
    vgb_tags on every row's tag chain, vgb_values on the tag positions
    under the prep's tables, and each of its routes apart. Exact, int32.
    With ``timed``, each
    beside its bound: the stream (hybrid: its high rows' chunks) read once,
    the row tables (and the tag positions) read once, the output written
    once, over the memory rate, against OPS_PER_VALUE a value over the
    float32 rate. Untimed, each output block is dirtied with NaN first."""
    out = {}

    def run(name, fn, plain, n_out, bound, key=None, kernel=None, keep=None):
        if not timed:
            _dirty(n_out)
        got = fn()
        torch.cuda.synchronize()
        want = plain()
        if keep is not None:     # (col, pfin): col's slots of these lanes
            got, want = (torch.cat([got[0][keep], got[1]]),
                         torch.cat([want[0][keep], want[1]]))
        if not torch.equal(got, want):
            raise RuntimeError(f"[compress] {tag}: {name} differs from plain "
                               f"in {int((got != want).sum())} of "
                               f"{got.numel()}")
        if not timed:
            return
        bound_ms, bound_by, nb = bound
        ms = _batch_ms(fn)
        device_ms = _kernel_device_ms(fn, f"{kernel or name}_kernel")
        out[key or name] = {
            "case": f"{name} {tag}", "ms": ms, "device_ms": device_ms,
            "plain_ms": _batch_ms(plain, calls=1, batches=3),
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nb,
            "share_of_bound": bound_ms / ms,
            "share_of_bound_device": (bound_ms / device_ms if device_ms
                                      else None)}
        print(f"[compress] {json.dumps(out[key or name])}")

    stream, ne, nv = svb["stream"], svb["ne"], svb["nv"]
    rows = (svb["key_start"], svb["degrees"], svb["out_slot"])
    tables = svb["svb_tables"]
    run("svb_decode", lambda: K11.svb_decode(stream, *rows, _col(ne),
                                             **tables),
        lambda: K11.svb_decode_plain(stream, *rows, _col(ne)), ne,
        _svb_decode_bound(stream.numel(), nv, ne))
    _svb_routes(stream, rows, ne, f"{tag} StreamVByte")
    if hyb is not None:
        # the low rows' slots are not svb_decode's: both sides keep -1 there
        high, hstream = hyb["high"], hyb["stream"]
        values = int(high[1].long().sum())
        hcol = _col(hyb["ne"]).fill_(-1)
        run("svb_decode hybrid", lambda: K11.svb_decode(
                hstream, *high, hcol, **hyb["svb_tables"]),
            lambda: K11.svb_decode_plain(hstream, *high,
                                         _col(hyb["ne"]).fill_(-1)),
            hyb["ne"], _svb_decode_bound(hyb["high_bytes"], high[0].numel(),
                                         values),
            key="svb_decode_hybrid", kernel="svb_decode")
        _svb_routes(hstream, high, hyb["ne"], f"{tag} hybrid")
        # the low rows, a cgr_residual lane each: not consecutive (the
        # high rows lie between them), their slots alone compared
        low, zk, hne = hyb["low"], hyb["zeta_k"], hyb["ne"]
        rt = hyb["res_tables"]
        n = low[1].long()
        keep = torch.zeros(hne, dtype=torch.bool, device="cuda")
        keep[torch.repeat_interleave(low[3].long() - (torch.cumsum(n, 0) - n),
                                     n, output_size=int(n.sum()))
             + torch.arange(int(n.sum()), device="cuda")] = True
        _, pfin = K12.cgr_residual(hstream, *low, hne, zk, **rt)
        bits = float((pfin.long() - low[0].long()).sum())
        run("cgr_residual hybrid", lambda: K12.cgr_residual(
                hstream, *low, hne, zk, **rt),
            lambda: K12.cgr_residual_plain(hstream, *low, hne, zk),
            hne + low[0].numel(),
            _cgr_residual_bound(low[0].numel(), int(n.sum()), bits),
            key="cgr_residual_hybrid", kernel="cgr_residual", keep=keep)
        got = K12.cgr_residual(hstream, *low, hne, zk)
        want = K12.cgr_residual_plain(hstream, *low, hne, zk)
        if (not torch.equal(got[0][keep], want[0][keep])
                or not torch.equal(got[1], want[1])):
            raise RuntimeError(f"[compress] {tag}: cgr_residual on hybrid's "
                               f"low rows under the tables it builds itself "
                               f"differs from plain")
    stream, ne, nv, n_g = vgb["stream"], vgb["ne"], vgb["nv"], vgb["n_g"]
    chain = (vgb["pos"], vgb["ngroups"], vgb["gbase"])
    tables = vgb["tag_tables"]
    run("vgb_tags", lambda: K11.vgb_tags(stream, *chain, n_g, **tables),
        lambda: K11.vgb_tags_plain(stream, *chain, n_g), n_g,
        _vgb_tags_bound(vgb))
    tagpos = K11.vgb_tags_plain(stream, *chain, n_g)
    if not torch.equal(K11.vgb_tags(stream, *chain, n_g), tagpos):
        raise RuntimeError(f"[compress] {tag}: vgb_tags under the tables it "
                           f"builds itself differs from plain")
    rows = (vgb["gbase"], vgb["counts"], vgb["out_slot"])
    vt = vgb["value_tables"]
    run("vgb_values", lambda: K11.vgb_values(stream, tagpos, *rows, _col(ne),
                                             **vt),
        lambda: K11.vgb_values_plain(stream, tagpos, *rows, _col(ne)), ne,
        _vgb_values_bound(vgb))
    _vgb_value_routes(stream, tagpos, rows, ne, f"{tag} VarintGB")
    return out


def _star_decodes() -> dict:
    """rmat13 joined to a star of DECODE_STAR_LEAVES leaves numbered right
    after the hub, through sort_and_clean: in VarintGB the hub's row is a
    long row of many rounds, in CGR with intervals at itv_seg_len 64 two
    intervals (every rmat13 vertex, then the leaves) and no residual, a
    stream the device route takes (no StreamRefused), in plain CGR many
    residual segments. vgb_tags, vgb_values, cgr_residual and cgr_merge
    under their preps' tables (and the first three under the tables they
    build themselves) against their plain versions, the decodes against the
    CSR."""
    t0 = time.perf_counter()
    g = sort_and_clean(_star_joined(rmat(PULL_DIRTY_SCALE, EDGE_FACTOR,
                                         seed=0), DECODE_STAR_LEAVES))
    hub = int(np.argmax(g.degrees()))
    col_ref = torch.from_numpy(g.col_idx).cuda()
    svb = DD.streamvbyte_device_prep(VB.encode_graph(g, "streamvbyte"),
                                     device="cuda")
    rows = (svb["key_start"], svb["degrees"], svb["out_slot"])
    if not torch.equal(
            K11.svb_decode(svb["stream"], *rows, _col(g.ne).fill_(-1),
                           **svb["svb_tables"]),
            K11.svb_decode_plain(svb["stream"], *rows, _col(g.ne).fill_(-1))):
        raise RuntimeError("[compress] star: svb_decode differs from plain")
    if not torch.equal(DD.streamvbyte_device_run(svb), col_ref):
        raise RuntimeError("[compress] star: the StreamVByte decode differs "
                           "from the CSR")
    svb_long = int(svb["svb_tables"]["long_rows"].numel())
    del svb, rows
    vgb = DD.varintgb_device_prep(VB.encode_graph(g, "varintgb"),
                                  device="cuda")
    chain = (vgb["stream"], vgb["pos"], vgb["ngroups"], vgb["gbase"],
             vgb["n_g"])
    if not torch.equal(K11.vgb_tags(*chain, **vgb["tag_tables"]),
                       K11.vgb_tags_plain(*chain)):
        raise RuntimeError("[compress] star: vgb_tags differs from plain")
    tagpos = K11.vgb_tags_plain(*chain)
    vrows = (vgb["gbase"], vgb["counts"], vgb["out_slot"])
    for tables in (vgb["value_tables"], {}):
        if not torch.equal(
                K11.vgb_values(vgb["stream"], tagpos, *vrows, _col(g.ne),
                               **tables),
                K11.vgb_values_plain(vgb["stream"], tagpos, *vrows,
                                     _col(g.ne))):
            raise RuntimeError(f"[compress] star: vgb_values differs from "
                               f"plain ({'with' if tables else 'without'} "
                               f"its tables)")
    vgb_long = int(vgb["value_tables"]["long_rows"].numel())
    if not torch.equal(DD.varintgb_device_run(vgb), col_ref):
        raise RuntimeError("[compress] star: the VarintGB decode differs "
                           "from the CSR")
    cg = CGR.encode_graph(g, CGR_STREAMS["interval"])
    try:
        itv = CD.cgr_device_prep(cg, device="cuda")
    except CD.StreamRefused as e:
        raise RuntimeError(f"[compress] star: the device route refused the "
                           f"interval stream: {e}") from e
    _, margs = _interval_residuals(itv, "[compress] star")
    if not torch.equal(K12.cgr_merge(*margs, **itv["merge_tables"]),
                       K12.cgr_merge_plain(*margs)):
        raise RuntimeError("[compress] star: cgr_merge differs from plain")
    row_ptr, col = CD.cgr_device_run(itv)
    if not np.array_equal(row_ptr, g.row_ptr) or not torch.equal(col,
                                                                 col_ref):
        raise RuntimeError("[compress] star: the CGR decode differs from the "
                           "CSR")
    # plain CGR: the hub's 50,000 ids in many residual segments
    plain = CD.cgr_device_prep(CGR.encode_graph(g, CGR_STREAMS["plain"]),
                               device="cuda")
    lanes = [plain[k] for k in ("data_p", "counts", "lane_v_d", "base")]
    want = K12.cgr_residual_plain(plain["stream"], *lanes, g.ne,
                                  plain["zeta_k"])
    for tables in (plain["res_tables"], {}):
        got = K12.cgr_residual(plain["stream"], *lanes, g.ne, plain["zeta_k"],
                               **tables)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError(f"[compress] star: cgr_residual on the plain "
                               f"stream differs from plain "
                               f"({'with' if tables else 'without'} its "
                               f"tables)")
    row_ptr, col = CD.cgr_device_run(plain)
    if not np.array_equal(row_ptr, g.row_ptr) or not torch.equal(col,
                                                                 col_ref):
        raise RuntimeError("[compress] star: the plain CGR decode differs "
                           "from the CSR")
    ip = itv["itv_ptr"][hub:hub + 2].tolist()
    info = {"nv": g.nv, "ne": g.ne, "hub_ids": int(g.degrees()[hub]),
            "svb_long_rows": svb_long, "vgb_values_long_rows": vgb_long,
            "hub_segments": int(plain["nsegs"][hub]),
            "hub_groups": int(vgb["ngroups"][hub]),
            "hub_residuals": int(itv["nres"][hub]),
            "hub_intervals": itv["length"][ip[0]:ip[1]].tolist(),
            "seconds": time.perf_counter() - t0}
    print(f"[compress] star: svb_decode, vgb_tags, vgb_values, "
          f"cgr_residual and cgr_merge equal plain (with their tables and "
          f"without), the StreamVByte, VarintGB and CGR decodes the CSR "
          f"{json.dumps(info)}")
    return info


def _run_cli(cli, root, env, args_list) -> list:
    """(exit code, stdout, stderr) of each argv of ``args_list``, run side
    by side."""
    procs = [subprocess.Popen([*cli, *a], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for a in args_list]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


def phase_compress_cli() -> None:
    """The port's CLI on rmat(13, 8), in processes side by side: ``compress``
    in the four schemes and CGR with ``-a word -p``; ``verify`` and
    ``decompress`` of each; ``info`` on the CGR prefix; ``analytics tc`` and
    ``bfs`` on the CGR, VarintGB and hybrid prefixes and ``analytics tc`` on
    the StreamVByte one (each decoded on the card, Correct), and
    ``GAB_TC_STREAM=1 analytics tc`` (streamed, Correct)."""
    from graphaibench_tpu_torch.graph.io import load_graph

    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("GAB_SHARDS", "GAB_TC_STREAM")}
    cli = [sys.executable, "-m", "graphaibench_tpu_torch.cli"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ds = os.path.join(tmp, "ds")
        g = rmat(PULL_DIRTY_SCALE, CLI_EDGE_FACTOR, seed=0)
        save_graph(g, ds)
        pre = {k: os.path.join(tmp, k, "g") for k in CLI_SCHEMES}
        for (rc, out, err), k in zip(_run_cli(cli, root, env, [
                ("compress", "compress", ds, pre[k], *f)
                for k, f in CLI_SCHEMES.items()]), CLI_SCHEMES):
            if rc != 0 or not out.startswith(f"|V| {g.nv} |E| {g.ne} "):
                raise RuntimeError(f"cli compress {k}: exit {rc}\n{out}\n"
                                   f"{err[-3000:]}")
            print(f"[compress] cli compress {k}: {out.strip()}")
        runs = [("compress", "verify", ds, pre[k]) for k in CLI_SCHEMES]
        runs += [("compress", "decompress", pre[k],
                  os.path.join(tmp, f"{k}_out")) for k in CLI_SCHEMES]
        res = _run_cli(cli, root, env, runs)
        for (rc, out, err), a in zip(res, runs):
            if rc != 0 or (a[1] == "verify" and out.strip() != "Correct"):
                raise RuntimeError(f"cli {' '.join(a[:2])} {a[-1]}: exit {rc}"
                                   f"\n{out}\n{err[-3000:]}")
        for k in CLI_SCHEMES:
            back = load_graph(os.path.join(tmp, f"{k}_out"))
            if not (np.array_equal(back.row_ptr, g.row_ptr)
                    and np.array_equal(back.col_idx, g.col_idx)):
                raise RuntimeError(f"cli decompress {k}: another graph")
        print(f"[compress] cli verify: Correct x {len(CLI_SCHEMES)}; "
              f"decompress: the graph x {len(CLI_SCHEMES)}")
        stream_env = dict(env, GAB_TC_STREAM="1")
        decoded = [(scheme, kernel) for scheme in CLI_DECODED
                   for kernel in CLI_DECODED[scheme]]
        runs = [("info", pre["cgr"])] + [
            ("analytics", kernel, pre[scheme], *(("0",) if kernel == "bfs"
                                                 else ()))
            for scheme, kernel in decoded]
        res = _run_cli(cli, root, env, runs)
        res += _run_cli(cli, root, stream_env,
                        [("analytics", "tc", pre["cgr_word_p"])])
    rc, out, err = res[0]
    if rc != 0 or out.splitlines()[0] != (f"(compressed prefix, decoded) "
                                          f"|V| {g.nv} |E| {g.ne}"):
        raise RuntimeError(f"cli info on a prefix: exit {rc}\n{out}\n{err}")
    print(f"[compress] cli info: {' / '.join(out.splitlines())}")
    for (rc, out, err), (scheme, kernel) in zip(res[1:-1], decoded):
        lines = out.splitlines()
        if (rc != 0 or f"decoded {scheme} on device cuda" not in lines
                or "device = cuda" not in lines or "Correct" not in lines):
            raise RuntimeError(f"cli analytics {kernel} on a {scheme} prefix: "
                               f"exit {rc}\n{out}\n{err[-3000:]}")
        runtime = next(l for l in lines if l.startswith("runtime"))
        print(f"[compress] cli analytics {kernel} on the {scheme} prefix: "
              f"decoded on the card, Correct, {runtime}")
    rc, out, err = res[-1]
    lines = out.splitlines()
    if (rc != 0 or "Correct" not in lines
            or not any("(streaming, " in l for l in lines)):
        raise RuntimeError(f"GAB_TC_STREAM=1 cli analytics tc: exit {rc}\n"
                           f"{out}\n{err[-3000:]}")
    print(f"[compress] GAB_TC_STREAM=1 cli analytics tc (-a word -p prefix): "
          f"{' / '.join(l for l in lines if 'streaming' in l)}, Correct")
    print(f"[compress] the CLI runs in {time.perf_counter() - t0:.2f} s")


def phase_compress(g, dg) -> dict:
    """The analytics graph through sort_and_clean, encoded in CGR (the
    default config, then with intervals in 64-bit interval segments) by the
    native encoder, decoded on the card through K12 exactly (with the
    reference's 32-bit interval segments the stream is refused by the
    device route and decoded on the host); each K12 kernel against its
    plain version at this size (timed beside its bound) and at rmat13
    behind a dirtied allocator; the same for StreamVByte, VarintGB and
    hybrid through K11; triangle_count of the decoded graph and the
    streaming count equal to the known total, its peak under the CSR's
    bytes; bfs_streaming equal to bfs; then the CLI. Returns K12's and
    K11's entry data."""
    t0 = time.perf_counter()
    gs = sort_and_clean(g)
    same = (np.array_equal(gs.row_ptr, g.row_ptr)
            and np.array_equal(gs.col_idx, g.col_idx))
    print(f"[compress] sort_and_clean of rmat({ANALYTICS_SCALE}, "
          f"{EDGE_FACTOR}) in {time.perf_counter() - t0:.2f} s (the graph "
          f"{'unchanged' if same else 'changed'}: nv {gs.nv}, ne {gs.ne})")
    if not native.available():
        raise RuntimeError("[compress] the native CGR encoder did not build")
    col_ref = torch.from_numpy(gs.col_idx).cuda()
    preps, decodes = {}, {}
    for tag, cfg in CGR_STREAMS.items():
        t1 = time.perf_counter()
        cg = CGR.encode_graph(gs, cfg)
        enc = time.perf_counter() - t1
        print(f"[compress] CGR {tag} ({cfg}): native encode {enc:.2f} s, "
              f"{cg.nbytes} bytes, ratio {cg.compression_ratio():.4f}x")
        if tag == "interval_seg32":
            _refused(cg, gs)
            continue
        preps[tag], decodes[tag] = _decode(cg, gs, col_ref, tag)
        decodes[tag]["encode_s"] = enc
        if tag == "plain":
            plain_cg = cg
    cases = _k12_cases(preps["plain"], preps["interval"],
                       f"rmat{ANALYTICS_SCALE}", timed=True)
    small = sort_and_clean(rmat(PULL_DIRTY_SCALE, EDGE_FACTOR, seed=0))
    sp = {tag: CD.cgr_device_prep(CGR.encode_graph(
        small, CGR_STREAMS[tag]), device="cuda")
        for tag in ("plain", "interval")}
    _k12_cases(sp["plain"], sp["interval"], f"rmat{PULL_DIRTY_SCALE}",
               timed=False)
    print(f"[compress] every K12 kernel equals its plain version at "
          f"rmat{ANALYTICS_SCALE} and at rmat{PULL_DIRTY_SCALE} behind a "
          f"NaN-dirtied allocator")
    del preps, sp
    # the byte codecs, decoded through K11
    vpreps, vobjs = {}, {}
    for scheme, (obj, enc) in _vbyte_encode(gs).items():
        vpreps[scheme], decodes[scheme] = _vbyte_decode(scheme, obj, gs,
                                                        col_ref)
        decodes[scheme]["encode_s"] = enc
        vobjs[scheme] = obj
    hyb_obj = vobjs["hybrid"]
    vpreps["hybrid"]["high_bytes"] = _high_bytes(hyb_obj)
    k11 = _k11_cases(vpreps["streamvbyte"], vpreps["varintgb"],
                     f"rmat{ANALYTICS_SCALE}", timed=True,
                     hyb=vpreps["hybrid"])
    sv = {s: VBYTE_ROUTES[s][0](VB.encode_graph(small, s), device="cuda")
          for s in ("streamvbyte", "varintgb")}
    sh = HYB.encode_graph(small)
    shp = DD.hybrid_device_prep(sh, device="cuda")
    shp["high_bytes"] = _high_bytes(sh)
    _k11_cases(sv["streamvbyte"], sv["varintgb"], f"rmat{PULL_DIRTY_SCALE}",
               timed=False, hyb=shp)
    print(f"[compress] every K11 kernel equals its plain version at "
          f"rmat{ANALYTICS_SCALE} and at rmat{PULL_DIRTY_SCALE} behind a "
          f"NaN-dirtied allocator")
    del vpreps, sv, shp, vobjs
    star = _star_decodes()
    # the solvers on the compressed graph
    dec = CD.cgr_decode_device(plain_cg, device="cuda")
    TCM._TC_CACHE.clear()
    n = TCM.triangle_count(dec, device="cuda")
    TCM._TC_CACHE.clear()
    if ANALYTICS_SCALE == 19 and n != TC_RMAT19:
        raise RuntimeError(f"[compress] triangle_count of the decoded graph "
                           f"{n}, not {TC_RMAT19}")
    csr_bytes = gs.row_ptr.nbytes + gs.col_idx.nbytes
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t1 = time.perf_counter()
    ns, stats = TS.triangle_count_streaming(plain_cg, device="cuda")
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t1
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() - base
    if ns != n:
        raise RuntimeError(f"[compress] triangle_count_streaming {ns}, the "
                           f"decoded graph's count {n}")
    if peak >= csr_bytes:
        raise RuntimeError(f"[compress] triangle_count_streaming held {peak} "
                           f"bytes over the baseline, the CSR {csr_bytes}")
    if (launches["tc_count"] != stats["pairs"]
            or launches["cgr_residual"] < stats["blocks"]):
        raise RuntimeError(f"[compress] streaming launches {launches} for "
                           f"{stats}")
    stream_info = {"triangles": ns, "seconds": stream_s, **stats,
                   "tc_count_launches": launches["tc_count"],
                   "cgr_residual_launches": launches["cgr_residual"],
                   "peak_bytes_over_baseline": peak, "csr_bytes": csr_bytes,
                   "stream_bytes": plain_cg.nbytes}
    print(f"[compress] streaming TC {json.dumps(stream_info)}")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t1 = time.perf_counter()
    dist = TS.bfs_streaming(plain_cg, 0, device="cuda")
    torch.cuda.synchronize()
    bfs_s = time.perf_counter() - t1
    blaunch = _counts()["cgr_residual"]
    bfs_peak = torch.cuda.max_memory_allocated() - base
    want = TR.bfs(dg, 0)
    if not torch.equal(dist, want):
        raise RuntimeError(f"[compress] bfs_streaming differs from bfs in "
                           f"{int((dist != want).sum())} vertices")
    print(f"[compress] bfs_streaming from 0 equals bfs: depth "
          f"{int(dist.max())}, {blaunch} cgr_residual launches, "
          f"{bfs_s:.4f} s, peak {bfs_peak} bytes over the baseline (the CSR "
          f"{csr_bytes})")
    phase_compress_cli()
    print(f"[compress] phase took {time.perf_counter() - t0:.2f} s")
    launches = {}
    for info in decodes.values():
        for name, c in info["launches"].items():
            launches[name] = launches.get(name, 0) + c
    return {"cases": {**cases, **k11}, "launches": launches,
            "decodes": decodes, "streaming": stream_info, "star": star}


# ---- the sharded phase -----------------------------------------------------

def _sharded_cfgs() -> dict:
    """The main path's GCN and GAT at full width (2 layers, 128/128/16)."""
    return {
        "gcn": make_config("gcn", 2, FEAT, HIDDEN, CLASSES, lr=0.01),
        "gat": make_config("gat", GAT_LAYERS, FEAT, HIDDEN, CLASSES, lr=0.01,
                           use_l2norm=False, use_dense=False)}


def _sharded_setup(g, cfg, n: int, device):
    """This rank's trainer over ``n`` shards of ``g``, with fresh weights
    and optimizer."""
    ds = _dataset(g, cfg.dim_init, cfg.num_cls)
    gp = prepare_graph(g, cfg.arch)
    sg = PAR.build_sharded_graph(gp, aggregation_weights(gp, cfg.arch), n)
    trainer = PAR.make_sharded_trainer(cfg, sg, ds.feats, ds.labels,
                                       ds.train_range, ds.train_mask,
                                       device=device)
    params = init_params(cfg, device=device)
    opt = OPTIMIZERS[cfg.optimizer](params.parameters(), lr=cfg.lr)
    return sg, trainer, params, opt


def _mark() -> int:
    """Device memory allocated now, with the peak reset to it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _peak_gib(base: int) -> float:
    """The peak since ``_mark`` returned ``base``, over it, in GiB."""
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def _params_by_name(params) -> dict:
    return {k: p.detach().cpu().numpy().copy()
            for k, p in params.named_parameters()}


def _grads_by_name(params) -> dict:
    return {k: p.grad.detach().cpu().numpy().copy()
            for k, p in params.named_parameters()}


def _sharded_steps(trainer, params, opt, steps: int, first_grads=None):
    """``steps`` steps with every count set to 0 just before them:
    (losses, launches, host ms of each step). A dict ``first_grads``
    receives the first step's gradients (summed over the ranks) by
    name."""
    torch.cuda.synchronize()
    _zero_counts()
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(params, opt)))
        ms.append((time.perf_counter() - t0) * 1e3)
        if first_grads is not None and len(losses) == 1:
            first_grads.update(_grads_by_name(params))
    return losses, _counts(), ms


def _sharded_rank(rank: int, n: int, row_ptr, col_idx, steps: int) -> dict:
    """One rank of the 2-rank run on one card (gloo): GCN and GAT,
    ``steps`` steps each, then ``steps`` from fresh weights, on rank 0
    each followed by ``Model`` (``_follow``); what the parent holds
    against ``Model``."""
    from graphaibench_tpu_torch import CSRGraph
    from graphaibench_tpu_torch.parallel.multihost import rank_device

    g = CSRGraph(row_ptr=row_ptr, col_idx=col_idx)
    dev = rank_device(rank, "cuda")
    out = {}
    for arch, cfg in _sharded_cfgs().items():
        sg, trainer, params, opt = _sharded_setup(g, cfg, n, dev)
        losses, launches, _ = _sharded_steps(trainer, params, opt, steps)
        trainer.halo_probe()
        out[arch] = {"losses": losses, "launches": launches,
                     "params": _params_by_name(params),
                     "halo_counts": sg.halo_counts.tolist(),
                     "h_max": sg.h_max, "nv_pad": sg.nv_pad,
                     "transport": trainer.transport,
                     "halo_probe_s": trainer.halo_probe()}
        model = (Model(cfg, _dataset(g, cfg.dim_init, cfg.num_cls),
                       device=dev) if rank == 0 else None)
        params = init_params(cfg, device=dev)
        opt = OPTIMIZERS[cfg.optimizer](params.parameters(), lr=cfg.lr)
        out[arch]["follow"] = _follow(
            lambda trainer=trainer, params=params, opt=opt:
            trainer.train_step(params, opt), params, opt, model, steps)
    return out


def _follow(step, params, opt, model, steps: int) -> dict | None:
    """``steps`` calls of ``step`` (one step of a trainer on ``params`` and
    ``opt``), each followed by one ``model.train_epoch`` from the same
    state: ``model`` takes the weights and the optimizer's state just
    before the trainer steps. Returns the largest |weight difference| and
    |gradient difference| over the steps, and the gradients (by name, with
    the step) that leave the limits TP_GRAD_RTOL and TP_GRAD_ATOL; None
    where ``model`` is None (the trainer only steps)."""
    mine = list(params.named_parameters())
    theirs = list(model.params.named_parameters()) if model else []
    if model and [k for k, _ in mine] != [k for k, _ in theirs]:
        raise RuntimeError(f"parameters {[k for k, _ in mine]}, Model's "
                           f"{[k for k, _ in theirs]}")
    weights = grads = 0.0
    outside = []
    for i in range(steps):
        if model:
            with torch.no_grad():
                for (_, p), (_, q) in zip(mine, theirs):
                    q.copy_(p)
            model.opt.load_state_dict(opt.state_dict())
        step()
        if not model:
            continue
        model.train_epoch()
        for (k, p), (_, q) in zip(mine, theirs):
            weights = max(weights, float((p - q).detach().abs().max()))
            grads = max(grads, float((p.grad - q.grad).abs().max()))
            if not torch.allclose(p.grad, q.grad, rtol=TP_GRAD_RTOL,
                                  atol=TP_GRAD_ATOL):
                outside.append(f"{k} (step {i + 1})")
    return ({"weights": weights, "grads": grads, "grads_outside": outside}
            if model else None)


def _hold_follow(tag: str, follow: dict) -> None:
    """``_follow``'s gradients within TP_GRAD_RTOL and TP_GRAD_ATOL and its
    weights within SHARDED_FOLLOW_ATOL."""
    if follow["grads_outside"] or follow["weights"] > SHARDED_FOLLOW_ATOL:
        raise RuntimeError(
            f"{tag} Model from the trainer's state: gradients outside rtol "
            f"{TP_GRAD_RTOL} atol {TP_GRAD_ATOL}: {follow['grads_outside']} "
            f"(max |diff| {follow['grads']}); weights max |diff| "
            f"{follow['weights']} (limit {SHARDED_FOLLOW_ATOL})")


def _weights_err(params: dict, want: dict) -> float:
    return max(float(np.abs(params[k] - w).max()) for k, w in want.items())


def _hold_to_model(tag: str, arch: str, losses, params: dict, want_losses,
                   want_params: dict) -> float:
    """Losses within rtol SHARDED_RTOL and weights within atol
    SHARDED_ATOL of Model's; returns the weights' max |diff|."""
    np.testing.assert_allclose(losses, want_losses, rtol=SHARDED_RTOL,
                               err_msg=f"{tag} losses")
    for k, want in want_params.items():
        np.testing.assert_allclose(params[k], want, rtol=0,
                                   atol=SHARDED_ATOL[arch],
                                   err_msg=f"{tag} {k}")
    return _weights_err(params, want_params)


def _sharded_one_rank(g, models: dict) -> dict:
    """(a): the trainer in this process as the one rank of an nccl group;
    GCN and GAT: losses held to ``Model``'s, then ``Model`` following the
    trainer step by step (``_follow``), and their launches per step to
    ``Model``'s; device time per step under the profiler, beside Model's,
    and the peak memory."""
    res = {}
    PAR.initialize(0, 1, port=PAR.multihost.free_port(), backend="nccl",
                   device=torch.device("cuda", 0))
    try:
        for arch, cfg in _sharded_cfgs().items():
            tag = f"[sharded {arch} P=1]"
            ref = models[arch]
            base = _mark()
            sg, trainer, params, opt = _sharded_setup(g, cfg, 1, "cuda")
            setup_peak = _peak_gib(base)
            base = _mark()
            losses, launches, ms = _sharded_steps(trainer, params, opt,
                                                  SHARDED_STEPS)
            step_peak = _peak_gib(base)
            want = {k: v * SHARDED_STEPS for k, v in
                    SHARDED_STEP_LAUNCHES[arch].items()}
            _assert_counts(tag, launches, want)
            np.testing.assert_allclose(losses, ref["losses"],
                                       rtol=SHARDED_RTOL,
                                       err_msg=f"{tag} losses")
            err = _weights_err(_params_by_name(params), ref["params"])
            step_ms = statistics.median(ms[1:])
            fresh = init_params(cfg, device="cuda")
            fresh_opt = OPTIMIZERS[cfg.optimizer](fresh.parameters(),
                                                  lr=cfg.lr)
            follow = _follow(
                lambda: trainer.train_step(fresh, fresh_opt), fresh,
                fresh_opt, ref["model"], SHARDED_STEPS)
            _hold_follow(tag, follow)

            def steps(k, trainer=trainer, params=params, opt=opt):
                for _ in range(k):
                    trainer.train_step(params, opt)

            device_ms, _ = phase_profile(f"sharded {arch} P=1", steps,
                                         SHARDED_STEPS, step_ms, unit="step")
            model = ref["model"]
            model_ms, _ = phase_profile(
                f"model {arch}", lambda k, m=model: [m.train_epoch()
                                                     for _ in range(k)],
                SHARDED_STEPS, ref["step_ms"], unit="step")
            res[arch] = {"losses": losses, "model_losses": ref["losses"],
                         "weights_max_abs_err": err,
                         "model_spread": ref["spread"],
                         "follow_weights_max_abs_err": follow["weights"],
                         "follow_grads_max_abs_err": follow["grads"],
                         "launches_per_step": {k: v // SHARDED_STEPS
                                               for k, v in launches.items()
                                               if v},
                         "step_ms": step_ms, "device_ms": device_ms,
                         "model_step_ms": ref["step_ms"],
                         "model_device_ms": model_ms,
                         "setup_peak_gib": setup_peak,
                         "step_peak_gib": step_peak,
                         "model_setup_peak_gib": ref["setup_peak_gib"],
                         "model_step_peak_gib": ref["step_peak_gib"],
                         "nv_pad": sg.nv_pad, "h_max": sg.h_max,
                         "transport": trainer.transport}
            print(f"{tag} {json.dumps(res[arch])}")
    finally:
        PAR.multihost.dist.destroy_process_group()
    return res


def _sharded_two_ranks(g, models: dict) -> dict:
    """(b): 2 ranks spawned on the one card over gloo (the exchange
    host-staged): losses held to ``Model``'s after SHARDED_STEPS_TWO
    steps, and rank 0 followed by ``Model`` step by step."""
    t0 = time.perf_counter()
    ranks = PAR.launch(_sharded_rank, 2, g.row_ptr, g.col_idx,
                       SHARDED_STEPS_TWO, device="cuda", backend="gloo",
                       timeout_s=SHARDED_SPAWN_TIMEOUT_S)
    res = {}
    for arch in _sharded_cfgs():
        tag = f"[sharded {arch} P=2 gloo]"
        ref = models[arch]
        r0, r1 = ranks[0][arch], ranks[1][arch]
        if r0["losses"] != r1["losses"] or any(
                not np.array_equal(v, r1["params"][k])
                for k, v in r0["params"].items()):
            raise RuntimeError(f"{tag} the ranks' losses or weights differ")
        if r0["transport"] != "host-staged":
            raise RuntimeError(f"{tag} transport {r0['transport']}")
        if min(r0["halo_counts"]) == 0:
            raise RuntimeError(f"{tag} no halo: the run checks nothing")
        np.testing.assert_allclose(r0["losses"],
                                   ref["losses"][:SHARDED_STEPS_TWO],
                                   rtol=SHARDED_RTOL, err_msg=f"{tag} losses")
        err = _weights_err(r0["params"], ref["params_two"])
        _hold_follow(tag, r0["follow"])
        per_step = [{k: v // SHARDED_STEPS_TWO for k, v in r["launches"].items()
                     if v} for r in (r0, r1)]
        for r, counts in enumerate(per_step):
            want = SHARDED_TWO_RANK_LAUNCHES[arch]
            if counts != want:
                raise RuntimeError(f"{tag} rank {r} launches per step "
                                   f"{counts}, expected {want}")
        res[arch] = {"losses": r0["losses"], "weights_max_abs_err": err,
                     "model_spread": ref["spread_two"],
                     "follow_weights_max_abs_err": r0["follow"]["weights"],
                     "follow_grads_max_abs_err": r0["follow"]["grads"],
                     "halo_counts": r0["halo_counts"], "h_max": r0["h_max"],
                     "nv_pad": r0["nv_pad"],
                     "launches_per_step": per_step,
                     "halo_probe_s": [r0["halo_probe_s"], r1["halo_probe_s"]],
                     "transport": r0["transport"]}
        print(f"{tag} {json.dumps(res[arch])}")
    print(f"[sharded] 2 ranks on one card in "
          f"{time.perf_counter() - t0:.2f} s")
    return res


def _rect_compare(got, want, what: str, gat: bool) -> float:
    if gat:
        return _gat_close(got, want, what)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
        raise RuntimeError(f"{what}: kernel disagrees with plain, max |diff| "
                           f"{err}")
    return err


def _sharded_rect_kernels(label: str, g, widths, shards: int = 2) -> dict:
    """(c): each rank's rectangular tables of ``g`` (self-loops added, as
    GCN and GAT prepare it) at P = ``shards``: K1 on the own, halo and
    unified tables and their transposes, the five GAT passes on the
    unified table and its transpose, at each feature width of ``widths``,
    each against its plain version behind a NaN-dirtied allocator.
    Returns {kernel: max |diff|}."""
    gp = prepare_graph(g, "gat")
    sg = PAR.build_sharded_graph(gp, np.ones(gp.ne, np.float32), shards)
    gen = torch.Generator(device="cuda").manual_seed(3)
    errs = {"ell_spmm": 0.0, **{k: 0.0 for k in GAT_KERNELS}}
    tiles = {}

    def run(fn, *args, out_floats):
        _dirty(out_floats)
        return fn(*args)

    splits = {}
    for rank in range(shards):
        for part in ("own", "halo", "all"):
            se = SE.build_shard_ell(sg.shard(rank), part=part, device="cuda")
            w = torch.rand(sg.e_max, device="cuda", generator=gen)
            wp = SE.pack_shard_values(se, w)
            splits[f"{rank}/{part}"] = (int(se.fwd.is_split.sum()),
                                        int(se.trans.is_split.sum()))
            for f in widths:
                tiles[f"{rank}/{part} F={f}"] = [
                    K1._tile_floats(t.n_cols, f) for t in (se.fwd, se.trans)]
                for tab, view in ((se.fwd, wp.fwd), (se.trans, wp.t)):
                    x = torch.randn(tab.n_cols, f, device="cuda",
                                    generator=gen)
                    got = run(K1.ell_spmm, tab, view, x,
                              out_floats=tab.nv * f)
                    errs["ell_spmm"] = max(errs["ell_spmm"], _rect_compare(
                        got, K1.ell_spmm_plain(tab, view, x),
                        f"ell_spmm {label} rank {rank} {part} F={f}", False))
            if part != "all":
                continue
            fwd, tr = se.fwd, se.trans
            for f in widths:
                what = f"{label} rank {rank} F={f}"
                sl = torch.randn(fwd.nv, device="cuda", generator=gen)
                sr = torch.randn(fwd.n_cols, device="cuda", generator=gen)
                h = torch.randn(fwd.n_cols, f, device="cuda", generator=gen)
                ct = torch.randn(fwd.nv, f, device="cuda", generator=gen)
                m0_p = FG.gat_rowmax_plain(fwd, sr)
                m0 = run(FG.gat_rowmax, fwd, sr, out_floats=fwd.nv)
                if not torch.equal(m0, m0_p):
                    raise RuntimeError(f"gat_rowmax {what} differs from plain")
                m = FG._leaky(sl + torch.where(torch.isfinite(m0_p), m0_p,
                                               torch.zeros_like(m0_p)))
                acc_p, z_p = FG.gat_v2_fwd_plain(fwd, sl, sr, m, h)
                acc, z = run(FG.gat_v2_fwd, fwd, sl, sr, m, h,
                             out_floats=fwd.nv * f)
                zinv = 1.0 / torch.clamp(z_p, min=FG.Z_FLOOR)
                inner = (ct * acc_p * zinv[:, None]).sum(1)
                bwd = (sl, sr, m, zinv, inner, h, ct)
                d_sl = run(FG.gat_v2_bwd_sl, fwd, *bwd, out_floats=fwd.nv)
                d_h, d_sr = run(FG.gat_v2_bwd_h, tr, *bwd,
                                out_floats=tr.nv * f)
                one = run(FG.gat_v2_bwd, tr, *bwd, out_floats=tr.nv * f)
                one_p = FG.gat_v2_bwd_plain(tr, *bwd)
                d_h_p, d_sr_p = FG.gat_v2_bwd_h_plain(tr, *bwd)
                d_sl_p = FG.gat_v2_bwd_sl_plain(fwd, *bwd)
                # the single pass's d_sl by neighbour equals bwd_sl's by row
                _gat_close(one_p[0], d_sl_p, f"plain d_sl {what}")
                for name, e in (
                        ("gat_v2_fwd", max(
                            _rect_compare(acc, acc_p, f"acc {what}", True),
                            _rect_compare(z, z_p, f"z {what}", True))),
                        ("gat_v2_bwd_sl", _rect_compare(
                            d_sl, d_sl_p, f"d_sl {what}", True)),
                        ("gat_v2_bwd_h", max(
                            _rect_compare(d_h, d_h_p, f"d_h {what}", True),
                            _rect_compare(d_sr, d_sr_p, f"d_sr {what}",
                                          True))),
                        ("gat_v2_bwd", max(
                            _rect_compare(a, b, f"single pass {what}", True)
                            for a, b in zip(one, one_p)))):
                    errs[name] = max(errs[name], e)
    print(f"[sharded] rank tables of {label} P={shards} (nv_pad {sg.nv_pad}, "
          f"h_max {sg.h_max}, halo {sg.halo_counts.tolist()}; split rows "
          f"fwd/transpose by rank/part {splits}; K1's column tile "
          f"fwd/transpose {tiles}), F in {widths}, dirtied allocator: "
          f"max_abs_err {json.dumps(errs)}")
    return errs


def phase_sharded(g) -> dict:
    """The sharded trainer: (a) one rank (nccl) and (b) two ranks on the
    one card (gloo) against Model, (c) the kernels on rectangular tables.
    Returns what the kernels line reports of it."""
    t0 = time.perf_counter()
    models = {}
    for arch, cfg in _sharded_cfgs().items():
        runs = []
        for _ in range(2):   # the second run: Model's own run-to-run spread
            # peaks as the sharded trainer's: set-up (the host dataset
            # made first), then the steps, each over what was allocated
            # just before it
            ds = _dataset(g, cfg.dim_init, cfg.num_cls)
            base = _mark()
            model = Model(cfg, ds, device="cuda")
            setup_peak = _peak_gib(base)
            base = _mark()
            losses, ms, two = [], [], None
            for step in range(SHARDED_STEPS):
                t1 = time.perf_counter()
                losses.append(model.train_epoch()[0])
                ms.append((time.perf_counter() - t1) * 1e3)
                if step + 1 == SHARDED_STEPS_TWO:
                    two = _params_by_name(model.params)
            runs.append({"model": model, "losses": losses,
                         "params": _params_by_name(model.params),
                         "params_two": two,
                         "step_ms": statistics.median(ms[1:]),
                         "setup_peak_gib": setup_peak,
                         "step_peak_gib": _peak_gib(base)})
        models[arch] = dict(
            runs[0], spread=_weights_err(runs[1]["params"], runs[0]["params"]),
            spread_two=_weights_err(runs[1]["params_two"],
                                    runs[0]["params_two"]))
        del runs
    one = _sharded_one_rank(g, models)
    two = _sharded_two_ranks(g, models)
    main_rect = _sharded_rect_kernels(f"rmat{SCALE}", g,
                                      SHARDED_MAIN_RECT_WIDTHS)
    small = _sharded_rect_kernels(
        f"rmat{SHARDED_RECT_SCALE}",
        rmat(SHARDED_RECT_SCALE, EDGE_FACTOR, seed=1), SHARDED_RECT_WIDTHS)
    rect = {k: max(v, small[k]) for k, v in main_rect.items()}
    print(f"[sharded] phase took {time.perf_counter() - t0:.2f} s")
    return {"one_rank": one, "two_ranks": two, "rect_err": rect}


# ---- the tp_dp phase ------------------------------------------------------

def _tp_cfgs() -> dict:
    """The main path's GCN, and GAT with its l2norm and dense head (the
    tensor-parallel GAT needs the head), at full width."""
    return {"gcn": make_config("gcn", 2, FEAT, HIDDEN, CLASSES, lr=0.01),
            "gat": make_config("gat", GAT_LAYERS, FEAT, HIDDEN, CLASSES,
                               lr=0.01)}


def _tp_setup(g, cfg, shards: int):
    """(cfg, sharded graph, dataset) for ``shards`` vertex blocks."""
    ds = _dataset(g, cfg.dim_init, cfg.num_cls)
    gp = prepare_graph(g, cfg.arch)
    return PAR.build_sharded_graph(gp, aggregation_weights(gp, cfg.arch),
                                   shards), ds


def _tp_rank(rank: int, n: int, row_ptr, col_idx, shards: int, archs,
             steps: int, prefix) -> dict:
    """One rank of a (shards x n // shards) tensor-parallel run on one card
    (gloo): ``steps`` steps of each arch, then its device time a step
    under the profiler; with ``prefix``, the GCN trainer rebuilt from
    that prefix's shard files and its first loss."""
    from graphaibench_tpu_torch import CSRGraph
    from graphaibench_tpu_torch.parallel.multihost import rank_device
    from graphaibench_tpu_torch.parallel.shard_io import (
        make_sharded_trainer_from_files,
    )

    g = CSRGraph(row_ptr=row_ptr, col_idx=col_idx)
    dev = rank_device(rank, "cuda")
    m = n // shards
    out = {}
    for arch in archs:
        cfg = _tp_cfgs()[arch]
        sg, ds = _tp_setup(g, cfg, shards)
        trainer = PAR.make_tp_trainer(cfg, sg, ds.feats, ds.labels,
                                      ds.train_range, ds.train_mask,
                                      model_parallelism=m, device=dev)
        params = init_params(cfg, device=dev)
        opt = OPTIMIZERS[cfg.optimizer](params.parameters(), lr=cfg.lr)
        grads = {}
        losses, launches, ms = _sharded_steps(trainer, params, opt, steps,
                                              first_grads=grads)
        trainer.halo_probe()   # a warm-up; the second is read
        res = {"losses": losses, "launches": launches, "grads": grads,
               "params": _params_by_name(params),
               "transport": trainer.transport, "nv_pad": sg.nv_pad,
               "halo_counts": sg.halo_counts.tolist(),
               "step_ms": statistics.median(ms[1:]),
               "halo_probe_s": trainer.halo_probe()}

        def run(k, trainer=trainer, params=params, opt=opt):
            for _ in range(k):
                trainer.train_step(params, opt)

        res["device_ms"], _ = phase_profile(
            f"tp {arch} ({shards}x{m}) rank {rank}", run, steps,
            res["step_ms"], unit="step")
        if prefix is not None and arch == "gcn":
            t_file, _ = make_sharded_trainer_from_files(
                prefix, model_parallelism=m, device=dev)
            fresh = init_params(cfg, device=dev)
            res["file_first_loss"] = float(t_file.train_step(
                fresh, OPTIMIZERS[cfg.optimizer](fresh.parameters(),
                                                 lr=cfg.lr)))
        out[arch] = res
        del trainer, params, opt
        torch.cuda.empty_cache()
    return out


def _tp_want_launches(arch: str, nv_pad: int, shards: int) -> dict:
    """A tensor-parallel step's launches on one rank: GCN's K1 3 (two
    forward aggregations, at F / M and at the classes' width, and the
    adjoint of the second), twice over with a halo (the own and the halo
    table); GAT's row max and forward a layer, and per layer the backward
    as one pass or two by ``FG._single_pass`` at the column block's
    width."""
    if arch == "gcn":
        return {"ell_spmm": SPMMS_PER_STEP * (2 if shards > 1 else 1)}
    want = {"gat_rowmax": GAT_LAYERS, "gat_v2_fwd": GAT_LAYERS}
    for _ in range(GAT_LAYERS):
        names = (("gat_v2_bwd",) if FG._single_pass(nv_pad, HIDDEN // TP_M)
                 else ("gat_v2_bwd_sl", "gat_v2_bwd_h"))
        for k in names:
            want[k] = want.get(k, 0) + 1
    return want


def _tp_models(g) -> dict:
    """Model on the card for each TP arch: losses, the first step's
    gradients, the weights after TP_HALO_STEPS and TP_STEPS steps, the
    host ms and the device ms of a step."""
    out = {}
    for arch, cfg in _tp_cfgs().items():
        model = Model(cfg, _dataset(g, cfg.dim_init, cfg.num_cls),
                      device="cuda")
        losses, ms, params = [], [], {}
        for step in range(TP_STEPS):
            t0 = time.perf_counter()
            losses.append(model.train_epoch()[0])
            ms.append((time.perf_counter() - t0) * 1e3)
            params[step + 1] = _params_by_name(model.params)
            if step == 0:
                grads = _grads_by_name(model.params)
        step_ms = statistics.median(ms[1:])
        device_ms, _ = phase_profile(
            f"tp model {arch}", lambda k, m=model: [m.train_epoch()
                                                     for _ in range(k)],
            TP_STEPS, step_ms, unit="step")
        out[arch] = {"losses": losses, "grads": grads, "params": params,
                     "step_ms": step_ms,
                     "device_ms": device_ms}
        del model
        torch.cuda.empty_cache()
    return out


def _tp_hold(tag: str, arch: str, ranks: list, ref: dict, steps: int,
             shards: int, transport: str = "host-staged") -> dict:
    """The ranks equal to each other, their collectives on ``transport``,
    the first step's summed gradients held to Model's leaf by leaf (what
    Adam would hide: a constant factor), the losses and weights held to
    Model after ``steps`` steps, each with the launches a step the design
    implies."""
    r0 = ranks[0][arch]
    for r, res in enumerate(ranks[1:], 1):
        if res[arch]["losses"] != r0["losses"] or any(
                not np.array_equal(v, res[arch][what][k])
                for what in ("params", "grads")
                for k, v in r0[what].items()):
            raise RuntimeError(f"{tag} rank {r}'s losses, gradients or "
                               "weights differ from rank 0's")
    if set(r0["grads"]) != set(ref["grads"]):
        raise RuntimeError(f"{tag} gradient leaves {sorted(r0['grads'])}, "
                           f"Model's {sorted(ref['grads'])}")
    grad_err = 0.0
    for k, want in ref["grads"].items():
        np.testing.assert_allclose(r0["grads"][k], want, rtol=TP_GRAD_RTOL,
                                   atol=TP_GRAD_ATOL,
                                   err_msg=f"{tag} gradient {k}")
        grad_err = max(grad_err, float(np.abs(r0["grads"][k] - want).max()))
    if r0["transport"] != transport:
        raise RuntimeError(f"{tag} transport {r0['transport']}")
    if shards > 1 and min(r0["halo_counts"]) == 0:
        raise RuntimeError(f"{tag} no halo: the run checks nothing")
    err = _hold_to_model(tag, arch, r0["losses"], r0["params"],
                         ref["losses"][:steps], ref["params"][steps])
    want = _tp_want_launches(arch, r0["nv_pad"], shards)
    per_step = []
    for r, res in enumerate(ranks):
        counts = {k: v // steps for k, v in res[arch]["launches"].items() if v}
        if counts != want or any(v % steps for v in
                                 res[arch]["launches"].values()):
            raise RuntimeError(f"{tag} rank {r} launches "
                               f"{res[arch]['launches']} in {steps} steps, "
                               f"expected {want} a step")
        per_step.append(counts)
    out = {"losses": r0["losses"], "model_losses": ref["losses"][:steps],
           "weights_max_abs_err": err, "grad_max_abs_err": grad_err,
           "launches_per_step": per_step,
           "transport": r0["transport"], "reduce_scatter":
           PAR.tp.REDUCE_SCATTER, "nv_pad": r0["nv_pad"],
           "halo_counts": r0["halo_counts"],
           "step_ms": [res[arch]["step_ms"] for res in ranks],
           "device_ms": [res[arch]["device_ms"] for res in ranks],
           "model_step_ms": ref["step_ms"],
           "model_device_ms": ref["device_ms"],
           "halo_probe_s": [res[arch]["halo_probe_s"] for res in ranks]}
    print(f"{tag} {json.dumps(out)}")
    return out


def _dp_cfg():
    """The sampled main path's GCN (l2norm and dense head, as sampling
    configures it)."""
    return make_config("gcn", 2, FEAT, HIDDEN, CLASSES, subg_size=SUBG_SIZE,
                       lr=0.01)


def _grads_np(model) -> list:
    return [p.grad.detach().cpu().numpy().copy()
            for p in model.params.parameters()]


@contextlib.contextmanager
def _deterministic():
    """PyTorch's deterministic kernels inside. The sampled step's COO
    aggregation is an ``index_add_`` whose atomics sum in no fixed order;
    if that rounding moves an activation across ReLU's zero, a gradient
    element moves by far more than rounding (the likely cause of one
    element 1.4e-6 off, against atol 1e-6, on the H100). Part (d) holds
    the averaging of the ranks' gradients, so both of its sides run
    without atomics."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _dp_rank(rank: int, n: int, row_ptr, col_idx) -> dict:
    """One data-parallel GraphSAINT rank on the card (gloo): the first
    step's averaged gradients (deterministic kernels), then DP_STEPS - 1
    more steps on the usual ones, with the sampler's wait and the step's
    seconds."""
    from graphaibench_tpu_torch import CSRGraph
    from graphaibench_tpu_torch.parallel.multihost import rank_device

    g = CSRGraph(row_ptr=row_ptr, col_idx=col_idx)
    cfg = _dp_cfg()
    timers = OpTimers()
    model = Model(cfg, _dataset(g, cfg.dim_init, cfg.num_cls),
                  device=rank_device(rank, "cuda"), inductive=True,
                  timers=timers)
    with _deterministic():
        log = PAR.train_sampled_dp(model, 1, SUBG_SIZE, verbose=False)
        grads = _grads_np(model)
    log += PAR.train_sampled_dp(model, DP_STEPS - 1, SUBG_SIZE, seed=n,
                                verbose=False)
    return {"grads": grads, "log": log,
            "params": _params_by_name(model.params),
            "sample_s": timers.times[OP_SAMPLE] / DP_STEPS,
            "step_s": timers.times[OP_STEP] / DP_STEPS}


def _tp_dp_dp(g, n: int = DP_RANKS, backend: str | None = "gloo") -> dict:
    """(d): ``n`` DP ranks (two on the one card, gloo), the first step's
    gradients held to the serial mean of the n subgraphs' gradients
    computed here."""
    t0 = time.perf_counter()
    ranks = PAR.launch(_dp_rank, n, g.row_ptr, g.col_idx, device="cuda",
                       backend=backend, timeout_s=SHARDED_SPAWN_TIMEOUT_S)
    tag = f"[tp_dp dp {n} ranks]"
    r0 = ranks[0]
    for r, res in enumerate(ranks[1:], 1):
        if ([l[:2] for l in res["log"]] != [l[:2] for l in r0["log"]]
                or any(not np.array_equal(v, res["params"][k])
                       for k, v in r0["params"].items())):
            raise RuntimeError(f"{tag} rank {r} differs from rank 0")
    cfg = _dp_cfg()
    model = Model(cfg, _dataset(g, cfg.dim_init, cfg.num_cls), device="cuda",
                  inductive=True)
    prepare, e_pad = model._subgraph_source(SUBG_SIZE)
    grads = []
    with _deterministic():
        for r in range(n):   # the seeds of step 0: 0 + r
            model._sampled_backward(prepare(r, e_pad))
            grads.append(_grads_np(model))
    err = 0.0
    for l, (got, *parts) in enumerate(zip(r0["grads"], *grads)):
        want = sum(parts[1:], parts[0]) / n
        np.testing.assert_allclose(got, want, rtol=TP_GRAD_RTOL,
                                   atol=TP_GRAD_ATOL,
                                   err_msg=f"{tag} gradient leaf {l}")
        err = max(err, float(np.abs(got - want).max()))
    losses = [l for l, _, _ in r0["log"]]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"{tag} losses {losses}")
    out = {"losses": losses, "grad_max_abs_err": err,
           "step_s": [l[2] for l in r0["log"]],
           "sample_wait_s": [r["sample_s"] for r in ranks],
           "device_step_s": [r["step_s"] for r in ranks],
           "seconds": time.perf_counter() - t0}
    print(f"{tag} {json.dumps(out)}")
    return out


def phase_tp_dp(g) -> dict:
    """The tensor-parallel trainer, data-parallel GraphSAINT and the shard
    files on the card: (a) (1 x 2) GCN and GAT, (b) (2 x 2) GCN, each held
    to Model; (c) the rank tables' kernels at the column blocks' widths;
    (d) two DP ranks; (e) the (1 x 2) GCN trainer from shard files.
    Returns what the kernels line reports of it."""
    from graphaibench_tpu_torch.parallel.shard_io import write_trainer_shards

    t0 = time.perf_counter()
    models = _tp_models(g)
    cfg = _tp_cfgs()["gcn"]
    sg, ds = _tp_setup(g, cfg, 1)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "tp")
        write_trainer_shards(prefix, cfg, sg, ds.feats, ds.labels,
                             ds.train_range, ds.train_mask)
        del sg, ds
        ranks = PAR.launch(_tp_rank, TP_M, g.row_ptr, g.col_idx, 1,
                           ("gcn", "gat"), TP_STEPS, prefix, device="cuda",
                           backend="gloo", timeout_s=SHARDED_SPAWN_TIMEOUT_S)
    one = {arch: _tp_hold(f"[tp_dp {arch} (1x{TP_M})]", arch, ranks,
                          models[arch], TP_STEPS, 1)
           for arch in ("gcn", "gat")}
    # (e): the file-built trainer's first loss
    mem = ranks[0]["gcn"]["losses"][0]
    for r, res in enumerate(ranks):
        got = res["gcn"]["file_first_loss"]
        if abs(got - mem) > TP_FILE_RTOL * abs(mem):
            raise RuntimeError(f"[tp_dp files] rank {r}: first loss {got} "
                               f"from the files, {mem} in memory")
    print(f"[tp_dp files] (1x{TP_M}) GCN rebuilt from shard files: first "
          f"loss {ranks[0]['gcn']['file_first_loss']!r} against "
          f"{mem!r} in memory, |diff| "
          f"{max(abs(r['gcn']['file_first_loss'] - mem) for r in ranks)}")
    t1 = time.perf_counter()
    ranks = PAR.launch(_tp_rank, 2 * TP_M, g.row_ptr, g.col_idx, 2,
                       ("gcn",), TP_HALO_STEPS, None, device="cuda",
                       backend="gloo", timeout_s=SHARDED_SPAWN_TIMEOUT_S)
    halo = _tp_hold(f"[tp_dp gcn (2x{TP_M})]", "gcn", ranks, models["gcn"],
                    TP_HALO_STEPS, 2)
    print(f"[tp_dp] (2x{TP_M}): {2 * TP_M} ranks on one card in "
          f"{time.perf_counter() - t1:.2f} s")
    del ranks, models
    rect = _sharded_rect_kernels(f"rmat{SCALE}", g, TP_KERNEL_WIDTHS, 1)
    rect2 = _sharded_rect_kernels(f"rmat{SCALE}", g, TP_KERNEL_WIDTHS, 2)
    rect = {k: max(v, rect2[k]) for k, v in rect.items()}
    dp = _tp_dp_dp(g)
    print(f"[tp_dp] phase took {time.perf_counter() - t0:.2f} s")
    return {"one": one, "halo": halo, "rect_err": rect, "dp": dp}


# ---- the dist_analytics phase ---------------------------------------------

def _dist_solves(g, w, device) -> dict:
    """The distributed solvers on this rank of the current group, each
    twice (a checked solve, then a warm one), every count set to 0 just
    before each: set-up seconds of the three rank graphs (the pull
    graph, the weighted one and PageRank's), then per solver its result
    (gathered in vertex order; the count for the triangle counts), its
    sweep or level count, its launches by kernel (both solves equal),
    the seconds of each solve and the warm solve's seconds per pull; the
    peak memory over the set-up and the solves, over what was allocated
    before."""
    from graphaibench_tpu_torch.parallel import dist_analytics as DA

    torch.cuda.set_device(device)
    base = _mark()
    setup = {}
    t0 = time.perf_counter()
    pull = DA.pull_graph(g, device=device)
    setup["pull"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    wpull = DA.pull_graph(g, w, device=device)
    setup["pull_weighted"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prg = DA.pagerank_graph(g, device=device)
    setup["pagerank"] = time.perf_counter() - t0
    runs = {
        "bfs": lambda: DA.distributed_bfs(pull, 0),
        "sssp": lambda: DA.distributed_sssp(wpull, None, 0),
        "cc": lambda: DA.distributed_cc(pull),
        "kcore": lambda: DA.distributed_kcore(pull),
        "bc": lambda: (DA.distributed_bc(pull, [DIST_BC_SOURCE]), None),
        "pagerank": lambda: DA.distributed_pagerank(prg),
        "tc": lambda: (DA.distributed_triangle_count(g, device=device), None),
        "tc_2d": lambda: (DA.distributed_triangle_count_2d(g, device=device),
                          None),
    }
    solves = {}
    for name, fn in runs.items():
        rec = {}
        for turn in ("first", "warm"):
            torch.cuda.synchronize(device)
            _zero_counts()
            t0 = time.perf_counter()
            x, count = fn()
            torch.cuda.synchronize(device)
            rec[f"s_{turn}"] = time.perf_counter() - t0
            launches = {k: v for k, v in _counts().items() if v}
            if turn == "first":
                rec.update(count=count, launches=launches)
                result = x
            elif launches != rec["launches"]:
                raise RuntimeError(f"[dist_analytics] {name}: launches "
                                   f"{launches}, the first solve's "
                                   f"{rec['launches']}")
        pulls = (rec["launches"].get("neighbor_reduce", 0)
                 or (count if name == "pagerank" else 0))
        rec["s_per_pull"] = rec["s_warm"] / pulls if pulls else None
        rec["result"] = (result if name.startswith("tc") else
                         DA.gather_own(result, g.nv).cpu().numpy())
        solves[name] = rec
    return {"setup_s": setup, "solves": solves, "peak_gib": _peak_gib(base),
            "nv_pad": pull.nv_pad,
            "halo_rows": int(pull.tables["all"].fwd.n_cols - pull.nv_pad)}


def _dist_rank(rank: int, n: int, row_ptr, col_idx, w) -> dict:
    """One of the ranks spawned on the one card: the solvers (rank 0 keeps
    the gathered results, the others only their counts and times) and
    the transport of its collectives."""
    from graphaibench_tpu_torch import CSRGraph
    from graphaibench_tpu_torch.parallel.multihost import rank_device, transport

    dev = rank_device(rank, "cuda")
    res = _dist_solves(CSRGraph(row_ptr=row_ptr, col_idx=col_idx), w, dev)
    res["transport"] = transport(None, dev)
    if rank:
        for rec in res["solves"].values():
            rec["result"] = None
    return res


def _dist_refs(g, dg, w) -> dict:
    """The single-device solvers' answers on the card, in the distributed
    solvers' form (BFS's unreached 2**30, not -1)."""
    t0 = time.perf_counter()
    bfs = TR.bfs(dg, 0).cpu().numpy()
    scores, iters = PRM.pagerank(dg)
    refs = {
        "bfs": np.where(bfs < 0, DIST_INF, bfs),
        "sssp": TR.sssp_bellman_ford(dg, torch.from_numpy(w).cuda(),
                                     0).cpu().numpy(),
        "cc": CCM.connected_components(dg).cpu().numpy(),
        "kcore": KCM.k_core_hindex(g, device="cuda").cpu().numpy(),
        "bc": BCM.bc_single_source(dg, DIST_BC_SOURCE).cpu().numpy(),
        "pagerank": scores.cpu().numpy(), "pagerank_iterations": iters,
        "tc": TCM.triangle_count(g, device="cuda")}
    refs["tc_2d"] = refs["tc"]
    print(f"[dist_analytics] single-device answers on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    return refs


def _dist_hold(tag: str, solves: dict, want: dict) -> dict:
    """Each solver's result against ``want`` (a dict of results): exact
    for BFS, CC, k-core and the counts, SSSP within rtol 1e-5, PageRank
    within rtol 1e-4, atol 1e-7, BC within BC_RTOL, BC_ATOL; returns the
    max |diff| of the float results."""
    errs = {}
    for name, rec in solves.items():
        got, ref = rec["result"], want[name]
        if name in ("bfs", "cc", "kcore", "tc", "tc_2d"):
            if not np.array_equal(got, ref):
                raise RuntimeError(f"{tag} {name} differs from the reference"
                                   f" ({got if np.ndim(got) == 0 else ''})")
            continue
        fin = np.isfinite(ref)
        if not np.array_equal(fin, np.isfinite(got)):
            raise RuntimeError(f"{tag} {name}: other vertices reached")
        errs[name] = float(np.abs(got[fin] - ref[fin]).max())
        tol = {"sssp": dict(rtol=SSSP_RTOL, atol=0.0),
               "pagerank": dict(rtol=DIST_PR_RTOL, atol=DIST_PR_ATOL),
               "bc": dict(rtol=BC_RTOL, atol=BC_ATOL)}[name]
        if not np.allclose(got[fin], ref[fin], **tol):
            raise RuntimeError(f"{tag} {name}: max |diff| {errs[name]} "
                               f"beyond {tol}")
    return errs


def _dist_report(tag: str, res: dict) -> dict:
    """The printed record of one rank's run, without its results."""
    solves = {k: {f: v for f, v in rec.items() if f != "result"}
              for k, rec in res["solves"].items()}
    rec = {k: v for k, v in res.items() if k != "solves"}
    print(f"{tag} {json.dumps(dict(rec, solves=solves))}")
    return solves


def _rect_pull_bound(t, n_edges: int, edge_vals: bool):
    """The least time of one neighbor_reduce on a rank's table: per real
    edge its id (and value), per virtual row its row id and count, per
    row its split flag and output, per gathered row its value; against
    one operation a slot (two with edge values), as ``_pull_bound``."""
    rows = sum(b.rows for b in t.ell)
    nbytes = (n_edges * (8 if edge_vals else 4) + rows * 8 + t.nv * 5
              + t.n_cols * 4)
    return _bound_of(nbytes, n_edges * (2 if edge_vals else 1))


def _rect_spmm_bound(t, n_edges: int, f: int):
    """One K1 SpMM on a rank's table at width ``f``: x's gathered rows
    read and the output written once, per real edge its id and weight,
    per virtual row its row id, per row its split flag, over the memory
    rate; 2 FLOP a real edge and column. The pad slots belong to the
    layout, not to the function, as in ``_pull_bound``."""
    rows = sum(b.rows for b in t.ell)
    nbytes = (t.n_cols + t.nv) * f * 4 + n_edges * 8 + rows * 4 + t.nv
    return _bound_of(nbytes, 2 * n_edges * f)


def _table_csr(shard, part: str, w: torch.Tensor) -> torch.Tensor:
    """A rank's table of ``part`` with slot weights ``w`` as one CSR tensor
    on the card (the library call's operand)."""
    rows, cols, eids, n_cols = SE.shard_edges(shard, part)
    idx = torch.from_numpy(np.stack([rows, cols])).cuda()
    coo = torch.sparse_coo_tensor(idx, w[torch.from_numpy(eids).cuda()],
                                  size=(shard.nv_pad, n_cols))
    return coo.coalesce().to_sparse_csr()


def _timed_case(name: str, fn, plain, library, kernel: str, bound) -> dict:
    """One kernel on a rank's table, timed beside ``bound``. A trace that
    reads the kernel below its bound is taken again; half the batch ms,
    the floor where the kernel holds its call's time, does not hold for a
    table so small that the wrapper's host work sets the batch."""
    ms = _batch_ms(fn)
    bound_ms, bound_by, nbytes = bound
    device_ms = _kernel_device_ms(fn, kernel, at_least_ms=bound_ms)
    return {"case": name, "ms": ms, "device_ms": device_ms,
            "plain_ms": _batch_ms(plain, calls=3, batches=3),
            "library_ms": None if library is None else _batch_ms(library),
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes,
            "share_of_bound": bound_ms / ms,
            "share_of_bound_device": (bound_ms / device_ms if device_ms
                                      else None)}


def _dist_rect_kernels(g) -> dict:
    """K8 in the four cases of the solvers (int32 min, int32 sum, float32
    sum, float32 min with packed slot weights) on each rank's forward
    table at P = 2, and K1 at F = 1 on each rank's own and halo tables,
    against their plain versions behind a NaN-dirtied allocator; rank
    0's tables timed beside the bound, the plain version and, for the
    float32 sum and K1, torch.sparse.mm. The slot weights are PageRank's
    (1/outdeg of the original edge)."""
    rg = reverse(g)
    out_deg = np.maximum(g.degrees(), 1).astype(np.float32)
    sg = PAR.build_sharded_graph(
        rg, (1.0 / out_deg[rg.col_idx]).astype(np.float32), DIST_RANKS)
    gen = torch.Generator(device="cuda").manual_seed(6)
    k8, k1 = {"cases": [], "max_abs_err": 0.0}, {"cases": [],
                                                 "max_abs_err": 0.0}
    for rank in range(DIST_RANKS):
        shard = sg.shard(rank)
        w = torch.from_numpy(shard.edge_w).cuda()
        se = SE.build_shard_ell(shard, with_trans=False, device="cuda")
        t = se.fwd
        n_real = len(SE.shard_edges(shard, "all")[0])
        vals = {"int32": torch.randint(-10**6, 10**6, (t.n_cols,),
                                       dtype=torch.int32, device="cuda",
                                       generator=gen),
                "float32": torch.randn(t.n_cols, device="cuda",
                                       generator=gen)}
        packed = SE.pack_shard_values(se, w).fwd
        ones = _table_csr(shard, "all", torch.ones_like(w))
        print(f"[dist_analytics] K8 rank {rank} table: nv {t.nv}, n_cols "
              f"{t.n_cols}, {n_real} edges, buckets "
              f"{[(b.width, b.rows) for b in t.ell]}, split rows "
              f"{int(t.is_split.sum())}")
        for name, (v, kind, e) in {
                "int32 min": (vals["int32"], "min", None),
                "int32 sum": (vals["int32"], "sum", None),
                "float32 sum": (vals["float32"], "sum", None),
                "float32 min packed": (vals["float32"], "min", packed)}.items():
            _dirty(t.nv)
            got = (SE.ell_gather_reduce(t, v, t.nv, kind, se.sentinel)
                   if e is None else
                   SE.ell_gather_reduce_plus(t, e, v, t.nv, kind, se.sentinel))
            want = K8.neighbor_reduce_plain(t, v, kind, e)
            torch.cuda.synchronize()
            k8["max_abs_err"] = max(k8["max_abs_err"], _pull_close(
                got, want, f"{name} rank {rank} table"))
            if rank:
                continue
            library = None
            if name == "float32 sum":
                col = v[:, None]
                library = lambda: torch.sparse.mm(ones, col)  # noqa: E731
                _pull_close(library()[:, 0], want,
                            "float32 sum: the library call on the table")
            case = _timed_case(
                name, lambda: K8.neighbor_reduce(t, v, kind, e),
                lambda: K8.neighbor_reduce_plain(t, v, kind, e), library,
                "neighbor_reduce_kernel",
                _rect_pull_bound(t, n_real, e is not None))
            print(f"[dist_analytics] K8 rank 0 {json.dumps(case)}")
            k8["cases"].append(case)
        for part in ("own", "halo"):
            sp = SE.build_shard_ell(shard, part=part, with_trans=False,
                                    device="cuda")
            tp = sp.fwd
            if not tp.has_ell_layout:
                raise RuntimeError(f"[dist_analytics] rank {rank}'s {part} "
                                   "table has no edges: K1 checks nothing")
            wp = SE.pack_shard_values(sp, w).fwd
            x = torch.randn(tp.n_cols, 1, device="cuda", generator=gen)
            _dirty(tp.nv)
            got = K1.ell_spmm(tp, wp, x)
            want = K1.ell_spmm_plain(tp, wp, x)
            k1["max_abs_err"] = max(k1["max_abs_err"], _rect_compare(
                got, want, f"ell_spmm F=1 rank {rank} {part}", False))
            csr = _table_csr(shard, part, w)
            if not torch.allclose(torch.sparse.mm(csr, x), want,
                                  rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
                raise RuntimeError("[dist_analytics] torch.sparse.mm "
                                   f"disagrees with plain on {part}")
            if rank:
                continue
            case = _timed_case(
                f"F=1 {part}", lambda: K1.ell_spmm(tp, wp, x),
                lambda: K1.ell_spmm_plain(tp, wp, x),
                lambda: torch.sparse.mm(csr, x), "ell_spmm_kernel",
                _rect_spmm_bound(tp, len(SE.shard_edges(shard, part)[0]), 1))
            print(f"[dist_analytics] K1 rank 0 {json.dumps(case)}")
            k1["cases"].append(case)
    print(f"[dist_analytics] rank tables at P={DIST_RANKS} (nv_pad "
          f"{sg.nv_pad}, h_max {sg.h_max}, halo {sg.halo_counts.tolist()}), "
          f"dirtied allocator: K8 max_abs_err {k8['max_abs_err']}, K1 F=1 "
          f"max_abs_err {k1['max_abs_err']}")
    return {"neighbor_reduce": k8, "ell_spmm": k1}


def _dist_tc_blocks(g, want: int) -> list:
    """The 2-D count's real layout, which one card's runs (P = 1 and 2,
    s = 1) never reach: the four blocks of a 2 x 2 grid of the DAG, each
    laid out as its rank lays it out (``block_edges_2d``: local rows,
    global neighbour ids), counted with K9 and with its plain version;
    the four counts sum to the single-device count. Returns them."""
    from graphaibench_tpu_torch.parallel import dist_analytics as DA

    t0 = time.perf_counter()
    dag = TCM.sorted_dag(g)
    counts = []
    for i, j in ((0, 0), (0, 1), (1, 0), (1, 1)):
        edges = DA.block_edges_2d(dag, 2, i, j, device="cuda")
        got, plain = int(K9.tc_count(edges)), int(K9.tc_count_plain(edges))
        if got != plain:
            raise RuntimeError(f"[dist_analytics] 2 x 2 block ({i}, {j}): "
                               f"tc_count {got}, plain {plain}")
        counts.append(got)
    if sum(counts) != want or max(counts) == want:
        raise RuntimeError(f"[dist_analytics] 2 x 2 blocks count {counts}, "
                           f"the single-device count {want}")
    print(f"[dist_analytics] 2 x 2 grid of the DAG: blocks {counts} (K9 = "
          f"plain), sum {sum(counts)} = the single-device count, in "
          f"{time.perf_counter() - t0:.2f} s")
    return counts


def phase_dist_analytics(g, dg) -> dict:
    """The distributed analytics on the analytics graph: the solvers at one
    nccl rank in this process, then at two gloo ranks spawned on the one
    card (the exchange host-staged), each held to the single-device
    answers and the two ranks to the one; then the 2-D count's blocks of
    a 2 x 2 grid, and K8 and K1 on the rank tables. Returns what the
    kernels line reports of it."""
    t0 = time.perf_counter()
    w = np.random.default_rng(2).uniform(0.1, 2.0, g.ne).astype(np.float32)
    refs = _dist_refs(g, dg, w)
    PAR.initialize(0, 1, port=PAR.multihost.free_port(), backend="nccl",
                   device=torch.device("cuda", 0))
    try:
        one = _dist_solves(g, w, torch.device("cuda", 0))
    finally:
        PAR.multihost.dist.destroy_process_group()
    one_solves = _dist_report("[dist_analytics P=1 nccl]", one)
    errs = _dist_hold("[dist_analytics P=1 nccl]", one["solves"], refs)
    if one["solves"]["pagerank"]["count"] != refs["pagerank_iterations"]:
        raise RuntimeError("[dist_analytics] pagerank iterations "
                           f"{one['solves']['pagerank']['count']} against "
                           f"{refs['pagerank_iterations']} single-device")
    launched = {}
    for rec in one_solves.values():
        for k, v in rec["launches"].items():
            launched[k] = launched.get(k, 0) + v
    for k in ("neighbor_reduce", "ell_spmm", "tc_count"):
        if not launched.get(k):
            raise RuntimeError(f"[dist_analytics] the one-rank solves launched "
                               f"no {k}: {launched}")
    for name in ("bfs", "sssp", "cc"):
        rec = one_solves[name]
        if rec["launches"].get("neighbor_reduce") != rec["count"]:
            raise RuntimeError(f"[dist_analytics] {name}: "
                               f"{rec['launches']} for {rec['count']} sweeps")
    print(f"[dist_analytics] P=1 nccl equal to the single-device answers "
          f"(max |diff| {json.dumps(errs)}); launches of the solves "
          f"{json.dumps(launched)}")
    t1 = time.perf_counter()
    ranks = PAR.launch(_dist_rank, DIST_RANKS, g.row_ptr, g.col_idx, w,
                       device="cuda", backend="gloo",
                       timeout_s=SHARDED_SPAWN_TIMEOUT_S)
    two = [_dist_report(f"[dist_analytics P={DIST_RANKS} gloo rank {r}]", res)
           for r, res in enumerate(ranks)]
    if ranks[0]["transport"] != "host-staged":
        raise RuntimeError(f"[dist_analytics] transport {ranks[0]['transport']}")
    errs2 = _dist_hold(f"[dist_analytics P={DIST_RANKS} gloo]",
                       ranks[0]["solves"], refs)
    errs21 = _dist_hold(f"[dist_analytics P={DIST_RANKS} against P=1]",
                        ranks[0]["solves"],
                        {k: r["result"] for k, r in one["solves"].items()})
    for name, rec in one_solves.items():
        counts = {r["solves"][name]["count"] for r in ranks}
        if counts != {rec["count"]}:
            raise RuntimeError(f"[dist_analytics] {name}: counts {counts} at "
                               f"P={DIST_RANKS}, {rec['count']} at P=1")
    print(f"[dist_analytics] P={DIST_RANKS} gloo on one card in "
          f"{time.perf_counter() - t1:.2f} s: equal to the single-device "
          f"answers (max |diff| {json.dumps(errs2)}) and to P=1 "
          f"({json.dumps(errs21)})")
    _dist_tc_blocks(g, refs["tc"])
    kernels = _dist_rect_kernels(g)
    print(f"[dist_analytics] phase took {time.perf_counter() - t0:.2f} s")
    return {"one_rank": one_solves, "two_ranks": two, **kernels}


# ---- the remat phase --------------------------------------------------------

def remat_configs() -> dict:
    """The remat phase's models (``cfg.remat`` off; the phase turns it on):
    the main phase's GCN, GAT (no head) and GGNN at 2 x 128, and SAGE at the
    convergence recipe's 3 x 256, each at feat_drop REMAT_FEAT_DROP."""
    kw = dict(lr=0.01, feat_drop=REMAT_FEAT_DROP)
    return {
        "gcn": make_config("gcn", 2, FEAT, HIDDEN, CLASSES, **kw),
        "gat": make_config("gat", GAT_LAYERS, FEAT, HIDDEN, CLASSES,
                           use_l2norm=False, use_dense=False, **kw),
        "sage": make_config("sage", REMAT_SAGE_LAYERS, FEAT,
                            REMAT_SAGE_HIDDEN, CLASSES, **kw),
        "ggnn": make_config("ggnn", 1, FEAT, HIDDEN, CLASSES, **kw),
    }


def _remat_grads(model, seed: int) -> tuple[float, dict]:
    """One forward with dropout drawn from a fresh generator seeded with
    ``seed`` and the backward: (reported loss, {name: gradient})."""
    model.params.zero_grad()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b = model.training
    logits = apply_model(model.cfg, model.params, b.device, b.edge_w_agg,
                         model.feats, train=True, generator=gen,
                         trivial_w=True)
    begin, end, _ = model.ranges["train"]
    lg, rep, _ = masked_softmax_loss(logits, model.labels, begin, end,
                                     model.masks["train"])
    lg.backward()
    return float(rep.detach()), {
        n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
        for n, p in model.params.named_parameters()}


def _grads_err(a: dict, b: dict) -> float:
    """The largest |a - b| over the gradients, each over the largest
    |b| of its tensor (at least 1e-30)."""
    return max(float((a[n] - b[n]).abs().max())
               / max(float(b[n].abs().max()), 1e-30) for n in b)


def phase_remat(g) -> dict:
    """``cfg.remat`` on rmat17: for each model of ``remat_configs``, with
    remat off and on, one loss and its gradients at feat_drop 0.5 (and
    GAT's unfused path at score_drop 0.3) from one generator state, the
    remat gradients held to the plain ones; then REMAT_STEPS steps, every
    count set to 0 just before them and read just after, each kernel
    launched as ``REMAT_STEP_LAUNCHES`` says a step, with the step's
    median host ms and its peak memory over what the model holds. Returns
    each arch's launches a step and peaks."""
    ds = _dataset(g, FEAT, CLASSES)
    out = {}
    for arch, cfg in remat_configs().items():
        tag = f"[remat {arch}]"
        grads, info = {}, {}
        cases = [(cfg, "feat_drop")]
        if arch == "gat":
            cases.append((dataclasses.replace(cfg, score_drop=REMAT_SCORE_DROP),
                          "score_drop"))
        for c, what in cases:
            for remat in (False, True, False):
                model = Model(dataclasses.replace(c, remat=remat), ds,
                              device="cuda")
                grads.setdefault(what, []).append(_remat_grads(model, 5))
                del model
            (l0, g0), (l1, g1), (l2, g2) = grads[what]
            err, spread = _grads_err(g1, g0), _grads_err(g2, g0)
            if abs(l1 - l0) > REMAT_GRAD_RTOL * abs(l0) or err > REMAT_GRAD_RTOL:
                raise RuntimeError(f"{tag} {what}: remat loss {l1} against "
                                   f"{l0}, gradients off by {err:.3e} of "
                                   f"their largest (limit {REMAT_GRAD_RTOL})")
            info[f"{what}_grad_err"] = err
            info[f"{what}_grad_spread_of_two_plain_runs"] = spread
        want = REMAT_STEP_LAUNCHES[arch]
        for remat in (False, True):
            model = Model(dataclasses.replace(cfg, remat=remat), ds,
                          device="cuda")
            model.train_epoch()                       # warm
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            log = model.train(REMAT_STEPS, verbose=False)
            counts = _counts()
            peak = torch.cuda.max_memory_allocated() - base
            _assert_counts(f"{tag} remat={remat}", counts,
                           {k: REMAT_STEPS * v
                            for k, v in want[int(remat)].items()})
            losses = [l for l, _, _ in log]
            if not all(np.isfinite(losses)):
                raise RuntimeError(f"{tag} non-finite loss: {losses}")
            key = "remat" if remat else "plain"
            info[f"{key}_launches_per_step"] = want[int(remat)]
            info[f"{key}_peak_gib_over_model"] = peak / 2**30
            info[f"{key}_step_ms_median"] = statistics.median(
                dt for _, _, dt in log) * 1e3
            del model
        print(f"{tag} {json.dumps(info)}")
        out[arch] = info
    return out


# ---- the p15a phase ----------------------------------------------------------

def _first_fit_bound(g) -> tuple[float, str, int]:
    """The least time the card could take for one first-fit round with
    every row active, in ms, what bounds it, and the bytes: the row
    pointers, ids, colours and active flags read once, the colours
    written once; against one compare an id over the float32 rate."""
    nbytes = 4 * (g.nv + 1) + 4 * g.ne + 4 * g.nv + g.nv + 4 * g.nv
    return _bound_of(nbytes, g.ne)


def _first_fit_states(dg, seed: int):
    """(name, colours, active, max_colors) of three rounds: the solve's
    first (every row active, all colours 0), random colours below the
    default max_colors on 60% of the rows, and random colours below 3
    (most rows with every colour taken)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mc = int(dg.deg.max()) + 2
    nv = dg.nv
    zeros = torch.zeros(nv, dtype=torch.int32, device="cuda")
    act = torch.rand(nv, generator=gen, device="cuda") < 0.6
    return [("first round", zeros, torch.ones_like(act), mc),
            ("random", torch.randint(0, mc, (nv,), generator=gen,
                                     device="cuda", dtype=torch.int32), act, mc),
            ("max_colors 3", torch.randint(0, 3, (nv,), generator=gen,
                                           device="cuda", dtype=torch.int32),
             act, 3)]


def _first_fit_compare(dg, tag: str, dirty: bool) -> None:
    for name, colors, active, mc in _first_fit_states(dg, 3):
        if dirty:
            _dirty(dg.nv)
        got = FF.first_fit(dg, colors, active, mc)
        want = FF.first_fit_plain(dg, colors, active, mc)
        if not torch.equal(got, want):
            raise RuntimeError(f"[p15a] first_fit {tag} {name}: "
                               f"{int((got != want).sum())} rows differ")


def _color_rounds(dg) -> tuple:
    """``analytics/coloring.py::color``'s loop with each round's active rows
    read: (colours, [active rows a round])."""
    nv, dev = dg.nv, dg.col_idx.device
    src, dst = dg.edge_src.long(), dg.col_idx.long()
    mc = int(dg.deg.max()) + 2
    colors = torch.zeros(nv, dtype=torch.int32, device=dev)
    active = torch.ones(nv, dtype=torch.bool, device=dev)
    counts = []
    while len(counts) < mc + 2:
        n = int(active.sum())
        if n == 0:
            break
        counts.append(n)
        colors = FF.first_fit(dg, colors, active, mc)
        conflict = (colors[src] == colors[dst]) & (src != dst)
        loser = torch.minimum(src, dst)[conflict]
        active = torch.zeros(nv, dtype=torch.bool, device=dev)
        active[loser] = True
    return colors, counts


def _p15a_color(g, dg) -> dict:
    """K14 against first_fit_plain at the analytics size and at rmat13
    behind the dirtied allocator, timed beside its bound; ``color`` held to
    ``coloring_valid``, its K14 launches to the rounds it reports (one
    launch a round), its seconds, K14's device ms summed over a warm solve
    and the active rows of its first rounds (``_color_rounds``, whose
    colours must be ``color``'s)."""
    _first_fit_compare(dg, f"rmat{ANALYTICS_SCALE}", False)
    small = rmat(PULL_DIRTY_SCALE, EDGE_FACTOR, seed=0)
    _first_fit_compare(to_device_graph(small, device="cuda",
                                       with_transpose=False, with_ell=False),
                       f"rmat{PULL_DIRTY_SCALE}", True)
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    colors, rounds = COL.color(dg, return_rounds=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    _assert_counts("[p15a] color", _counts(), {"first_fit": rounds})
    colors_np = colors.cpu().numpy()
    if rounds < 1 or not verifiers.coloring_valid(g, colors_np):
        raise RuntimeError(f"[p15a] color: an invalid colouring after "
                           f"{rounds} rounds")
    again, active = _color_rounds(dg)
    if not torch.equal(again, colors) or len(active) != rounds:
        raise RuntimeError("[p15a] color: the probe loop's colours or rounds "
                           "differ from color()'s")
    by = _device_ms_by_name(lambda: COL.color(dg), 1)
    _, zeros, ones, mc = _first_fit_states(dg, 3)[0]
    bound_ms, bound_by, nbytes = _first_fit_bound(dg)
    info = {
        "rounds": rounds, "num_colors": int(len(np.unique(colors_np))),
        "first_solve_s": first_s,
        "warm_s_per_solve": _solve_seconds(lambda: COL.color(dg)),
        "k14_device_ms_per_solve": sum(v for k, v in by.items()
                                       if "first_fit" in k) if by else None,
        "solve_device_ms": sum(by.values()) if by else None,
        "active_first_rounds": active[:5],
        "hubs": int(FF._tables(dg)["hubs"].numel()),
        "ms": _batch_ms(lambda: FF.first_fit(dg, zeros, ones, mc)),
        "device_ms": _kernel_device_ms(
            lambda: FF.first_fit(dg, zeros, ones, mc), "first_fit_kernel"),
        "plain_ms": _batch_ms(lambda: FF.first_fit_plain(dg, zeros, ones, mc),
                              calls=1, batches=3),
        "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes}
    info["share_of_bound"] = bound_ms / info["ms"]
    print(f"[p15a] color {json.dumps(info)}")
    return dict(info, launches=rounds, max_abs_err=0)


def _p15a_cf(g) -> dict:
    """cf_train on seeded ratings at the analytics size: the RMSE falls,
    one sddmm_dot_ell and one K1 launch an iteration; at rmat16 equal to
    its CPU run (plain versions) within CF_RTOL."""
    ratings = np.random.default_rng(7).integers(1, 6, g.ne).astype(np.float32)
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, hist = CFM.cf_train(g, ratings, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = _counts()
    _assert_counts("[p15a] cf_train", launches,
                   {"sddmm_dot_ell": len(hist), "ell_spmm": len(hist)})
    if not hist[-1] < hist[0]:
        raise RuntimeError(f"[p15a] cf_train: RMSE did not fall: {hist}")
    small = rmat(CF_CPU_SCALE, EDGE_FACTOR, seed=1)
    r = np.random.default_rng(8).integers(1, 6, small.ne).astype(np.float32)
    lat_g, hist_g = CFM.cf_train(small, r, device="cuda")
    lat_c, hist_c = CFM.cf_train(small, r, device="cpu")
    lat_err = float(np.abs(lat_g - lat_c).max() / np.abs(lat_c).max())
    hist_err = float(np.max(np.abs(np.subtract(hist_g, hist_c))
                            / np.abs(hist_c)))
    if lat_err > CF_RTOL or hist_err > CF_RTOL:
        raise RuntimeError(f"[p15a] cf_train rmat{CF_CPU_SCALE}: the card "
                           f"against the CPU, latents {lat_err:.3e}, RMSE "
                           f"{hist_err:.3e} (limit {CF_RTOL})")
    info = {"rmse": hist, "s_per_solve": dt, "launches_per_solve": launches,
            f"rmat{CF_CPU_SCALE}_latents_err": lat_err,
            f"rmat{CF_CPU_SCALE}_rmse_err": hist_err}
    print(f"[p15a] cf {json.dumps(info)}")
    return info


def _undirected_weights(g, seed: int) -> np.ndarray:
    """One weight in [0.5, 1.5) an undirected edge, both directions alike."""
    src, dst = g.coo()
    key = np.minimum(src, dst).astype(np.int64) * g.nv + np.maximum(src, dst)
    uniq, inv = np.unique(key, return_inverse=True)
    w = np.random.default_rng(seed).random(len(uniq)) + 0.5
    return w[inv.reshape(-1)]


def _p15a_mst(g) -> dict:
    """boruvka_mst's total at the analytics size against scipy's minimum
    spanning tree (float64), and at rmat13 against kruskal_oracle."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import minimum_spanning_tree

    w = _undirected_weights(g, 2)
    t0 = time.perf_counter()
    ids, total = MSTM.boruvka_mst(g, w, device="cuda")
    dt = time.perf_counter() - t0
    want = float(minimum_spanning_tree(csr_matrix(
        (w, g.col_idx, g.row_ptr), shape=(g.nv, g.nv))).sum())
    if abs(total - want) > 1e-9 * want:
        raise RuntimeError(f"[p15a] boruvka_mst total {total}, scipy {want}")
    small = rmat(PULL_DIRTY_SCALE, EDGE_FACTOR, seed=0)
    ws = _undirected_weights(small, 3)
    _, small_total = MSTM.boruvka_mst(small, ws, device="cuda")
    oracle = MSTM.kruskal_oracle(small, ws)
    if abs(small_total - oracle) > 1e-9 * oracle:
        raise RuntimeError(f"[p15a] boruvka_mst rmat{PULL_DIRTY_SCALE} "
                           f"total {small_total}, kruskal {oracle}")
    info = {"edges": len(ids), "total": total, "scipy": want, "s": dt,
            f"rmat{PULL_DIRTY_SCALE}_total": small_total}
    print(f"[p15a] boruvka_mst {json.dumps(info)}")
    return info


def _are_edges(g, src, dst) -> bool:
    """Every (src, dst) an edge of g (whose rows are sorted), or a
    self-edge at a vertex without neighbours."""
    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    s, d = g.coo()
    keys = s.astype(np.int64) * g.nv + d
    q = src * g.nv + dst
    pos = np.clip(np.searchsorted(keys, q), 0, max(len(keys) - 1, 0))
    hit = keys[pos] == q if len(keys) else np.zeros(len(q), bool)
    stall = (src == dst) & (g.degrees()[src] == 0)
    return bool((hit | stall).all())


def _p15a_walks(g) -> dict:
    """khop_sample and random_walk at the analytics size: every sampled and
    walked edge an edge; then deepwalk and node2vec at EMBED_SCALE, their
    embeddings finite."""
    seeds = np.arange(64)
    t0 = time.perf_counter()
    hops = KHOPM.khop_sample(g, seeds, device="cuda")
    sample_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    walks = KHOPM.random_walk(g, np.arange(g.nv), WALK_LENGTH, device="cuda")
    walk_s = time.perf_counter() - t0
    if not all(_are_edges(g, s, d) for s, d in hops):
        raise RuntimeError("[p15a] khop_sample drew a pair that is no edge")
    if not _are_edges(g, walks[:, :-1].ravel(), walks[:, 1:].ravel()):
        raise RuntimeError("[p15a] random_walk took a step along no edge")
    eg = rmat(EMBED_SCALE, EDGE_FACTOR, seed=0)
    emb_s = {}
    for name, fn in (("deepwalk", EMBM.deepwalk), ("node2vec", EMBM.node2vec)):
        t0 = time.perf_counter()
        emb = (fn(eg, device="cuda") if name == "deepwalk"
               else fn(eg, p=0.5, q=2.0, device="cuda"))
        emb_s[name] = time.perf_counter() - t0
        if emb.shape != (eg.nv, 64) or not np.isfinite(emb).all():
            raise RuntimeError(f"[p15a] {name} rmat{EMBED_SCALE}: embeddings "
                               f"of shape {emb.shape}, finite "
                               f"{bool(np.isfinite(emb).all())}")
    info = {"sampled_edges_per_hop": [len(s) for s, _ in hops],
            "sample_s": sample_s, "walks": list(walks.shape),
            "walk_s": walk_s, f"rmat{EMBED_SCALE}_embed_s": emb_s}
    print(f"[p15a] walks {json.dumps(info)}")
    return info


def _p15a_knn() -> dict:
    """knn_search against a float64 brute force on random embeddings: the
    indices of every query whose float64 top k + 1 scores lie at least
    KNN_GAP apart, and the scores within KNN_GAP."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((KNN_N, 64)).astype(np.float32)
    q = rng.standard_normal((KNN_Q, 64)).astype(np.float32)
    t0 = time.perf_counter()
    idx, scores = ANNM.knn_search(x, q, KNN_K, device="cuda")
    dt = time.perf_counter() - t0
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    ref = 2.0 * (q64 @ x64.T) - (x64 * x64).sum(1)[None, :]
    order = np.argsort(-ref, axis=1)[:, :KNN_K + 1]
    top = np.take_along_axis(ref, order, 1)
    clear = (np.diff(-top, axis=1) >= KNN_GAP).all(1)
    if clear.mean() < 0.5:
        raise RuntimeError(f"[p15a] knn: only {clear.sum()} queries without "
                           "near ties")
    if not np.array_equal(idx[clear], order[clear, :KNN_K]):
        raise RuntimeError("[p15a] knn_search indices differ from float64")
    err = float(np.abs(scores - top[:, :KNN_K]).max())
    if err > KNN_GAP:
        raise RuntimeError(f"[p15a] knn_search scores off by {err}")
    info = {"n": KNN_N, "queries": KNN_Q, "k": KNN_K,
            "queries_checked": int(clear.sum()), "score_err": err, "s": dt}
    print(f"[p15a] knn {json.dumps(info)}")
    return info


def _p15a_cli() -> None:
    """``cli analytics color|cf|sample|embed <dir>`` side by side, without
    --device, on a dataset written by save_graph: each prints ``device =
    cuda`` and ``Correct`` and exits 0."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "GAB_SHARDS"}
    cli = [sys.executable, "-m", "graphaibench_tpu_torch.cli"]
    with tempfile.TemporaryDirectory() as tmp:
        save_graph(rmat(PULL_DIRTY_SCALE, CLI_EDGE_FACTOR, seed=0), tmp)
        t0 = time.perf_counter()
        outs = _run_cli(cli, root, env, [["analytics", a[0], tmp, *a[1:]]
                                         for a in P15A_CLI])
        dt = time.perf_counter() - t0
    for args, (rc, out, err) in zip(P15A_CLI, outs):
        lines = out.splitlines()
        if rc != 0 or "device = cuda" not in lines or "Correct" not in lines:
            raise RuntimeError(f"cli analytics {' '.join(args)}: exit {rc}"
                               f"\n{out}\n{err[-3000:]}")
        runtime = next(l for l in lines if l.startswith("runtime"))
        print(f"[p15a] cli analytics {' '.join(args)}: device = cuda, "
              f"Correct, {runtime}")
    print(f"[p15a] the {len(P15A_CLI)} CLI runs side by side in {dt:.2f} s")


def phase_p15a(g, dg) -> dict:
    """P15a's solvers on the analytics graph (``color``'s, ``cf_train``'s,
    ``boruvka_mst``'s, the samplers' and ``knn_search``'s checks above) and
    their CLI routes. Returns K14's entry data and CF's launches."""
    t0 = time.perf_counter()

    def step(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"[p15a] {name} took {time.perf_counter() - t:.2f} s")
        return out

    color = step("color", _p15a_color, g, dg)
    cf = step("cf", _p15a_cf, g)
    step("boruvka_mst", _p15a_mst, g)
    step("walks", _p15a_walks, g)
    step("knn", _p15a_knn)
    step("cli", _p15a_cli)
    print(f"[p15a] phase took {time.perf_counter() - t0:.2f} s")
    return {"first_fit": color, "cf_launches": cf["launches_per_solve"]}


# ---- the p15b phase ----------------------------------------------------------

def _labeled(g, seed: int):
    """``g`` with P15B_LABELS vertex labels drawn from ``seed``."""
    lab = np.random.default_rng(seed).integers(0, P15B_LABELS, g.nv)
    return CSRGraph(row_ptr=g.row_ptr, col_idx=g.col_idx,
                    vlabels=lab.astype(np.uint8))


def _p15b_nlf(g) -> dict:
    """K1 on the NLF's SpMM: unit weights against the (nv, 4) one-hot of
    seeded labels, behind the NaN-dirtied allocator, equal exactly to the
    plain index_add_, to K1's plain version and to torch.sparse.mm (sums
    of ones); timed beside its bound, its plain version, index_add_ and
    torch.sparse.mm. Then neighborhood_label_frequency on the card: one K1
    launch, equal to the host route."""
    gl = _labeled(g, 11)
    lab = torch.from_numpy(gl.vlabels.astype(np.int64)).cuda()
    dg = to_device_graph(g, device="cuda", with_transpose=False)
    x = torch.zeros((g.nv, P15B_LABELS), device="cuda")
    x[torch.arange(g.nv, device="cuda"), lab] = 1.0
    ones = torch.ones(g.ne, device="cuda")
    w = pack_slot_values(dg, ones)
    src, dst = dg.edge_src.long(), dg.col_idx.long()

    def index_add():
        return torch.zeros_like(x).index_add_(0, src, x[dst])

    csr = torch.sparse_csr_tensor(dg.row_ptr, dg.col_idx, ones,
                                  size=(g.nv, g.nv))
    want = index_add()
    _dirty(g.nv * P15B_LABELS)
    for name, got in (("K1", K1.ell_spmm(dg, w, x)),
                      ("K1's plain version", K1.ell_spmm_plain(dg, w, x)),
                      ("torch.sparse.mm", torch.sparse.mm(csr, x))):
        if not torch.equal(got, want):
            raise RuntimeError(f"[p15b] nlf rmat{P15B_SCALE}: {name} differs "
                               f"from index_add_ in "
                               f"{int((got != want).any(1).sum())} rows")
    _zero_counts()
    nlf = LAB.neighborhood_label_frequency(gl, device="cuda")
    _assert_counts("[p15b] neighborhood_label_frequency", _counts(),
                   {"ell_spmm": 1})
    if not np.array_equal(nlf, LAB.neighborhood_label_frequency(gl,
                                                                device=False)):
        raise RuntimeError("[p15b] neighborhood_label_frequency on the card "
                           "differs from the host route")
    bound_ms, bound_by, nbytes = _bound(dg, P15B_LABELS)
    ms = _batch_ms(lambda: K1.ell_spmm(dg, w, x))
    device_ms = _kernel_device_ms(lambda: K1.ell_spmm(dg, w, x),
                                  "ell_spmm_kernel")
    case = {"case": f"nlf rmat{P15B_SCALE} F={P15B_LABELS}",
            "F": P15B_LABELS, "tile": K1._tile_floats(dg.nv, P15B_LABELS),
            "max_abs_err": 0.0, "ms": ms, "device_ms": device_ms,
            "plain_ms": _batch_ms(lambda: K1.ell_spmm_plain(dg, w, x),
                                  calls=5, batches=3),
            "index_add_ms": _batch_ms(index_add),
            "library_ms": _batch_ms(lambda: torch.sparse.mm(csr, x)),
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes,
            "share_of_bound": bound_ms / ms,
            "share_of_bound_device": (bound_ms / device_ms if device_ms
                                      else None)}
    print(f"[p15b] nlf {json.dumps(case)}")
    return case


def _motif_oracle(g) -> tuple[dict, tuple]:
    """Every count of ``motif_counts(g, 4)`` in exact integers: scipy's int64
    sparse products A2 = A·A, tr(A⁴) = Σ A2∘A2, tri_e = A2∘A and 24·K4 =
    Σ (C·A)∘C (C's rows a_u∘a_v per directed edge), the degree terms in
    int64. Returns (counts, (6T, tr(A⁴), 24·K4))."""
    from scipy.sparse import csr_matrix

    src, dst = undirected_pairs(g)
    rows, cols = np.r_[src, dst], np.r_[dst, src]
    A = csr_matrix((np.ones(len(rows), np.int64), (rows, cols)),
                   shape=(g.nv, g.nv))
    A2 = (A @ A).tocsr()
    closed4 = int(A2.multiply(A2).sum())
    tri_e = A2.multiply(A).tocsr()
    six_t = int(tri_e.sum())
    C = A[rows].multiply(A[cols]).tocsr()
    k24 = int((C @ A).multiply(C).sum())
    deg = np.asarray(A.sum(1)).ravel().astype(np.int64)
    tri_v = np.asarray(tri_e.sum(1)).ravel().astype(np.int64) // 2
    te = np.asarray(tri_e[src, dst]).ravel().astype(np.int64)
    t = six_t // 6
    counts = {
        "wedge": int((deg * (deg - 1) // 2).sum()),
        "triangle": t,
        "3-star": int((deg * (deg - 1) * (deg - 2) // 6).sum()),
        "4-path": int(((deg[src] - 1) * (deg[dst] - 1)).sum()) - 3 * t,
        "tailed_triangle": int((tri_v * (deg - 2)).sum()),
        "square": (closed4 - 2 * len(src)
                   - 2 * int((deg * (deg - 1)).sum())) // 8,
        "diamond": int((te * (te - 1) // 2).sum()),
        "4-clique": k24 // 24}
    return counts, (six_t, closed4, k24)


def _induced_of(ni: dict) -> dict:
    """The induced counts of the non-induced ``ni``: back-substitution in
    integers through the containment matrix, which is unit upper
    triangular."""
    order = MOTM._INDUCED_ORDER
    out = {}
    for i in reversed(range(len(order))):
        out[order[i]] = ni[order[i]] - sum(
            int(MOTM._SUPER[i, j]) * out[order[j]]
            for j in range(i + 1, len(order)))
    out["triangle"] = ni["triangle"]
    out["wedge"] = ni["wedge"] - 3 * ni["triangle"]
    return out


def _p15b_motif(g, full) -> dict:
    """motif_counts(g, 3 and 4) and induced_motif_counts on the card, every
    count equal to _motif_oracle's, no kernel of the port launched (dense
    products); at full width, the k = 4 count timed cold and warm, its
    device ms by kernel under torch.profiler, its peak memory, its
    triangle equal to K9's triangle_count and its wedge and 3-star to the
    degree forms."""
    t0 = time.perf_counter()
    want, sums = _motif_oracle(g)
    oracle_s = time.perf_counter() - t0
    if sums != P15B_ORACLE_SUMS:
        raise RuntimeError(f"[p15b] the oracle's 6T, tr(A^4), 24 K4 at "
                           f"rmat{P15B_SCALE}: {sums}, expected "
                           f"{P15B_ORACLE_SUMS}")
    _zero_counts()
    t0 = time.perf_counter()
    got = MOTM.motif_counts(g, 4, device="cuda")
    small_s = time.perf_counter() - t0
    _assert_counts("[p15b] motif_counts", _counts(), {})
    checks = ((got, want), (MOTM.motif_counts(g, 3, device="cuda"),
                            {k: want[k] for k in ("wedge", "triangle")}),
              (MOTM.induced_motif_counts(g, device="cuda"), _induced_of(want)))
    for have, exp in checks:
        diff = {k: (have.get(k), v) for k, v in exp.items()
                if have.get(k) != v}
        if diff or have.keys() != exp.keys():
            raise RuntimeError(f"[p15b] motif rmat{P15B_SCALE}: (card, "
                               f"oracle) {diff}, names {sorted(have)}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    counts = MOTM.motif_counts(full, 4, device="cuda")
    cold_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    again = MOTM.motif_counts(full, 4, device="cuda")
    warm_s = time.perf_counter() - t0
    if again != counts:
        raise RuntimeError("[p15b] motif_counts at full width differs "
                           "between two runs")
    by = _device_ms_by_name(lambda: MOTM.motif_counts(full, 4, device="cuda"),
                            1)
    triangles = TCM.triangle_count(full, device="cuda")
    src, dst = undirected_pairs(full)
    deg = (np.bincount(src, minlength=full.nv)
           + np.bincount(dst, minlength=full.nv)).astype(np.int64)
    forms = {"triangle": int(triangles),
             "wedge": int((deg * (deg - 1) // 2).sum()),
             "3-star": int((deg * (deg - 1) * (deg - 2) // 6).sum())}
    if any(counts[k] != v for k, v in forms.items()):
        raise RuntimeError(f"[p15b] motif rmat{P15B_FULL_SCALE}: {counts} "
                           f"against K9 and the degree forms {forms}")
    top = sorted(by.items(), key=lambda kv: -kv[1])[:4]
    info = {f"rmat{P15B_SCALE}": {"counts": got, "oracle_sums": list(sums),
                                  "oracle_s": oracle_s, "k4_s": small_s},
            f"rmat{P15B_FULL_SCALE}": {
                "nv": full.nv, "ne": full.ne, "counts": counts,
                "k4_cold_s": cold_s, "k4_warm_s": warm_s,
                "peak_gib": peak / 2**30,
                "device_ms": sum(by.values()) if by else None,
                "top_kernels_ms": [[k[:80], v] for k, v in top]}}
    print(f"[p15b] motif {json.dumps(info)}")
    return info


def _p15b_fsm(g) -> dict:
    """fsm(min_support=1) at P15B_FSM_CPU_SCALE on the card equal to the
    same call on the CPU; at the phase's scale timed, its K1 launches
    counted (one NLF each for the edges and the wedges) and its edge
    supports equal to the fsm route's edge-list check."""
    from graphaibench_tpu_torch.analytics import _edge_supports

    def patterns(pats):
        return [(f.kind, f.labels, f.support) for f in pats]

    small = _labeled(rmat(P15B_FSM_CPU_SCALE, EDGE_FACTOR, seed=0), 12)
    on_card = patterns(FSMM.fsm(small, device="cuda"))
    if on_card != patterns(FSMM.fsm(small, device="cpu")):
        raise RuntimeError(f"[p15b] fsm rmat{P15B_FSM_CPU_SCALE}: the card's "
                           "patterns differ from the CPU's")
    gl = _labeled(g, 13)
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pats = FSMM.fsm(gl, device="cuda")
    dt = time.perf_counter() - t0
    launches = _counts()
    _assert_counts("[p15b] fsm", launches, {"ell_spmm": 2})
    edges = {f.labels: f.support for f in pats if f.kind == "edge"}
    if edges != _edge_supports(gl, 1):
        raise RuntimeError(f"[p15b] fsm rmat{P15B_SCALE}: edge supports "
                           "differ from the edge-list check")
    t0 = time.perf_counter()
    if patterns(FSMM.fsm(gl, device="cuda")) != patterns(pats):
        raise RuntimeError("[p15b] fsm differs between two runs")
    info = {f"rmat{P15B_FSM_CPU_SCALE}_patterns": len(on_card),
            "patterns": len(pats),
            "by_kind": {k: sum(f.kind == k for f in pats)
                        for k in ("edge", "wedge", "triangle")},
            "first_s": dt, "warm_s": time.perf_counter() - t0,
            "launches": {k: v for k, v in launches.items() if v}}
    print(f"[p15b] fsm rmat{P15B_SCALE} {json.dumps(info)}")
    return info


def _p15b_cli() -> None:
    """``cli analytics motif <dir> 4`` and ``analytics fsm <dir>`` side by
    side, without --device, on a dataset with vertex labels written by
    save_graph: each prints ``device = cuda`` and ``Correct`` and exits
    0."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "GAB_SHARDS"}
    cli = [sys.executable, "-m", "graphaibench_tpu_torch.cli"]
    runs = (("motif", "4"), ("fsm",))
    with tempfile.TemporaryDirectory() as tmp:
        save_graph(_labeled(rmat(P15B_CLI_SCALE, EDGE_FACTOR, seed=0), 14),
                   tmp)
        t0 = time.perf_counter()
        outs = _run_cli(cli, root, env, [["analytics", a[0], tmp, *a[1:]]
                                         for a in runs])
        dt = time.perf_counter() - t0
    for args, (rc, out, err) in zip(runs, outs):
        lines = out.splitlines()
        if rc != 0 or "device = cuda" not in lines or "Correct" not in lines:
            raise RuntimeError(f"cli analytics {' '.join(args)}: exit {rc}"
                               f"\n{out}\n{err[-3000:]}")
        runtime = next(l for l in lines if l.startswith("runtime"))
        print(f"[p15b] cli analytics {' '.join(args)}: device = cuda, "
              f"Correct, {runtime}")
    print(f"[p15b] the {len(runs)} CLI runs side by side in {dt:.2f} s")


def phase_p15b() -> dict:
    """P15b's pattern solvers (the checks above) and their CLI routes.
    Returns K1's NLF case and fsm's launches."""
    t0 = time.perf_counter()
    g = rmat(P15B_SCALE, EDGE_FACTOR, seed=0)
    full = rmat(P15B_FULL_SCALE, EDGE_FACTOR, seed=0)
    print(f"[p15b] rmat{P15B_SCALE} nv={g.nv} ne={g.ne}, "
          f"rmat{P15B_FULL_SCALE} nv={full.nv} ne={full.ne}, generated in "
          f"{time.perf_counter() - t0:.2f} s")

    def step(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"[p15b] {name} took {time.perf_counter() - t:.2f} s")
        return out

    nlf = step("nlf", _p15b_nlf, g)
    step("motif", _p15b_motif, g, full)
    fsm = step("fsm", _p15b_fsm, g)
    step("cli", _p15b_cli)
    print(f"[p15b] phase took {time.perf_counter() - t0:.2f} s")
    return {"nlf": nlf, "fsm_launches": fsm["launches"]}


def _timed(name: str, fn, *args):
    """fn(*args), with its seconds printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[seconds] {name} {time.perf_counter() - t0:.2f} s")
    return out


def main() -> None:
    name = _timed("device", phase_device)
    _timed("build", phase_build)
    t0 = time.perf_counter()
    g = rmat(SCALE, EDGE_FACTOR, seed=0)
    print(f"[graph] rmat({SCALE}, {EDGE_FACTOR}) generated in "
          f"{time.perf_counter() - t0:.2f} s")
    cases, other_err = _timed("kernel K1", phase_kernel, g)
    gat_kernels = _timed("kernel gat", phase_gat_kernels, g)
    edge_kernels = _timed("kernel edge", phase_edge_kernels, g)
    _timed("small", phase_small)
    _timed("small trainer", phase_small_trainer)
    gcn, gat, launches = _timed("main", phase_main, g)
    v1_launches, _ = _timed("main v1", phase_main_v1, g)
    _timed("main sampled", phase_main_sampled, g)

    def epochs_and_profile():
        for model in (gcn, gat):
            phase_profile(model.cfg.arch,
                          lambda n, m=model: m.train(n, verbose=False),
                          PROFILED_EPOCHS, phase_epochs(model))

    _timed("epochs and profile", epochs_and_profile)
    pull, tc, kcore, ag, adg = _timed("analytics", phase_analytics)
    k12 = _timed("compress", phase_compress, ag, adg)
    sharded = _timed("sharded", phase_sharded, g)
    tp_dp = _timed("tp_dp", phase_tp_dp, g)
    dist = _timed("dist_analytics", phase_dist_analytics, ag, adg)
    remat = _timed("remat", phase_remat, g)
    p15a = _timed("p15a", phase_p15a, ag, adg)
    p15b = _timed("p15b", phase_p15b)

    def remat_launches(kname):
        """A kernel's launches a step of the remat phase, without remat and
        with it, by arch."""
        return {arch: [r[f"{k}_launches_per_step"].get(kname, 0)
                       for k in ("plain", "remat")]
                for arch, r in remat.items()}

    def dist_launches(kname):
        """A kernel's launches a solve of the distributed solvers: at one
        rank, and at each of the two ranks."""
        return {"one_rank_per_solve": {
                    k: r["launches"].get(kname, 0)
                    for k, r in dist["one_rank"].items()},
                "two_ranks_per_solve": {
                    k: [r[k]["launches"].get(kname, 0)
                        for r in dist["two_ranks"]]
                    for k in dist["one_rank"]}}
    rect_err = {k: max(v, tp_dp["rect_err"][k])
                for k, v in sharded["rect_err"].items()}

    def sharded_launches(kname):
        """A kernel's launches per step on the sharded main paths: one rank,
        each of two ranks, each rank of the (1 x 2) and (2 x 2)
        tensor-parallel runs."""
        return {"one_rank_per_step": {
                    arch: r["launches_per_step"].get(kname, 0)
                    for arch, r in sharded["one_rank"].items()},
                "two_ranks_per_step": {
                    arch: [c.get(kname, 0) for c in r["launches_per_step"]]
                    for arch, r in sharded["two_ranks"].items()},
                f"tp_1x{TP_M}_per_step": {
                    arch: [c.get(kname, 0) for c in r["launches_per_step"]]
                    for arch, r in tp_dp["one"].items()},
                f"tp_2x{TP_M}_per_step": [
                    c.get(kname, 0)
                    for c in tp_dp["halo"]["launches_per_step"]],
                "rect_max_abs_err": rect_err[kname]}

    head = cases[0]
    kernels = [{
        "name": "ell_spmm",
        "route": "cuda",
        "source": "graphaibench_tpu_torch/csrc/ell_spmm.cu",
        "replaces": "graphaibench_tpu/ops/pallas_spmm.py:43",
        "launches": launches["ell_spmm"],
        "max_abs_err": max(other_err, rect_err["ell_spmm"],
                           dist["ell_spmm"]["max_abs_err"],
                           p15b["nlf"]["max_abs_err"],
                           *(c["max_abs_err"] for c in cases)),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "cases": cases,
        "sharded": sharded_launches("ell_spmm"),
        "dist_analytics": dict(dist_launches("ell_spmm"),
                               f1_cases=dist["ell_spmm"]["cases"]),
        "remat_per_step": remat_launches("ell_spmm"),
        "cf_per_solve": p15a["cf_launches"]["ell_spmm"],
        "nlf": p15b["nlf"],
        "fsm_per_solve": p15b["fsm_launches"].get("ell_spmm", 0),
    }]
    for kname, line in GAT_KERNELS.items():
        res = gat_kernels[kname]
        head = res["cases"][0]      # F = 128, the hidden layer's width
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "graphaibench_tpu_torch/csrc/fused_gat.cu",
            "replaces": f"graphaibench_tpu/ops/fused_gat.py:{line}",
            "launches": launches[kname],
            "max_abs_err": max(res["max_abs_err"], rect_err[kname]),
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            # no single PyTorch call computes a pass of the fused attention
            "library_ms": None,
            "cases": res["cases"],
            "sharded": sharded_launches(kname),
            "remat_per_step": remat_launches(kname),
        })
    for kname, replaces in EDGE_KERNELS.items():
        res = edge_kernels[kname]
        # F = 128; for ell_row_reduce the sum, which has a library call
        head = next(c for c in res["cases"]
                    if c["case"] in ("ell_row_reduce sum", kname))
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "graphaibench_tpu_torch/csrc/ell_edge.cu",
            "replaces": replaces,
            "launches": v1_launches[kname],
            "max_abs_err": res["max_abs_err"],
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "cases": res["cases"],
            **({"cf_per_solve": p15a["cf_launches"][kname]}
               if kname == "sddmm_dot_ell" else {}),
        })
    head = next(c for c in pull["cases"] if c["case"] == PULL_HEAD)
    kernels.append({
        "name": "neighbor_reduce",
        "route": "cuda",
        "source": "graphaibench_tpu_torch/csrc/ell_pull.cu",
        "replaces": PULL_REPLACES,
        "launches": pull["launches"],
        "max_abs_err": max(pull["max_abs_err"],
                           dist["neighbor_reduce"]["max_abs_err"]),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "cases": pull["cases"],
        "dist_analytics": dict(dist_launches("neighbor_reduce"),
                               rank_table_cases=dist["neighbor_reduce"][
                                   "cases"]),
    })
    for kname, source, replaces, res in (
            ("tc_count", "tc_count.cu", TC_REPLACES, tc),
            ("hindex_sweep", "kcore_hindex.cu", HINDEX_REPLACES, kcore)):
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": f"graphaibench_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": res["launches"],
            "max_abs_err": res["max_abs_err"],
            "ms": res["ms"],
            "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"],
            # no one PyTorch call computes a DAG intersection count or an
            # h-index sweep
            "library_ms": None,
            "device_ms": res["device_ms"],
            **({"dist_analytics": dist_launches(kname)}
               if kname == "tc_count" else {}),
        })
    for kname, source, replaces in (
            *((k, "cgr_decode.cu", r) for k, r in CGR_KERNELS.items()),
            *((k, "vbyte_decode.cu", r) for k, r in VBYTE_KERNELS.items())):
        res = k12["cases"][kname]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": f"graphaibench_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": k12["launches"][kname],
            "max_abs_err": 0,
            "ms": res["ms"],
            "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"],
            # no PyTorch call decodes a CGR stream or a varint
            "library_ms": None,
            "device_ms": res["device_ms"],
            **({"cases": [res, k12["cases"][f"{kname}_hybrid"]]}
               if kname in ("svb_decode", "cgr_residual") else {}),
        })
    res = p15a["first_fit"]
    kernels.append({
        "name": "first_fit",
        "route": "cuda",
        "source": "graphaibench_tpu_torch/csrc/coloring.cu",
        "replaces": FIRST_FIT_REPLACES,
        "launches": res["launches"],
        "max_abs_err": res["max_abs_err"],
        "ms": res["ms"],
        "plain_ms": res["plain_ms"],
        "bound_ms": res["bound_ms"],
        "bound_by": res["bound_by"],
        # no PyTorch call takes a row's smallest absent value
        "library_ms": None,
        "device_ms": res["device_ms"],
    })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
