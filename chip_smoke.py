#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``ncf_tpu_torch``) on one card.

    python3 chip_smoke.py          # from the repo root, on a machine with a GPU

Phases (each asserts; any failure exits non-zero and prints no result):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. ``nvcc`` build of every kernel source of the package (one ``nvcc`` per
   source, all started together), with its wall time; the tower's and
   B9's HMMA (tensor-core) instruction counts and resource use, read back
   with ``cuobjdump`` (each instance of B4f, B4b and B9 must hold HMMAs,
   and B9's none may spill to local memory);
3. every kernel against its plain PyTorch version on the card, on the same
   inputs: the streaming top-k (B5) at the serving shapes, with tied
   scores and empty slots, and B5's and B8's answers for a user alone
   equal bit for bit to the same user's inside batches of 17 and 64; the
   sampler (B1), on sorted and iid uniforms, and the temporal sum (B3, B
   of 1, 3, 5, 4,097 and 16,384, K of 1 to 4, ids of -1, ``rows`` and far
   out of range, dt 32 and 33, tables off 16-byte alignment, the grid
   sized to the work and capped) at
   the training step's shapes and at edge shapes (CDFs summed on the CPU
   and on the card, the latter's slots counted where their uniforms see
   it out of order, zero-weight CDF runs, uniforms on entries, clipped,
   NaN, duplicates, N of 3 to 65,536, catalogs over 12,288 items); the scatter-add (B2) bit for bit against its plain
   version run on the CPU and against a second call, in every mode and
   gradient dtype, at the step's shapes and at edge shapes (no ids, every
   id out of range, one id 81,920 times, a Zipf skew), in every mode at
   its routes' edges (``ROW_LIMIT`` rows and one more, n not a multiple
   of the chunk, int64 ids, runs of hundreds at D 200), and its
   pre-grouped entry (the sparse combine's);
   the fused tower's forward (B4f) and backward (B4b) at the three tower
   shapes of the training steps and the two of the benchmark's training
   cells, with dropout 0 and 0.2, and at edge shapes (identical dropout
   zeros), and B4f and B4b run twice at those five shapes in equal bits; the int8 streaming top-k (B6) bit for
   bit at the serving catalog (4M items) and one that does not divide the
   block, D 64 and 61, B 1, 64 and 1024, seg_top 1 and 2, k 1, 10 and 64,
   with ties, padded-row floors and fill slots; the row gather (B7) bit
   for bit (f32 and bf16, duplicate ids); the exact (B8) and segmented
   (B9) top-k through ``compare_topk``, and B9's keys under the rule of
   ``topk.segmax_key_violations`` (100,003 and 1M items, seg 128, 64 and
   32, f32 and bf16 tables, B 1, 5, 64 and 65; the share of keys that
   differ is logged; the keys of one TF32 product, the rule's control,
   must break it in every case at 1M items and 5 users or more) and bit
   for bit on small integers;
4. serving at full width: ``configs/advanced_ncf_bigvocab.yaml`` (12M users
   x 4M items, random weights from a seeded generator) through
   ``ModelServer`` with ``retrieval="exact"`` and ``"fast"``: direct,
   temporal, exclusion, hourly, batched and 64 concurrent coalesced
   requests, held against the exact top-k computed on the card; then
   ``retrieval="int8"`` and ``"int8-fast"`` (B6; a 60-item exclusion at
   k=4 takes the bf16 tier's B5 branch under ``int8``): direct, temporal,
   hourly, 64-user and exclusion requests, each equal to the same request
   with the plain B6 on the card, ``int8`` scores equal to the exact ones,
   recall@10 against the exact top-k reported; and ``AdvancedNCFScorer``
   with ``impl="pallas"`` (B8) and ``"segmented"`` (B9) for 1 and 64 users,
   each kernel then held through ``compare_topk`` against its plain
   version on the queries, 4M-item table and bias it was served;
   then NeuMF (``neumf_ml1m.yaml``, 6040 x 3706) and NCF
   (``ncf_ml100k.yaml``, 943 x 1682) through ``ModelServer`` ->
   ``BruteForceScorer`` under ``ops.embedding.set_impl("pallas")`` (B7),
   equal to ``"xla"`` on the card and to the CPU within a tolerance;
5. kernel, plain-version and library-call times (CUDA events, and device
   time from the profiler, per pass for B5 and B8 beside the times of
   their earlier CUDA-core versions) at
   the serving shapes, beside the least time the card could take (B5, B6,
   B8, B9 at 4M items, B9 also at B=1, B7 at NeuMF's scan; B5, B8 and B9
   against their tensor-core route and against the f32 FMA rate of their
   old one; B6's device time per pass beside its ``__dp4a`` version's,
   B9's beside its CUDA-core version's; B9's library yardstick is one
   unchunked product, key pack and max per segment);
6. the demo checkpoint served on the card against the port's CPU answers;
7. training at full width, config A: ``configs/advanced_ncf_ml1m.yaml``
   as shipped (6040 users x 3706 items, batch 16384, bf16 compute, dropout
   0.2, ``fused_tower: auto``) on batches of ``BatchIterator`` over
   ``generate_interactions`` at that size, 30 ``make_train_step`` steps
   for each sampler x candidate mode; every step must launch B1 once, B2
   seven times, B3, B4f and B4b once each, and the loss must fall;
   config B: ``configs/advanced_ncf_quality.yaml`` (sequence, independent)
   and ``configs/advanced_ncf_sequence.yaml`` (sequence, joint), 30 steps
   each with the train split's ``recent_history(50)`` (B2 eight times a
   step), and a few steps with causal per-example histories in the batch;
   then determinism: two runs of two steps from one parameter state and
   one generator seed end in equal parameters and Adam state, bit for
   bit, for config A (joint and independent) and config B (quality), and
   one step under ``torch.use_deterministic_algorithms(True,
   warn_only=True)`` logs the warnings PyTorch raises for the step;
8. three full-width steps in f32 with dropout 0 on the card and through
   the port on the CPU, from the same params and negatives, with the
   plain tower and with ``fused_tower: on`` (the kernels on the card,
   their plain version on the CPU);
9. serving config B: ``ModelServer`` over the quality config with
   ``user_history`` (``SequenceRescoreScorer``): single, excluding,
   temporal and batched requests and pair scores, held against the same
   server with ``fused_tower: off``; each request launches B4f;
10. the evaluators at full width over the ML-1M-scale synthetic log
   (``advanced_ncf_ml1m.yaml`` and the sequence path's
   ``advanced_ncf_quality.yaml``, with the weights that phase 7's 30
   steps from seeded weights left): the sampled
   ``DeviceEvaluator`` (B4f launched) against itself under
   ``fused_tower: off``, the ``FullCatalogEvaluator`` against
   ``full_ranks_naive`` on 512 users, and both against the port on the
   CPU on 128 users (the split evaluator's ranks first held to the
   values it compared, formed again), each under the near-tie rule: a
   rank may move only by the entries within twice the largest score
   difference measured between the two sides of the positive's score;
   each protocol's host and device time for one whole evaluation, with
   its ten kernels that take the most device time;
11. step time and examples/s (the median of five windows) and a profiler
   window over 20 steps (device time and operations per step, the host
   operations that take the most time) for config A under ``auto`` and
   ``off`` in both candidate modes and for config B; each training
   kernel's time (CUDA events, and device time from the profiler) beside
   its plain version, its library call (or, for B4, the plain layers of
   ``off``) and its bound (B2 at each of the step's seven launches with
   its grouping's device time, each device op, the host's µs a call and
   the library's deterministic route for its function, and no sort
   kernel among the ops of a table up to ``ROW_LIMIT`` rows; B1 for the
   pooled and the iid draw; B1 and B3 beside an empty kernel's time);
12. the ``Trainer`` on config A as shipped (autotuned steps per dispatch,
   the device epoch pipeline, three mid-epoch checkpoints an epoch): two
   epochs and ``validate``, each with its seconds and examples/s, B1,
   B2, B3, B4f and B4b counted through it; a second ``Trainer`` resumes
   the first mid-epoch checkpoint and finishes the epoch with params and
   Adam state equal bit for bit to the uninterrupted run's; a copy of
   that checkpoint with a JAX key as its rng leaf loads and warns;
13. the quality gate through the port's CLI (``python -m
   ncf_tpu_torch.cli``): the ``indep40`` recipe of
   ``scripts/seed_study.py`` (as overrides of ``advanced_ncf_ml1m.yaml``)
   at seed 0, ``train`` then ``evaluate --protocol full`` on the best
   checkpoint, whose sampled and full hr@10 must each lie within
   3 sd sqrt(1 + 1/N) of the reference's mean over its N seeds
   (``results/variance.jsonl``);
14. the HTTP API over the bigvocab server (between phases 4 and 5, while
   its weights are alive): ``RecommendationAPI`` through ``dispatch``
   under ``exact`` (B5) and ``int8`` (B6), single, temporal and
   64-customer answers equal to ``ModelServer``'s in the same call, the
   intelligence route with and without ``hour`` under
   ``set_impl("pallas")`` (B7), health, metrics and index refresh;
   ``ProductSearch`` over the 4M item embeddings at ``"auto"`` (B5),
   ``"pallas"`` (B8) and ``"segmented"`` (B9), B=64 and 1, held by
   ``compare_topk`` against the plain versions; the same API over
   loopback HTTP (single, batch, 64 concurrent POSTs, ``/demo``); p50
   and p99 of ``dispatch`` and HTTP for 1 and 64 customers beside
   ``ModelServer.recommend``'s, and ``find_neighbors``'s host and
   device ms (``api_json``);
15. the API at ML-1M width over phase 13's checkpoint with the feature
   store and ``exclude_purchased``, the CLI's ``score``, ``export
   --users`` (read back and searched), ``consolidate`` (served again)
   and ``demo --hour 9``, ``cli serve`` as a process of its own
   (start-up seconds, /health, one answer), and the API over the
   sequence config with histories (B4f, ``history_attention``;
   ``api_ml1m_json``).  Any 5xx or error record fails the run;
16. big-vocabulary training at the full width of
   ``configs/advanced_ncf_bigvocab.yaml`` (12M users x 4M items, batch
   16,384, bf16, rowwise Adagrad, K 8) on seeded id batches: one sparse
   step against one dense rowwise-Adagrad step from the same state with
   the same negatives, dropout 0 and ``embedding_weight_decay`` 0 (each
   leaf's change within ``BIG_STEP_TOL``, rows no id touches equal bit for
   bit); the sparse combine through B2's grouped entry (one launch, no
   second sort) equal bit for bit to its former B2 call over each
   occurrence's segment, on the step's user and item ids and a skewed
   draw; two runs of 16 sparse steps from one state end in equal bits;
   the loss falls over 30 dispatches of 8 steps, each step launching B1,
   B2 (seven times: the five small tables and the two combines), B3, B4f
   and B4b; host ms a step (median of five windows), device ms, its top
   device kernels, busy share, examples/s and peak memory for the sparse
   and the dense rowwise path; B1's iid draw over the 4M-entry CDF equal
   to its plain version and timed beside the ML-1M draw;
17. ``python -m ncf_tpu_torch.cli train`` on the bigvocab config at
   300,000 x 100,000 (precompute off, sparse ``auto``, one epoch,
   ``validate``, a checkpoint every 3 dispatches), the training kernels
   counted through it; a ``Trainer`` resumes its first mid-epoch
   checkpoint and ends the epoch in the bits of the CLI's last
   checkpoint, generator included;
18. the parallel layer (``ncf_tpu_torch/parallel``), each mesh phase as
   fresh rank processes sharing the card over gloo (collectives staged
   through host memory), the kernels built once before: ``dryrun_multichip(4)``
   on the meshes (1, 4) and (2, 2), every sharded result held to the
   one-rank result on the card, every token printed;
19. sharded serving at full width: the bigvocab catalog (4M x 64, seeded)
   split over 2 ranks, B 1 and 64, through ``sharded_topk_scores`` (B5,
   B8) and ``sharded_topk_scores_prepared`` (B5, and B6 over one global
   quantization), ties planted across the shard boundary: ids equal to
   the single-device answer on rank 0; each rank's local-pass device ms
   and the merge's host ms;
20. sharded training at full width: ``advanced_ncf_ml25m_sharded.yaml``
   (tables padded to 162,542 x 62,424 so they shard), global batch
   32,768, mesh (1, 2), in f32: 3 steps with dropout 0, every leaf of
   the params and of the Adam moments within 5e-5 of its largest of the
   one-rank steps'; one step with the config's dropout on the plain
   layers, the moments (the gradients) held so (one run stands for both
   ``embedding_exchange`` settings: the port reads the setting nowhere
   and routes every sharded table through the exchange); the
   shipped bf16 config timed (B4f/B4b under the mesh); the bigvocab
   sparse step at 12M x 4M over (1, 2) against the one-rank step from
   one state, clip on and off (untouched rows bit-equal, touched rows
   and accumulators within 1e-6 of their change, equal bits reported);
   two runs of 8 mesh steps in equal bits; host and device ms, busy
   share and peak memory a rank;
21. ``python -m torch.distributed.run --nproc-per-node 2 -m
   ncf_tpu_torch.cli train`` on the ML-25M sharded config (synthetic,
   one epoch): its ``validate`` equal to the ranks of the mesh evaluator
   on its checkpoint, those held to the single-device evaluator's under
   the near-tie rule; the sharded checkpoint consolidated bit for bit and
   restored on one process; a mid-epoch resume over 2 ranks ending in the
   checkpoint's bits; one step over a (1, 1) mesh on NCCL equal bit for
   bit to the step given no mesh.

22. the host tools: ``build_warehouse`` at ML-1M's 6,040 users and 3,706
   items (20 stores, 60 days) on the host, each table's rows counted and
   1,000 of each held to its schema; the ``Trainer`` on that log
   (``advanced_ncf_ml1m.yaml`` as shipped, sized to the log, one step a
   dispatch): one epoch
   with B1, B2 (seven a step), B3, B4f and B4b counted, the loss falling,
   ``validate`` and a best checkpoint; 20 bare steps timed by the host
   clock up to one closing ``torch.cuda.synchronize()``, then three more
   inside ``profiling.trace``, the written Chrome trace holding their
   ``step`` spans and a device event of each training kernel by its
   symbol; the
   ``monitoring`` alerts over the ``Trainer``'s records (``low-hr10``
   fires exactly when hr@10 < 0.3), the API over the best checkpoint (64
   single customers and ``_api_requests``) and ``build_dashboard`` over
   its records, its latency p50/p99 equal to the records', no errors;
   ``doctor``'s ``compile`` check (B7 bit for bit), then four ``python
   -m ncf_tpu_torch.cli doctor`` processes at once: the ML-1M config (rc
   0), the bigvocab config at 12M x 4M (rc 0, its estimate of
   16,733,130,752 bytes), the ML-25M config with ``mesh.enable=on`` (rc
   1: one process is one rank) and ``model.negative_samples=0`` (rc 1).
   It runs after phase 17 and before the mesh phases.

    python3 chip_smoke.py --mesh-only   # the kernels, then phases 18-21

    python3 chip_smoke.py --tools-only  # the kernels, then phase 22

    python3 chip_smoke.py --tower-only  # the kernels, then B4f and B4b alone

(their registers and spills, tensor-core instructions, cases against the
plain version, two runs in equal bits, times at the five tower shapes.)

    python3 chip_smoke.py --hstu-only  # the kernels, then phase H alone

(HSTU's attention, H1, at the HSTU cell's shapes: a packed batch of
262,144 target positions with histories of 512-8,192 against the plain
version, forward and every gradient, two backward runs in equal bits,
its times beside the plain version's and the bound; three steps of
``ncf_tpu_torch/configs/hstu_large_retail4m.yaml`` at 4M items on the
main path with H1's launches counted, 8 forwards and 8 backwards a
step; that configuration through ``cli train`` at 2,000 users.  The
default run takes phase H after phase 17.)

    python3 chip_smoke.py --scatter-only  # the kernels, then B2 alone

(B2's cases against the plain version, its times at the step's seven
launches; with ``--scatter-ab DIR`` instead, then those times with the
package of the tree unpacked at DIR and with this one, in turns: DIR,
this, this, DIR, each a process of its own, every result equal in all.)

    python3 chip_smoke.py --gather-only  # the kernels, then B7 alone

(B7's ptxas registers and spills, its cases against the plain version,
NCF/NeuMF serving through it, its times at the three serving shapes.)

    python3 chip_smoke.py --gate   # builds the kernels, then only the gate

runs every recipe (``indep40``, ``indep_seq``, ``joint`` at 24 epochs)
at its reference seed count and holds each mean within
3 sqrt(sd_ref^2/N_ref + sd_port^2/N_port) of the reference's, then the
``bigvocab`` recipe; ``--gate=bigvocab`` runs that recipe alone: the
bigvocab config at 9M x 3M (the log must hold the reference's
31,768,738 interactions) through the CLI for six epochs, each epoch's
hr@10 printed beside the reference's, the best within 0.02 of its 0.7961
(give the chip call ``--timeout 1800``).

Without a card, or run alone in a directory without the package, it
prints why on standard output and standard error and exits 2.

The last two lines of standard output are the ``kernels`` JSON object and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
NEG_INF = -3.0e38
PEAK_BYTES_S = 3.35e12                  # H100 SXM HBM3
PEAK_FLOP_S = {"float32": 67e12,        # CUDA-core f32
               "bfloat16": 989e12,      # dense bf16 tensor cores
               "tf32": 495e12}          # dense TF32 tensor cores
# int32 instructions a second: 64 INT32 lanes an SM against the 128 f32
# lanes (two operations each) behind the 67 TFLOP/s, so a quarter of it
PEAK_INT32_S = 67e12 / 4
# integer instructions of one Philox4x32-10 draw (ten rounds of two
# multiplies high and low, four xors and two key adds), counted from the
# kernel's source
PHILOX_OPS = 100
# B5's and B8's times as CUDA-core kernels, before the tensor-core tile
# replaced them (CUDA events, ms; NVIDIA H100 80GB HBM3, 700 W), printed
# beside this run's
CUDA_CORE_MS = {("topk_scores_streaming", 64, 4_000_000, "float32"): 2.470,
          ("topk_scores_streaming", 1, 4_000_000, "float32"): 0.730,
          ("topk_scores_streaming", 1024, 1_000_000, "bfloat16"): 9.451,
          ("topk_scores_pallas", 64, 4_000_000, "float32"): 9.002}
# B6 (__dp4a on the CUDA cores), B3, B9, B4f and B4b before their
# redesigns: (CUDA-event ms, profiler device ms), NVIDIA H100 80GB HBM3,
# 700 W; printed beside this run's
EARLIER_MS = {("topk_scores_streaming_int8", 64): (2.365, 1.820),
              ("topk_scores_streaming_int8", 1): (0.778, 0.553),
              # B3 with a warp an example and 4-byte accesses
              ("fused_lookup_sum", "step"): (0.0337, 0.00314),
              # B9 on the CUDA cores (f32 FMAs)
              ("topk_scores_segmented", 64): (1.753, 1.747),
              # B4f and B4b on the CUDA cores (f32 FMAs), PR 7's run
              ("fused_tower_fwd", "[16384, 96]"): (0.2676, 0.2197),
              ("fused_tower_fwd", "[81920, 96]"): (1.1807, 0.9924),
              ("fused_tower_fwd", "[81920, 160]"): (1.4215, 1.2012),
              ("fused_tower_bwd", "[16384, 96]"): (0.7445, 0.6578),
              ("fused_tower_bwd", "[81920, 96]"): (3.4585, 3.2353),
              ("fused_tower_bwd", "[81920, 160]"): (7.5610, 7.1538)}
# kernel -> (its source, the TPU kernel it replaces)
KERNELS = {
    "topk_scores_streaming": ("ncf_tpu_torch/ops/csrc/topk_streaming.cu",
                              "ncf_tpu/ops/topk.py:447"),
    "fused_tower_fwd": ("ncf_tpu_torch/ops/csrc/fused_tower.cu",
                        "ncf_tpu/ops/pallas_tower.py:306"),
    "fused_tower_bwd": ("ncf_tpu_torch/ops/csrc/fused_tower.cu",
                        "ncf_tpu/ops/pallas_tower.py:325"),
    "tree_sample_negatives": ("ncf_tpu_torch/ops/csrc/tree_sampler.cu",
                              "ncf_tpu/ops/pallas_sampler.py:164"),
    "onehot_scatter_add": ("ncf_tpu_torch/ops/csrc/scatter_add.cu",
                           "ncf_tpu/ops/pallas_scatter.py:185"),
    "fused_lookup_sum": ("ncf_tpu_torch/ops/csrc/temporal_sum.cu",
                         "ncf_tpu/ops/pallas_temporal.py:94"),
    "topk_scores_streaming_int8": (
        "ncf_tpu_torch/ops/csrc/topk_streaming_int8.cu",
        "ncf_tpu/ops/topk.py:841"),
    "gather_rows": ("ncf_tpu_torch/ops/csrc/gather.cu",
                    "ncf_tpu/ops/pallas_embedding.py:144"),
    "topk_scores_pallas": ("ncf_tpu_torch/ops/csrc/topk_exact.cu",
                           "ncf_tpu/ops/topk.py:161"),
    "topk_scores_segmented": ("ncf_tpu_torch/ops/csrc/topk_segmax.cu",
                              "ncf_tpu/ops/topk.py:993"),
    # H1: HSTU is the port's alone, so no Pallas kernel is replaced
    "hstu_attn_fwd": ("ncf_tpu_torch/ops/csrc/hstu_attention.cu", None),
    "hstu_attn_bwd": ("ncf_tpu_torch/ops/csrc/hstu_attention.cu", None),
}
ML1M = os.path.join(ROOT, "configs", "advanced_ncf_ml1m.yaml")
QUALITY = os.path.join(ROOT, "configs", "advanced_ncf_quality.yaml")
SEQUENCE = os.path.join(ROOT, "configs", "advanced_ncf_sequence.yaml")
TRAIN_STEPS = 30          # per sampler x candidate mode, and per config B
CAUSAL_STEPS = 5
# the tower's input at the training steps: (rows, width) for config A
# joint, A independent and B independent
TOWER_SHAPES = ((16384, 96), (81920, 96), (81920, 160))
# the tower's input in the benchmark's training cells (ML-1M at batch
# 524,288, the sparse bigvocab step at 262,144)
CELL_TOWER_SHAPES = ((524288, 96), (262144, 96))
# B4b before its redesign for 16 warps an SM (one 8-warp block an SM on
# 64-row tiles, split-TF32 dW and dh): CUDA-event ms, NVIDIA H100 80GB HBM3,
# 700 W
B4B_BEFORE_MS = {"[16384, 96]": 0.3567, "[81920, 96]": 1.5546,
                 "[81920, 160]": 1.8224, "[524288, 96]": 9.2638,
                 "[262144, 96]": 4.6886}
TOWER_HIDDEN = [256, 128, 64]


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------- helpers

def cuda_ms(fn, iters, warmup=2):
    """Mean device time of ``fn`` over ``iters`` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_profile(fn, iters, top=6, width=60):
    """Device kernels during ``iters`` calls of ``fn`` (torch.profiler):
    {kernel name: ms per call} of the ``top`` kernels with the most device
    time (names cut to ``width``) and their launches per call, the device
    time and the number of device
    operations per call, the share of the window's wall time with a kernel
    running (kernels run on one stream, so their times add up without
    overlap), and the host operations with the most self time per call.
    The profiler's own cost is inside the window.  Returns None, with the
    reason printed, where the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        per, count, n_ops = {}, {}, 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us()
                count[e.name] = count.get(e.name, 0) + 1
                n_ops += 1
        host = sorted((a for a in prof.key_averages()
                       if a.device_type == DeviceType.CPU),
                      key=lambda a: -a.self_cpu_time_total)[:6]
    except Exception as e:  # noqa: BLE001 — the profiler is optional here
        log(f"profile: not measured ({e!r})")
        return None
    if not per:
        log("profile: not measured (the trace holds no device time)")
        return None
    busy = sum(per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_share": busy / wall_us,
            "device_ms_per_call": busy / 1e3 / iters,
            "device_ops_per_call": n_ops / iters,
            "kernels_ms_per_call": {n[:width]: us / 1e3 / iters
                                    for n, us in top},
            "kernels_launches_per_call": {n[:width]: count[n] / iters
                                          for n, _ in top},
            "host_self_ms_per_call": {
                a.key[:60]: [a.self_cpu_time_total / 1e3 / iters,
                             a.count / iters] for a in host}}


def device_split(fn, iters=20, tries=3, top=6):
    """(device ms per call, {device op: ms per call}) of ``fn`` from the
    profiler (kernels and memsets, without the host's launch gaps; the
    ``top`` ops with the most time), or (None, None) where not measured.
    A short window's trace sometimes comes back without its device
    records, so it is taken again."""
    for _ in range(tries):
        prof = device_profile(fn, iters, top=top)
        if prof is not None:
            return prof["device_ms_per_call"], prof["kernels_ms_per_call"]
    return None, None


def exact_scores(q, table, bias, ids, cast_q=True):
    """f64 scores and the magnitude sum sum_d |q_d v_d| of ``ids`` [B, k]
    (q is cast to the table's type first where the kernel does so)."""
    import torch

    qd = (q.to(table.dtype) if cast_q else q).double()
    rows = table[ids.long()].double()                       # [B, k, D]
    prod = qd[:, None, :] * rows
    s = prod.sum(-1)
    if bias is not None:
        s = s + bias.double()[ids.long()]
    return s, prod.abs().sum(-1)


def compare_topk(kv, ki, rv, ri, q, table, bias, what, cast_q=True):
    """Hold (kv, ki) against (rv, ri).  Tolerance per slot: 1e-5 * sum|q.v|
    + 1e-6 (f32 sums in another order).  Ids must be equal wherever the
    exact scores of the two rivals differ by more than that.  Returns
    (max |kv - rv| over filled slots, near-tie id swaps)."""
    import torch

    kvalid, rvalid = kv > NEG_INF, rv > NEG_INF
    check(torch.equal(kvalid, rvalid), f"{what}: empty slots differ")
    check(torch.equal(ki[~kvalid], ri[~rvalid]), f"{what}: empty-slot ids")
    if not bool(kvalid.any()):
        return 0.0, 0
    sk, mk = exact_scores(q, table, bias, ki, cast_q)
    sr, mr = exact_scores(q, table, bias, ri, cast_q)
    tol = 1e-5 * torch.maximum(mk, mr) + 1e-6
    v = kvalid
    check(bool(((kv.double() - sk).abs() <= tol)[v].all()),
          f"{what}: kernel values are not its ids' scores")
    err = (kv.double() - rv.double()).abs()
    check(bool((err <= tol)[v].all()),
          f"{what}: values differ beyond tolerance (max {float(err[v].max())})")
    swap = (ki != ri) & v
    check(bool(((sk - sr).abs() <= tol)[swap].all()),
          f"{what}: ids differ where the scores are not tied")
    return float(err[v].max()), int(swap.sum())


def tf32_rna(x):
    """``x`` (f32 or bf16) rounded to TF32 as the tensor cores' ``cvt.rna``
    rounds it: 10 mantissa bits, to nearest, ties away from zero."""
    import torch

    i = x.to(torch.float32).contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


# ------------------------------------------------------------- phases

def phase_kernel_vs_plain(torch, topk):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    cases, worst, swaps = 0, 0.0, 0
    for I in (100_003, 1_000_000):
        t32 = torch.randn((I, 64), generator=gen, device=dev)
        b = torch.randn((I,), generator=gen, device=dev)
        for B in (1, 7, 64, 1024):
            q = torch.randn((B, 64), generator=gen, device=dev)
            for table in (t32, t32.to(torch.bfloat16)):
                for bias in (b, None):
                    for seg_width, seg_top in ((128, 2), (64, 1)):
                        for k in (1, 10, 64):
                            args = dict(k=k, bias=bias, seg_width=seg_width,
                                        seg_top=seg_top)
                            kv, ki = topk.topk_scores_streaming(q, table, **args)
                            torch.cuda.synchronize()
                            rv, ri = topk.topk_scores_streaming_ref(
                                q, table, **args)
                            what = (f"I={I} B={B} {table.dtype} bias="
                                    f"{bias is not None} seg={seg_width}/"
                                    f"{seg_top} k={k}")
                            e, s = compare_topk(kv, ki, rv, ri, q, table,
                                                bias, what)
                            worst, swaps, cases = max(worst, e), swaps + s, cases + 1
        del t32, b
    # tied scores (small integers: exact in both) and empty slots: ids
    # must equal the plain version's, which keeps the reference's order
    for I, k, seg in ((100_003, 64, (128, 2)), (20_000, 40, (64, 1)),
                      (1_000, 64, (128, 1))):
        t = torch.randint(-1, 2, (I, 16), generator=gen, device=dev).float()
        b = torch.randint(0, 2, (I,), generator=gen, device=dev).float()
        b[:I // 3] = NEG_INF                    # empty segments
        q = torch.randint(-1, 2, (64, 16), generator=gen, device=dev).float()
        args = dict(k=k, bias=b, seg_width=seg[0], seg_top=seg[1])
        kv, ki = topk.topk_scores_streaming(q, t, **args)
        torch.cuda.synchronize()
        rv, ri = topk.topk_scores_streaming_ref(q, t, **args)
        check(torch.equal(kv, rv) and torch.equal(ki, ri),
              f"tied/empty I={I} k={k} seg={seg}: kernel != plain version")
        cases += 1
    log(f"kernel_vs_plain: topk_scores_streaming {cases} cases ok, "
        f"max_abs_err {worst!r}, near-tie id swaps {swaps}")
    _tile_independence(torch, topk, gen)
    return worst


def _tile_independence(torch, topk, gen):
    """B5 and B8 (tensor-core tiles of 8 to 64 users): a user's answer is
    bit for bit the same alone, in a batch of 17 and in one of 64, and
    from one call to the next."""
    dev = torch.device("cuda")
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        table = torch.randn((1_000_003, 64), generator=gen, device=dev).to(
            dtype)
        bias = torch.randn((table.shape[0],), generator=gen, device=dev)
        q = torch.randn((64, 64), generator=gen, device=dev)
        prep = topk.prepare_items(table, bias, seg_width=128)
        for name, call in (
                ("B5", lambda x: topk.topk_scores_streaming(x, prep, k=10)),
                ("B8", lambda x: topk.topk_scores_pallas(x, table, 10, bias))):
            batch, again, part = call(q), call(q), call(q[40:57])
            check(all(torch.equal(a, b) for a, b in zip(batch, again)),
                  f"{name} {dtype}: two calls differ")
            for u in (0, 40, 56, 63):
                alone = call(q[u:u + 1])
                same = [torch.equal(a[0], b[u]) for a, b in zip(alone, batch)]
                if 40 <= u < 57:
                    same += [torch.equal(a[u - 40], b[u])
                             for a, b in zip(part, batch)]
                check(all(same), f"{name} {dtype}: user {u} alone differs "
                      "from the batch")
            n += 1
        del table, bias, prep
    torch.cuda.empty_cache()
    log(f"kernel_vs_plain: B5 and B8 batch independence and run to run "
        f"({n} kernel x dtype cases) ok")


def _reference(scorer, uids, mod, bias, fetch):
    """Exact top-``fetch`` on the card (a dense product + torch.topk)."""
    import torch

    q = scorer.user_queries[torch.as_tensor(uids, device=scorer.device).long()]
    if mod is not None:
        q = q * mod[None, :]
    scores = q @ scorer.item_vecs.T + bias[None, :]
    v, i = torch.topk(scores, fetch, dim=1)
    return q, v, i.to(torch.int32)


def _check_served(scorer, uids, got_scores, got_ids, k, mod=None, bias=None,
                  exclude=None, exact=True, what=""):
    """Served (sigmoid scores, ids) against the exact top-k.  Returns
    (hits, total) for recall."""
    import numpy as np
    import torch

    fetch = k if exclude is None else k + exclude.shape[1]
    q, rv, ri = _reference(scorer, uids, mod, bias, fetch)
    rv, ri = rv.cpu().numpy(), ri.cpu().numpy()
    if exclude is not None:
        keep_v, keep_i = [], []
        for r in range(len(uids)):
            m = ~np.isin(ri[r], exclude[r])
            keep_v.append(rv[r][m][:k])
            keep_i.append(ri[r][m][:k])
        rv, ri = np.stack(keep_v), np.stack(keep_i)
    got_ids = np.asarray(got_ids).reshape(len(uids), -1)
    got_scores = np.asarray(got_scores).reshape(len(uids), -1)
    hits = sum(len(set(got_ids[r]) & set(ri[r])) for r in range(len(uids)))
    if exact:
        table = scorer.item_vecs
        gi = torch.as_tensor(got_ids, device=table.device)
        sg, mg = exact_scores(q, table, bias, gi)
        sr, mr = exact_scores(q, table, bias,
                              torch.as_tensor(ri, device=table.device))
        tol = (1e-5 * torch.maximum(mg, mr) + 1e-6).cpu().numpy()
        gap = (sg - sr).abs().cpu().numpy()
        swap = got_ids != ri
        check(bool((gap[swap] <= tol[swap]).all()),
              f"{what}: served ids are not the exact top-{k}")
        want = 1.0 / (1.0 + np.exp(-rv.astype(np.float64)))
        check(np.abs(got_scores - want).max() <= 1e-5,
              f"{what}: served scores differ from the exact ones")
    return hits, int(got_ids.size)


def bigvocab(torch, Config, advanced_ncf):
    """The bigvocab config at full width with seeded random weights:
    (cfg, params, dept, cat, rng)."""
    import numpy as np

    cfg = Config.from_yaml(os.path.join(ROOT, "configs",
                                        "advanced_ncf_bigvocab.yaml"))
    cfg.model.num_users = cfg.data.synthetic_users
    cfg.model.num_items = cfg.data.synthetic_items
    U, I = cfg.model.num_users, cfg.model.num_items
    rng = np.random.default_rng(0)
    dept = rng.integers(0, 9, I).astype(np.int32)
    cat = rng.integers(0, 30, I).astype(np.int32)
    cfg.model.num_departments, cfg.model.num_categories = 9, 30
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = advanced_ncf.init(gen, cfg.model)
    torch.cuda.synchronize()
    log(f"serving: init {U}x{I} params (mf/mlp {cfg.model.mf_dim}/"
        f"{cfg.model.mlp_dim}, tower {list(cfg.model.mlp_hidden_dims)}, "
        f"{cfg.model.compute_dtype}) in {time.perf_counter() - t0:.1f} s")
    return cfg, params, dept, cat, rng


def phase_serving(torch, topk, big, ModelServer):
    import numpy as np

    cfg, params, dept, cat, rng = big
    U, I = cfg.model.num_users, cfg.model.num_items
    launches = topk.topk_scores_streaming.launches
    latency = {}
    temporal = {"hour": 18, "day": 4, "month": 11, "day_of_year": 320}
    users = rng.choice(U, size=64, replace=False).astype(np.int32)
    launches.reset()
    for preset in ("exact", "fast"):
        cfg.serving.retrieval = preset
        t0 = time.perf_counter()
        server = ModelServer(cfg, params=params, item_dept=dept,
                             item_cat=cat, device="cuda")
        scorer = server.scorer
        exact = preset == "exact"
        hits = total = 0

        def served(fn, what):
            n0 = launches.value
            out = fn()
            check(launches.value > n0, f"{preset} {what}: kernel not launched")
            return out

        try:
            bias0 = scorer.item_bias(None)
            bias_t = scorer.item_bias(temporal)
            torch.cuda.synchronize()
            log(f"serving[{preset}]: server + biases ready in "
                f"{time.perf_counter() - t0:.1f} s")
            u = int(users[0])
            s, i, _ = served(lambda: server.recommend(u, k=10), "recommend")
            h, n = _check_served(scorer, [u], s, i, 10, bias=bias0,
                                 exact=exact, what="recommend")
            hits, total = hits + h, total + n
            s, i, _ = served(lambda: server.recommend(u, k=10,
                                                      temporal=temporal),
                             "temporal")
            h, n = _check_served(scorer, [u], s, i, 10, bias=bias_t,
                                 exact=exact, what="temporal")
            hits, total = hits + h, total + n
            seen = rng.choice(I, size=50, replace=False).astype(np.int32)
            _, top, _ = server.recommend(u, k=60)     # make some exclusions bite
            seen[:5] = top[:5]
            s, i, _ = served(lambda: server.recommend(
                u, k=10, exclude_items=seen.tolist()), "exclusion")
            check(not set(seen.tolist()) & set(i.tolist()),
                  "exclusion: an excluded item was served")
            h, n = _check_served(scorer, [u], s, i, 10, bias=bias0,
                                 exclude=seen[None, :], exact=exact,
                                 what="exclusion")
            hits, total = hits + h, total + n
            s, i, _ = served(lambda: server.recommend_hourly(u, hour=8, k=10),
                             "hourly")
            h, n = _check_served(scorer, [u], s, i, 10,
                                 mod=scorer._hour_mod(8),
                                 bias=scorer._hourly_item_bias(8),
                                 exact=exact, what="hourly")
            hits, total = hits + h, total + n
            s, i, _ = served(lambda: server.recommend_batch(users, k=10),
                             "batch")
            h, n = _check_served(scorer, users, s, i, 10, bias=bias0,
                                 exact=exact, what="batch")
            hits, total = hits + h, total + n

            results, errors = {}, []
            barrier = threading.Barrier(len(users))

            def call(uid):
                try:
                    barrier.wait(timeout=60)
                    results[uid] = server.recommend(uid, k=10)[:2]
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(repr(e))

            n0 = launches.value
            threads = [threading.Thread(target=call, args=(int(x),))
                       for x in users]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            check(not errors and not any(t.is_alive() for t in threads),
                  f"coalesced requests failed: {errors[:3]}")
            check(launches.value > n0, "coalesced: kernel not launched")
            c = server._coalescer
            s = np.stack([results[int(x)][0] for x in users])
            i = np.stack([results[int(x)][1] for x in users])
            h, n = _check_served(scorer, users, s, i, 10, bias=bias0,
                                 exact=exact, what="coalesced")
            hits, total = hits + h, total + n
            log(f"serving[{preset}]: 64 threads -> {c.batched_calls} batched "
                f"calls, {c.direct_calls} direct, kernel launches "
                f"{launches.value - n0}")

            recall = hits / total
            check(recall >= 0.999, f"{preset} recall@10 {recall} < 0.999")
            log(f"serving[{preset}]: answers ok, recall@10 {recall!r} over "
                f"{total // 10} requests' rows")

            one = [server.recommend(int(users[j % 64]), k=10)[2]
                   for j in range(40)]
            many = [server.recommend_batch(users, k=10)[2] for _ in range(20)]
            latency[preset] = {"p50_ms_1_user": float(np.median(one)),
                               "p50_ms_64_users": float(np.median(many))}
            log(f"serving[{preset}]: p50 latency 1 user "
                f"{latency[preset]['p50_ms_1_user']!r} ms, 64 users "
                f"{latency[preset]['p50_ms_64_users']!r} ms")
            for n_users, fn in (
                    (1, lambda: server.recommend(int(users[1]), k=10)),
                    (64, lambda: server.recommend_batch(users, k=10))):
                prof = device_profile(fn, 20)
                if prof is not None:
                    log("profile_json: " + json.dumps(
                        {"what": f"serving[{preset}] {n_users} user(s)",
                         **prof}))
        finally:
            server.close()
        del server, scorer
        torch.cuda.empty_cache()
    main_launches = launches.value
    check(main_launches > 0, "the serving path never launched the kernel")
    torch.cuda.empty_cache()
    return main_launches, latency


def _passes(split, first):
    """{"score": ms, "merge": ms} per call from a profiler split: the
    kernel whose name holds ``first`` is the scoring/select pass, the one
    holding "merge" the merge pass."""
    if split is None:
        return None
    return {"score": sum(v for n, v in split.items() if first in n),
            "merge": sum(v for n, v in split.items() if "merge" in n)}


def _tc_bounds(nbytes, B, I, D, dtype):
    """B5's and B8's bounds on the route they take: bytes against three
    TF32 products (f32 tables) or one bf16 product (bf16), and against
    the f32 FMA rate of the CUDA cores (their earlier route)."""
    flops = 2.0 * B * I * D
    bound, by = (_bound(nbytes, 3 * flops, PEAK_FLOP_S["tf32"])
                 if dtype == "float32"
                 else _bound(nbytes, flops, PEAK_FLOP_S["bfloat16"]))
    return {"bound_ms": bound, "bound_by": by,
            "bound_f32_fma_ms": _bound(nbytes, flops,
                                       PEAK_FLOP_S["float32"])[0]}


def _time_shape(torch, topk, B, I, dtype, iters):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(B + I)
    table = torch.randn((I, 64), generator=gen, device=dev).to(dtype)
    bias = torch.randn((I,), generator=gen, device=dev)
    q = torch.randn((B, 64), generator=gen, device=dev).to(dtype)
    prep = topk.prepare_items(table, bias, seg_width=128)
    k = 10
    call = functools.partial(topk.topk_scores_streaming, q, prep, k=k)
    kernel = cuda_ms(call, iters)
    plain = cuda_ms(lambda: topk.topk_scores_streaming_ref(q, prep, k=k), 3,
                    warmup=1)

    def lib():
        return torch.topk(q @ table.T + bias, k)

    library = cuda_ms(lib, 5)
    dev_ms, split = device_split(call)
    nbytes = (q.numel() * q.element_size() + table.numel()
              * table.element_size() + bias.numel() * 4 + B * k * 8)
    name = str(dtype).replace("torch.", "")
    row = {"B": B, "I": I, "D": 64, "dtype": name,
           "k": k, "seg": "128/2", "ms": kernel, "device_ms": dev_ms,
           "device_passes_ms": _passes(split, "seg_topk"),
           "cuda_core_ms": CUDA_CORE_MS.get(
               ("topk_scores_streaming", B, I, name)),
           "plain_ms": plain, "library_ms": library,
           "library_device_ms": device_split(lib)[0],
           **_tc_bounds(nbytes, B, I, 64, name)}
    del table, bias, q, prep
    torch.cuda.empty_cache()
    return row


def phase_timing(torch, topk):
    rows = [_time_shape(torch, topk, 64, 4_000_000, torch.float32, 20),
            _time_shape(torch, topk, 1, 4_000_000, torch.float32, 20),
            _time_shape(torch, topk, 1024, 1_000_000, torch.bfloat16, 10)]
    for r in rows:
        log(f"timing: topk_scores_streaming B={r['B']} I={r['I']} "
            f"{r['dtype']} kernel {r['ms']!r} ms (CUDA-core version: "
            f"{r['cuda_core_ms']!r} ms; "
            f"device {r['device_ms']!r} ms, by pass "
            f"{json.dumps(r['device_passes_ms'])}), plain {r['plain_ms']!r} "
            f"ms, library {r['library_ms']!r} ms (device "
            f"{r['library_device_ms']!r} ms), bound {r['bound_ms']!r} ms "
            f"({r['bound_by']}; f32 FMA {r['bound_f32_fma_ms']!r} ms)")
    log("timing_json: " + json.dumps(rows))
    return rows


def phase_demo(torch, Config, ModelServer):
    import numpy as np

    cfg = Config()
    # f32 compute: the two devices then differ only in summation order
    cfg.model.compute_dtype = "float32"
    cfg.serving.coalesce_requests = False
    rng = np.random.default_rng(0)
    dept = rng.integers(0, 9, cfg.model.num_items).astype(np.int32)
    cat = rng.integers(0, 30, cfg.model.num_items).astype(np.int32)
    demo = os.path.join(ROOT, "demo", "checkpoint")
    gpu = ModelServer.from_checkpoint(cfg, demo, device="cuda",
                                      item_dept=dept, item_cat=cat)
    cpu = ModelServer.from_checkpoint(cfg, demo, device="cpu",
                                      item_dept=dept, item_cat=cat)
    users = rng.choice(cfg.model.num_users, 64, replace=False)
    temporal = {"hour": 9, "day": 2, "month": 5, "day_of_year": 140}
    calls = [("plain", lambda s: s.scorer.topk_for_users(users, k=10)),
             ("temporal", lambda s: s.scorer.topk_for_users(
                 users, k=10, temporal=temporal)),
             ("hourly", lambda s: s.scorer.topk_for_users_hourly(
                 users, hour=8, k=10))]
    for name, fn in calls:
        (gs, gi), (cs, ci) = fn(gpu), fn(cpu)
        check(np.array_equal(gi, ci), f"demo {name}: ids differ from the CPU")
        check(np.abs(gs - cs).max() <= 1e-5,
              f"demo {name}: scores differ from the CPU")
        check(np.isfinite(gs).all() and gs.shape == (64, 10),
              f"demo {name}: bad output")
    log(f"demo: {gpu.model_version} on the card equals the CPU answers "
        f"(64 users x plain/temporal/hourly)")


# ------------------------------------------------------ training kernels

def _cdf(torch, n, gen, zero_share=0.0, on_card=False):
    """An f32 CDF on the card, summed on the CPU in order as the port's
    ``make_sampling_cdf`` sums it (nondecreasing), or with ``on_card`` by
    the card's scan, which adds in another order; ``zero_share`` of the
    items, and the last 20, weigh nothing (runs of equal entries)."""
    w = torch.rand(n, generator=gen, device="cuda") + 1e-3
    if zero_share:
        w[torch.rand(n, generator=gen, device="cuda") < zero_share] = 0.0
        w[-20:] = 0.0
    c = torch.cumsum(w if on_card else w.cpu(), 0)
    return (c / c[-1]).cuda()


def _b1_edge_uniforms(torch, cdf, N, gen):
    """One round of N uniforms: a tenth on CDF entries, a tenth at or
    above cdf[-1], a seventh equal (duplicates), one NaN."""
    u = torch.rand(N, generator=gen, device="cuda")
    on = torch.randint(0, cdf.shape[0], (N // 10,), generator=gen,
                       device="cuda")
    u[:N // 10] = cdf[on]
    u[N // 10:N // 5] = cdf[-1] + u[N // 10:N // 5]
    u[-(N // 7 + 1):] = u[0]
    u[N // 2] = float("nan")
    return u


def _b1_cases(torch, sampler, gen, dev):
    """B1 bit for bit with the plain version: the step's draws (2 rounds
    with positives; the pooled draw of 65,536 sorted uniforms) over CDFs
    summed on the CPU and on the card, and the edge cases (zero-weight
    runs, uniforms on entries, clipped, NaN, duplicates, N of 65,536,
    9,999, 1,001 and 3; catalogs of 100 to 100,003 items, over the 12,288
    a block stages), sorted and unsorted uniforms.  A CDF summed on the
    card may fall by an ulp here and there, outside the kernel's contract:
    there the slots whose uniforms see it out of order
    (``sampler.ordered_for``) are left out and counted.  Returns (cases,
    entries where a CDF falls, slots left out, of them slots that
    differ)."""
    n = falls = left_out = differ = 0

    def same(u, pos, cdf, I, what):
        nonlocal left_out, differ
        B = pos.shape[0]
        NEG = u.shape[1] // B
        want = sampler.tree_sample_ref(
            u, pos[:, None].expand(B, NEG).reshape(-1), cdf, I)
        got = sampler.tree_sample_negatives(u, pos, cdf, I).reshape(-1)
        keep = sampler.ordered_for(u, cdf).all(0)
        torch.cuda.synchronize()
        check(torch.equal(got[keep], want[keep]),
              f"B1 {what}: kernel != plain version")
        left_out += int((~keep).sum())
        differ += int((got != want).sum())
        return 1

    for I in (100, 3706, 100_003):
        for on_card in (False, True):
            cdf = _cdf(torch, I, gen, on_card=on_card)
            falls += int((cdf[1:] < cdf[:-1]).sum())
            for R, B, NEG, no_pos in ((2, 16384, 4, False),
                                      (1, 65536, 1, True),
                                      (1, 16384, 4, False), (3, 999, 2, False)):
                u = torch.rand((R, B * NEG), generator=gen, device=dev)
                pos = (torch.full((B,), -1, dtype=torch.int32, device=dev)
                       if no_pos else
                       torch.randint(0, I, (B,), generator=gen, device=dev,
                                     dtype=torch.int32))
                for order in ("sorted", "unsorted"):
                    x = torch.sort(u, dim=1).values if order == "sorted" else u
                    n += same(x, pos, cdf, I, f"I={I} R={R} B={B} {order} "
                              f"cdf {'card' if on_card else 'cpu'}")
    for I in (1682, 3706, 20_000):
        cdf = _cdf(torch, I, gen, zero_share=0.3)
        for N in (65536, 9999, 1001, 3):
            u = _b1_edge_uniforms(torch, cdf, N, gen)
            pos = torch.full((N,), -1, dtype=torch.int32, device=dev)
            for order in ("sorted", "unsorted"):
                x = torch.sort(u).values if order == "sorted" else u
                n += same(x[None], pos, cdf, I, f"edges I={I} N={N} {order}")
    return n, falls, left_out, differ


def _scatter_cases(torch, scatter, gen, dev):
    """B2 in every mode and gradient dtype at the step's shapes (user and
    item tables, the vocabulary-level department and category tables, the
    temporal tables) and at edge shapes (no ids, every id out of range,
    one id 81,920 times, a Zipf skew over the item table), and in every
    mode at its routes' edges (``ROW_LIMIT`` rows and one more, n not a
    multiple of the chunk, int64 ids, runs of hundreds at D 200, the
    small tables' limits and one position past them): equal
    bit for bit to the plain version run on the CPU, and to a second
    call; the pre-grouped entry on ``torch.sort``'s grouping likewise."""
    def zipf(shape, rows):
        u = torch.rand(shape, generator=gen, device=dev)
        return (u.pow(-1.0 / 0.3) - 1.0).clamp(max=rows + 1).to(torch.int32)

    cases = [(rows, torch.randint(-3, rows + 3, shape, generator=gen,
                                  device=dev, dtype=torch.int32), d)
             for rows, shape, d in ((6040, (16384,), 128),
                                    (3706, (16384, 5), 128),
                                    (9, (3706,), 64), (30, (3706,), 64),
                                    (24, (16384,), 32), (7, (16384,), 32),
                                    (77, (1001, 3), 40), (3, (4096,), 200))]
    cases += [(3706, torch.zeros((0,), dtype=torch.int32, device=dev), 128),
              (3706, torch.randint(3706, 9000, (16384, 5), generator=gen,
                                   device=dev, dtype=torch.int32) *
               torch.tensor([1, -1, 1, -1, 1], dtype=torch.int32,
                            device=dev), 128),
              (3706, torch.full((16384, 5), 1234, dtype=torch.int32,
                                device=dev), 128),
              (3706, zipf((16384, 5), 3706), 128)]
    # the routes' edges, in one grads dtype: the row count at the counting
    # route's limit and one above (torch.sort), n not a multiple of the
    # chunk, int64 ids past 2^31, runs of hundreds at D 200, the small
    # tables' route at its limits and one position past them
    lim = scatter.ROW_LIMIT
    wide = torch.randint(-2, 6042, (16384,), generator=gen, device=dev)
    wide[::7] += 2 ** 32
    edges = [(lim, torch.randint(-2, lim + 2, (16384, 5), generator=gen,
                                 device=dev, dtype=torch.int32), 128),
             (lim + 1, torch.randint(-2, lim + 3, (16384, 5), generator=gen,
                                     device=dev, dtype=torch.int32), 128),
             (24, torch.randint(-1, 25, (3 * scatter.CHUNK + 77,),
                                generator=gen, device=dev), 32),
             (6040, wide, 128),
             (150, torch.randint(0, 150, (60000,), generator=gen,
                                 device=dev, dtype=torch.int32), 200),
             (scatter.SMALL_ROWS, torch.randint(
                 -1, scatter.SMALL_ROWS + 1, (scatter.SMALL_N,),
                 generator=gen, device=dev, dtype=torch.int32), 128),
             (7, torch.randint(0, 7, (scatter.SMALL_N + 1,), generator=gen,
                               device=dev, dtype=torch.int32), 32)]
    n = 0
    for k, (rows, ids, d) in enumerate(cases + edges):
        g32 = torch.randn(tuple(ids.shape) + (d,), generator=gen, device=dev)
        dtypes = ((torch.bfloat16, torch.float32) if k < len(cases) else
                  (torch.bfloat16,) if d == 128 else (torch.float32,))
        for dtype in dtypes:
            g = g32.to(dtype)
            for mode in scatter.MODES:
                got = scatter.onehot_scatter_add(ids, g, rows, mode=mode)
                again = scatter.onehot_scatter_add(ids, g, rows, mode=mode)
                want = scatter.scatter_add_ref(ids.cpu(), g.cpu(), rows, mode)
                torch.cuda.synchronize()
                what = (f"B2 rows={rows} ids {tuple(ids.shape)} {dtype} "
                        f"{mode}")
                check(torch.equal(got, again), f"{what}: differs between "
                      "two calls")
                check(torch.equal(got.cpu(), want),
                      f"{what}: kernel != plain version on the CPU")
                n += 1
    # the sparse combine's entry: torch.sort's grouping of ids with
    # duplicates and one run of 300
    for rows, nn in ((16384, 16384), (81920, 81920), (100, 4096)):
        ids = torch.randint(0, max(rows // 4, 1), (nn,), generator=gen,
                            device=dev)
        ids[:300] = 7
        g = torch.randn((nn, 64), generator=gen, device=dev)
        keys, order = torch.sort(ids, stable=True)
        got = scatter.scatter_add_grouped(order, keys, g, rows, mode="f32")
        want = scatter.scatter_add_ref(ids.cpu(), g.cpu(), rows, "f32")
        torch.cuda.synchronize()
        check(torch.equal(got.cpu(), want), f"B2 grouped rows={rows} "
              f"n={nn}: kernel != plain version on the CPU")
        n += 1
    return n


def _b3_cases(torch, temporal_sum, sinusoidal_table, gen, dev):
    """B3 bit for bit against its plain version: the step's tables, B of
    1, 3, 5, 4,097 and 16,384, K of 1 to 4, ids of -1, ``rows`` and far
    out of range, dt 32 (16-byte path) and 33 (one float a thread), tables
    one float off 16-byte alignment (one float a thread).  Returns the
    count of cases."""
    n = 0
    for dt, offset in ((32, 0), (33, 0), (32, 1)):
        tables = []
        for r in (24, 7, 12):
            flat = torch.randn(r * dt + offset, generator=gen, device=dev)
            tables.append(flat[offset:].view(r, dt))
        pe = sinusoidal_table(dt, device=dev)
        if offset:
            pe = torch.cat([pe.new_zeros(1), pe.reshape(-1)])[1:].view(
                pe.shape)
        tables.append(pe)
        for B in (1, 3, 5, 4097, 16384):
            for K in (1, 2, 3, 4):
                ts = tables[:K]
                ids = torch.stack([torch.randint(
                    0, t.shape[0], (B,), generator=gen, device=dev)
                    for t in ts]).to(torch.int32)
                ids[:, 0] = -1                   # each contributes 0
                if B > 1:
                    ids[:, 1] = torch.tensor([t.shape[0] for t in ts],
                                             device=dev, dtype=torch.int32)
                if B > 2:
                    ids[:, 2] = 2 ** 31 - 1
                    ids[K - 1, B // 2:] = -(2 ** 31)
                want = temporal_sum.lookup_sum_ref(ids, ts)
                got = temporal_sum._lookup_sum_cuda(ids, ts)
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"B3 dt={dt} offset={offset} B={B} K={K}: kernel != "
                      "plain version")
                n += 1
    # through the wrapper, as the step calls it, with and without the
    # out-of-range ids
    tables = [torch.randn((r, 32), generator=gen, device=dev)
              for r in (24, 7, 12)] + [sinusoidal_table(32, device=dev)]
    for B, bad in ((16384, False), (16384, True)):
        ids = torch.stack([torch.randint(0, t.shape[0], (B,), generator=gen,
                                         device=dev) for t in tables])
        if bad:
            ids[:, 0] = -1
            ids[:, 1] = 400
        got = temporal_sum.fused_lookup_sum(ids, tables)
        torch.cuda.synchronize()
        check(torch.equal(got, temporal_sum.lookup_sum_ref(ids, tables)),
              f"B3 B={B}: kernel != plain version")
        n += 1
    return n


def phase_training_kernels_vs_plain(torch):
    """B1, B2 and B3 against their plain versions at the step's shapes and
    at edge shapes, each equal bit for bit (B2 to its plain version run on
    the CPU).  Returns {kernel: max |kernel - plain|}."""
    from ncf_tpu_torch.models.temporal import sinusoidal_table
    from ncf_tpu_torch.ops import sampler, scatter, temporal_sum

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(99)
    errs = {"tree_sample_negatives": 0.0, "onehot_scatter_add": 0.0,
            "fused_lookup_sum": 0.0}
    n, falls, left_out, differ = _b1_cases(torch, sampler, gen, dev)
    log(f"kernel_vs_plain: tree_sample_negatives {n} cases equal bit for "
        f"bit, sorted and unsorted uniforms (the CDFs summed on the card "
        f"fall at {falls} entries; {left_out} slots see them out of order, "
        f"{differ} of those differ from the plain count)")
    t0 = time.perf_counter()
    n2 = _scatter_cases(torch, scatter, gen, dev)
    n += n2
    log(f"kernel_vs_plain: onehot_scatter_add {n2} cases equal bit for bit "
        f"to the plain version on the CPU and from call to call "
        f"({time.perf_counter() - t0:.1f} s)")
    n3 = _b3_cases(torch, temporal_sum, sinusoidal_table, gen, dev)
    n += n3
    log(f"kernel_vs_plain: fused_lookup_sum {n3} cases equal bit for bit")
    log(f"kernel_vs_plain: training kernels {n} cases ok, max_abs_err "
        f"{json.dumps(errs)}")
    return errs


def _short_name(mangled):
    """``tower_bwd_kernel<4>``, ``segmax_tc_kernel<bf16,64>``, ... from a
    mangled kernel name."""
    import re

    m = re.search(r"(tower_(?:fwd|bwd)_kernel)ILi(\d+)E", mangled)
    if m:
        return f"{m.group(1)}<{m.group(2)}>"
    m = re.search(r"(segmax_tc_kernel)I(f|13__nv_bfloat16)Li(\d+)E", mangled)
    if m:
        dtype = "f32" if m.group(2) == "f" else "bf16"
        return f"{m.group(1)}<{dtype},{m.group(3)}>"
    for name in ("tower_bwd_kernel_wprep", "reduce_partials"):
        if name in mangled:
            return name
    return mangled


def _sass(kernels, source):
    """Each kernel of the built library of ``source`` (by its short name):
    its HMMA (tensor-core) instructions in the SASS and the registers,
    stack, shared and local memory that ``cuobjdump -res-usage`` reports."""
    import re
    import shutil

    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump") or os.path.join(
        CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    lib = kernels._target(source)[1]
    runs = [subprocess.run([tool, flag, lib], capture_output=True, text=True,
                           timeout=120) for flag in ("-sass", "-res-usage")]
    check(all(r.returncode == 0 for r in runs),
          f"cuobjdump failed: {[r.stderr.strip() for r in runs]}")
    out, name = {}, None
    for line in runs[0].stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _short_name(m.group(1))
            out[name] = {"hmma": 0}
        elif name is not None and "HMMA" in line:
            out[name]["hmma"] += 1
    for m in re.finditer(r"Function (\S+):\s*\n\s*(REG:\d+ STACK:\d+ "
                         r"SHARED:\d+ LOCAL:\d+)", runs[1].stdout):
        out.setdefault(_short_name(m.group(1)), {})["usage"] = m.group(2)
    return out


def phase_sass(kernels):
    """Every instance of B4f and B4b (three tile heights each) and of B9
    must hold HMMA instructions, and B9's none spill to local memory."""
    tower = _sass(kernels, "fused_tower")
    towers = [k for k in tower if k.startswith("tower_") and "<" in k]
    check(len(towers) == 6 and all(tower[k].get("hmma", 0) > 0
                                   for k in towers),
          f"B4f/B4b without tensor-core instructions: {tower}")
    segmax = _sass(kernels, "topk_segmax")
    b9 = [k for k in segmax if k.startswith("segmax_tc_kernel")]
    check(len(b9) == 8 and all(segmax[k].get("hmma", 0) > 0 for k in b9),
          f"B9 without tensor-core instructions: {segmax}")
    check(all(segmax[k].get("usage", "").endswith("LOCAL:0") for k in b9),
          f"B9 spills to local memory: {segmax}")
    return tower, segmax


def _tower_layers(torch, d0, hidden, gen):
    """Tower params as ``mlp_tower_init`` draws them, with the LayerNorm
    scale and bias moved off (1, 0) so their gradients are general."""
    from ncf_tpu_torch.models.layers import mlp_tower_init

    layers = mlp_tower_init(gen, d0, hidden)
    for layer in layers:
        n = layer["norm"]["scale"].shape[0]
        layer["norm"]["scale"] += 0.1 * torch.randn(n, generator=gen,
                                                    device=gen.device)
        layer["norm"]["bias"] += 0.1 * torch.randn(n, generator=gen,
                                                   device=gen.device)
    return layers


def _tower_leaves(layers):
    return [l[a][b] for l in layers for a, b in (
        ("dense", "w"), ("dense", "b"), ("norm", "scale"), ("norm", "bias"))]


def _near_kink_rows(torch, tower, layers, x, rate):
    """Rows of ``x`` where the plain forward (with the masks the compare
    runs draw) has a pre-activation within 1e-5 of the row's largest from
    the ReLU's kink.  There a rounding-level difference between two f32
    sums can flip the ReLU: the row's output moves by that rounding, its
    gradient by the whole term."""
    dev = x.device
    if rate > 0.0:
        seed = torch.randint(0, 2 ** 31 - 1, (1,), device=dev,
                             dtype=torch.int32, generator=torch.Generator(
                                 device=dev).manual_seed(17))
    else:
        seed = torch.zeros((1,), dtype=torch.int32, device=dev)
    h = x.reshape(-1, x.shape[-1]).to(torch.bfloat16).float()
    near = torch.zeros(h.shape[0], dtype=torch.bool, device=dev)
    flat = [t.detach() for t in _tower_leaves(layers)]
    for i, (w, b, g, be) in enumerate(tower._layers(flat)):
        pre = torch.matmul(h, w.to(torch.bfloat16).float()) + b
        near |= (pre.abs() <= 1e-5 * pre.abs().amax(1, keepdim=True)).any(1)
        y, *_ = tower._layer_fwd(h, w, b, g, be, i, seed, rate)
        h = y.to(torch.bfloat16).float()
    return near


def _tower_compare(torch, tower, layers, x, rate, what):
    """B4f and B4b against ``fused_tower_ref`` on the same inputs and the
    same generator state.  Tolerances: identical dropout zeros; outputs
    within 1e-4 (relative, plus 1e-4) for at least 95% of the elements
    and within 5e-2 of the largest magnitude for all (f32 sums in another
    order; where two straddle a bf16 rounding boundary between layers,
    the rest of that row moves by up to ~1e-2, in a few percent of the
    rows at width 512).  The backwards are held on the rows whose outputs
    agree to 1e-5 (at least 90%) and whose pre-activations all lie more
    than 1e-5 of the row's largest from the ReLU's kink (``_near_kink_rows``;
    dy is zero elsewhere): each parameter gradient within 1e-4 of its
    largest magnitude, dx within one bf16 ulp plus 1e-4 of its largest
    magnitude.  Returns (max |out diff|, max |grad diff| over dx and the
    leaves)."""
    runs = []
    for fn in (tower.fused_tower, tower.fused_tower_ref):
        tracked = [{k: {n: t.detach().clone().requires_grad_(True)
                        for n, t in l[k].items()} for k in ("dense", "norm")}
                   for l in layers]
        xt = x.detach().clone().requires_grad_(True)
        gen = torch.Generator(device=x.device).manual_seed(17)
        runs.append((fn(tracked, xt, rate, gen, rate == 0.0), xt,
                     _tower_leaves(tracked)))
    (ko, kx, kl), (ro, rx, rl) = runs
    torch.cuda.synchronize()
    check(torch.equal(ko == 0, ro == 0), f"B4f {what}: dropout zeros differ")
    err = (ko - ro).abs().detach()
    scale = 1 + ro.abs().detach()
    near = float((err <= 1e-4 * scale).float().mean())
    check(near >= 0.95, f"B4f {what}: {1 - near!r} of the outputs beyond "
          "1e-4")
    check(float(err.max()) <= 5e-2 * float(ro.detach().abs().max()),
          f"B4f {what}: max |diff| {float(err.max())!r}")
    same = (err <= 1e-5 * scale).reshape(-1, err.shape[-1]).all(-1)
    check(float(same.float().mean()) >= 0.9,
          f"B4f {what}: only {float(same.float().mean())!r} of rows agree")
    near = _near_kink_rows(torch, tower, layers, x, rate)
    held = same & ~near
    log(f"B4b {what}: backward held on {int(held.sum())} of {held.numel()} "
        f"rows ({int(near.sum())} near a ReLU kink)")
    dy = torch.randn(ko.shape, device=x.device, generator=torch.Generator(
        device=x.device).manual_seed(5))
    dy = dy * held.reshape(ko.shape[:-1] + (1,))
    ko.backward(dy)
    ro.backward(dy)
    torch.cuda.synchronize()
    gk, gr = kx.grad.float(), rx.grad.float()
    dx_err = (gk - gr).abs()
    check(bool(dx_err.le(2.0 ** -7 * gr.abs()
                         + 1e-4 * float(gr.abs().max())).all()),
          f"B4b {what}: dx differs beyond one bf16 ulp")
    worst = float(dx_err.max())
    for i, (k, r) in enumerate(zip(kl, rl)):
        e = float((k.grad - r.grad).abs().max())
        check(e <= 1e-4 * float(r.grad.abs().max()) + 1e-6,
              f"B4b {what}: gradient of leaf {i} differs by {e!r}")
        worst = max(worst, e)
    return float(err.max()), worst


def phase_tower_kernels_vs_plain(torch):
    """B4f and B4b at the training steps' tower shapes and at edge shapes.
    Returns {kernel: max |kernel - plain|}."""
    from ncf_tpu_torch.ops import tower

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    errs = {"fused_tower_fwd": 0.0, "fused_tower_bwd": 0.0}
    cases = [((rows, d0), TOWER_HIDDEN)
             for rows, d0 in TOWER_SHAPES + CELL_TOWER_SHAPES]
    cases += [((1, 96), TOWER_HIDDEN), ((1025, 96), TOWER_HIDDEN),
              ((4096, 5, 96), TOWER_HIDDEN), ((3000, 96), [64]),
              ((2048, 512), [512, 512, 64])]
    n = 0
    f0 = tower.fused_tower.fwd_launches.value
    b0 = tower.fused_tower.bwd_launches.value
    for shape, hidden in cases:
        layers = _tower_layers(torch, shape[-1], hidden, gen)
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        for rate in (0.0, 0.2):
            ef, eb = _tower_compare(torch, tower, layers, x, rate,
                                    f"{list(shape)} -> {hidden} rate {rate}")
            errs["fused_tower_fwd"] = max(errs["fused_tower_fwd"], ef)
            errs["fused_tower_bwd"] = max(errs["fused_tower_bwd"], eb)
            n += 1
        del layers, x
    check(tower.fused_tower.fwd_launches.value - f0 == n
          and tower.fused_tower.bwd_launches.value - b0 == n,
          "B4: one launch per direction and case expected")
    torch.cuda.empty_cache()
    log(f"kernel_vs_plain: fused tower {n} cases ok, max_abs_err "
        f"{json.dumps(errs)}")
    return errs


def phase_tower_repeats(torch):
    """B4f and B4b twice on the same inputs (dropout 0.2) at the five tower
    shapes: equal bits, whatever order the blocks ran in."""
    from ncf_tpu_torch.ops import tower

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(43)
    for rows, d0 in TOWER_SHAPES + CELL_TOWER_SHAPES:
        flat = _tower_leaves(_tower_layers(torch, d0, TOWER_HIDDEN, gen))
        x2 = torch.randn((rows, d0), generator=gen, device=dev).to(
            torch.bfloat16)
        dy = torch.randn((rows, TOWER_HIDDEN[-1]), generator=gen, device=dev)
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=gen, device=dev,
                             dtype=torch.int32)
        outs = [tower._fwd_cuda(x2, seed, flat, 0.2) for _ in range(2)]
        check(torch.equal(*outs), f"B4f [{rows}, {d0}]: two runs differ")
        (dx1, g1), (dx2, g2) = (tower._bwd_cuda(x2, dy, seed, flat, 0.2)
                                for _ in range(2))
        check(torch.equal(dx1, dx2) and all(torch.equal(a, b)
                                            for a, b in zip(g1, g2)),
              f"B4b [{rows}, {d0}]: two runs differ")
        del flat, x2, dy, outs, dx1, dx2, g1, g2
    torch.cuda.empty_cache()
    log("tower_repeats: B4f and B4b equal bit for bit over two runs at "
        + ", ".join(f"[{r}, {d}]" for r, d in TOWER_SHAPES + CELL_TOWER_SHAPES))


# -------------------------------------------------------------- training

_DATA = {}


def _data(cfg):
    """The synthetic log at the config's size and its train split, made
    once per size."""
    from ncf_tpu_torch.data import generate_interactions

    d = cfg.data
    key = (d.synthetic_users, d.synthetic_items, d.synthetic_days,
           d.synthetic_avg_txns_per_user, d.synthetic_seed, d.validation_days)
    if key not in _DATA:
        inter = generate_interactions(
            num_users=d.synthetic_users, num_items=d.synthetic_items,
            num_days=d.synthetic_days,
            avg_txns_per_user=d.synthetic_avg_txns_per_user,
            seed=d.synthetic_seed)
        _DATA[key] = (inter, inter.time_split(d.validation_days)[0])
    return _DATA[key]


def _training_setup(torch, path=ML1M):
    """A training config at full width as shipped (stratified negatives,
    as ``bench.py`` trains), its synthetic log's batches and the step's
    device constants: (cfg, batches, consts, interactions, train split)."""
    import numpy as np

    from ncf_tpu_torch.data import BatchIterator, make_sampling_cdf
    from ncf_tpu_torch.utils.config import Config

    cfg = Config.from_yaml(path)
    inter, train_inter = _data(cfg)
    cfg.model.num_users, cfg.model.num_items = inter.num_users, inter.num_items
    cfg.model.num_departments = inter.num_departments
    cfg.model.num_categories = inter.num_categories
    cfg.train.negative_sampling = "stratified"
    it = BatchIterator(train_inter, cfg.train.batch_size, seed=cfg.train.seed)
    neg_cdf = make_sampling_cdf(train_inter.inverse_popularity_weights(),
                                device="cuda")
    consts = (neg_cdf, np.asarray(inter.item_dept), np.asarray(inter.item_cat))
    return cfg, it, consts, inter, train_inter


def _launch_counters():
    from ncf_tpu_torch.ops import sampler, scatter, temporal_sum, tower

    return {"tree_sample_negatives": sampler.tree_sample_negatives.launches,
            "onehot_scatter_add": scatter.onehot_scatter_add.launches,
            "fused_lookup_sum": temporal_sum.fused_lookup_sum.launches,
            "fused_tower_fwd": tower.fused_tower.fwd_launches,
            "fused_tower_bwd": tower.fused_tower.bwd_launches}


PER_STEP = {"tree_sample_negatives": 1, "onehot_scatter_add": 7,
            "fused_lookup_sum": 1, "fused_tower_fwd": 1, "fused_tower_bwd": 1}
# the sequence path adds one table gradient: the projected K/V table
PER_STEP_SEQ = dict(PER_STEP, onehot_scatter_add=8)


def _train_steps(torch, model, cfg, consts, batches, steps, per_step, what,
                 user_history=None):
    """``steps`` full-width steps from seeded params, each checked for its
    launches; returns the per-step losses on the host, the last step's
    accuracy and the trained params."""
    from ncf_tpu_torch.models import advanced_ncf
    from ncf_tpu_torch.train import make_optimizer, make_train_step

    counters = _launch_counters()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = advanced_ncf.init(gen, cfg.model)
    opt = make_optimizer(cfg.train, steps_per_epoch=len(batches))
    state = opt.init(params)
    step = make_train_step(model, cfg, opt, *consts,
                           user_history=user_history)
    losses = []
    for i in range(steps):
        before = {k: c.value for k, c in counters.items()}
        params, state, gen, m = step(params, state, gen,
                                     batches[i % len(batches)])
        for k, c in counters.items():
            check(c.value - before[k] == per_step[k],
                  f"training[{what}] step {i}: {k} launched "
                  f"{c.value - before[k]} times, want {per_step[k]}")
        losses.append(m["loss"])
    losses = torch.stack(losses).float().cpu()
    check(bool(torch.isfinite(losses).all()),
          f"training[{what}]: non-finite loss")
    return losses, float(m["accuracy"]), params


def _loss_fell(losses, what):
    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    check(last < first, f"training[{what}]: loss did not fall ({first!r} "
          f"-> {last!r})")
    return first, last


def phase_training(torch):
    """Config A as shipped: every sampler x candidate mode, 30 steps each,
    B4f and B4b once a step under ``fused_tower: auto``.  Returns
    (launches per kernel over the phase, summary, the params trained with
    stratified negatives in the independent mode)."""
    from ncf_tpu_torch.models import get_model, layers
    from ncf_tpu_torch.ops import embedding, sampler, tower

    t0 = time.perf_counter()
    cfg, it, consts, inter, _ = _training_setup(torch)
    check(cfg.model.fused_tower == "auto", "config A: fused_tower is not auto")
    log(f"training: {cfg.model.num_users}x{cfg.model.num_items}, "
        f"{len(inter)} interactions, {len(it)} batches of "
        f"{cfg.train.batch_size}, set up in {time.perf_counter() - t0:.1f} s")
    embedding.set_scatter_impl("fast")
    model = get_model("advanced_ncf")
    batches = list(it.epoch(0))
    counters = _launch_counters()
    summary = {}
    for c in counters.values():
        c.reset()
    for sampling in ("stratified", "iid"):
        for mode in ("joint", "independent"):
            cfg.train.negative_sampling = sampling
            cfg.model.candidate_mode = mode
            what = f"{sampling}/{mode}"
            losses, acc, params = _train_steps(
                torch, model, cfg, consts, batches, TRAIN_STEPS, PER_STEP,
                what)
            if what == "stratified/independent":
                trained = params
            del params
            first, last = _loss_fell(losses, what)
            summary[what] = {"first5": first, "last5": last, "acc": acc}
            log(f"training[{what}]: {TRAIN_STEPS} steps, loss {first!r} -> "
                f"{last!r}, accuracy {acc!r}")
    launches = {k: c.value for k, c in counters.items()}
    gen = torch.Generator(device="cuda").manual_seed(1)
    keep = layers.dropout_mask(gen, (16384, 256), cfg.model.dropout)
    zeroed = 1.0 - float(keep.float().mean())
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=gen, device="cuda",
                         dtype=torch.int32)
    bits = tower.dropout_bits(seed, 0, 16384, 256)
    tower_zeroed = float((bits >= tower.keep_threshold(cfg.model.dropout))
                         .float().mean())
    for z in (zeroed, tower_zeroed):
        check(abs(z - cfg.model.dropout) <= 0.01,
              f"dropout zeroes {z!r}, want {cfg.model.dropout} +- 0.01")
    summary["dropout_zero_share"] = zeroed
    summary["tower_dropout_zero_share"] = tower_zeroed
    log(f"training: launches {json.dumps(launches)}; dropout zeroes "
        f"{zeroed!r} (attention) and {tower_zeroed!r} (tower) of a "
        f"[16384, 256] mask")
    return launches, summary, trained


def phase_training_sequence(torch):
    """Config B: the quality config (sequence, independent) and its joint
    twin, 30 steps each with the train split's per-user history, then a
    few steps with causal per-example histories in the batch.  Returns
    (launches per kernel over the phase, summary, the quality config's
    trained params)."""
    from ncf_tpu_torch.data import BatchIterator
    from ncf_tpu_torch.models import get_model
    from ncf_tpu_torch.ops import embedding

    embedding.set_scatter_impl("fast")
    model = get_model("advanced_ncf")
    counters = _launch_counters()
    for c in counters.values():
        c.reset()
    summary = {}
    for path, name in ((QUALITY, "quality"), (SEQUENCE, "sequence")):
        t0 = time.perf_counter()
        cfg, it, consts, _, train_inter = _training_setup(torch, path)
        check(cfg.model.use_sequence and cfg.model.fused_tower == "auto",
              f"config {name}: not a sequence model under fused_tower auto")
        hist = train_inter.recent_history(cfg.model.history_len)
        batches = list(it.epoch(0))
        what = f"{name}/{cfg.model.candidate_mode}"
        losses, acc, params = _train_steps(torch, model, cfg, consts,
                                           batches, TRAIN_STEPS, PER_STEP_SEQ,
                                           what, hist)
        if name == "quality":
            trained = params
        del params
        first, last = _loss_fell(losses, what)
        summary[what] = {"first5": first, "last5": last, "acc": acc}
        log(f"training[{what}]: {TRAIN_STEPS} steps with history "
            f"{list(hist.shape)}, loss {first!r} -> {last!r}, accuracy "
            f"{acc!r} ({time.perf_counter() - t0:.1f} s)")
    # causal per-example prefixes shipped as a batch column
    t0 = time.perf_counter()
    cfg, _, consts, _, train_inter = _training_setup(torch, SEQUENCE)
    cfg.model.causal_history = True
    ctx = train_inter.causal_history(cfg.model.history_len)
    it = BatchIterator(train_inter, cfg.train.batch_size, seed=cfg.train.seed,
                       extra_cols={"history": ctx})
    batches = [b for _, b in zip(range(CAUSAL_STEPS), it.epoch(0))]
    check(batches[0]["history"].shape == (cfg.train.batch_size,
                                          cfg.model.history_len),
          "causal batches carry no history column")
    losses, acc, _ = _train_steps(torch, model, cfg, consts, batches,
                                  CAUSAL_STEPS, PER_STEP_SEQ, "causal")
    summary["causal"] = {"losses": losses.tolist(), "acc": acc}
    log(f"training[causal]: {CAUSAL_STEPS} steps with [N, "
        f"{cfg.model.history_len}] per-example histories, losses "
        f"{losses.tolist()} ({time.perf_counter() - t0:.1f} s)")
    del ctx, it, batches
    launches = {k: c.value for k, c in counters.items()}
    log(f"training_sequence: launches {json.dumps(launches)}")
    return launches, summary, trained


def phase_determinism(torch):
    """Two runs of two training steps from one parameter state and one
    generator seed must end in equal bits: every parameter and Adam's
    moments and count, for config A (``fused_tower: auto``, joint and
    independent) and config B (the quality config with its history).
    Then one step under ``torch.use_deterministic_algorithms(True,
    warn_only=True)``: its warnings name any operation of the step that
    PyTorch knows to be nondeterministic.  Returns a summary."""
    import warnings

    from ncf_tpu_torch.convert import tree_leaves, tree_map
    from ncf_tpu_torch.models import advanced_ncf, get_model
    from ncf_tpu_torch.ops import embedding
    from ncf_tpu_torch.train import make_optimizer, make_train_step

    embedding.set_scatter_impl("fast")
    model = get_model("advanced_ncf")
    summary = {}
    for path, mode, name in ((ML1M, "joint", "A joint"),
                             (ML1M, "independent", "A independent"),
                             (QUALITY, None, "B quality")):
        cfg, it, consts, _, train_inter = _training_setup(torch, path)
        check(cfg.model.fused_tower == "auto", f"{name}: tower not auto")
        if mode is not None:
            cfg.model.candidate_mode = mode
        hist = (train_inter.recent_history(cfg.model.history_len)
                if cfg.model.use_sequence else None)
        batches = [b for _, b in zip(range(2), it.epoch(0))]
        params0 = advanced_ncf.init(
            torch.Generator(device="cuda").manual_seed(11), cfg.model)
        opt = make_optimizer(cfg.train, steps_per_epoch=len(it))
        state0 = opt.init(params0)
        step = make_train_step(model, cfg, opt, *consts, user_history=hist)

        def run():
            params = tree_map(torch.clone, params0)
            state = tree_map(torch.clone, state0)
            gen = torch.Generator(device="cuda").manual_seed(12)
            for b in batches:
                params, state, gen, _ = step(params, state, gen, b)
            torch.cuda.synchronize()
            return tree_leaves(params) + tree_leaves(state)

        first, second = run(), run()
        differ = [i for i, (a, b) in enumerate(zip(first, second))
                  if not torch.equal(a, b)]
        moved = sum(int((a != b).sum()) for a, b in
                    zip(first, tree_leaves(params0) + tree_leaves(state0))
                    if a.shape == b.shape)
        check(not differ, f"determinism[{name}]: leaves {differ} of "
              f"{len(first)} differ between two runs from one state")
        check(moved > 0, f"determinism[{name}]: the steps changed nothing")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                step(tree_map(torch.clone, params0),
                     tree_map(torch.clone, state0),
                     torch.Generator(device="cuda").manual_seed(12),
                     batches[0])
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
        said = sorted({str(w.message).strip().splitlines()[0][:240]
                       for w in caught})
        summary[name] = {"leaves": len(first),
                         "elements": sum(t.numel() for t in first),
                         "elements_moved": moved,
                         "deterministic_mode_warnings": said}
        log(f"determinism[{name}]: two runs of {len(batches)} steps equal "
            f"bit for bit over {len(first)} leaves "
            f"({summary[name]['elements']} elements, {moved} moved); "
            f"deterministic-mode warnings: {json.dumps(said)}")
        del params0, state0, first, second
        torch.cuda.empty_cache()
    return summary


def _tree_check(torch, a_tree, b_tree, lr, steps, share=1e-4):
    """Card params against CPU params: all but ``share`` of all elements
    (0.01% by default) within 1e-4 of their leaf's largest magnitude, and
    every element within 3 * steps * lr.  Adam's first step moves every element with a
    nonzero gradient by about lr whatever the gradient's size, so an
    element whose gradient is zero up to rounding may step either way on
    the two devices; such elements fall in any leaf, so the budget is the
    tree's.  Returns (max abs diff, elements outside, elements, the
    leaves holding them as {index: [outside, shape]})."""
    from ncf_tpu_torch.convert import tree_leaves

    worst, outside, total, where = 0.0, 0, 0, {}
    for i, (a, b) in enumerate(zip(tree_leaves(a_tree), tree_leaves(b_tree))):
        a, b = a.detach().float().cpu(), b.detach().float()
        diff = (a - b).abs()
        tol = 1e-4 * float(b.abs().max()) + 1e-7
        bad = int((diff > tol).sum())
        if bad:
            where[i] = [bad, list(b.shape)]
        check(float(diff.max()) <= 3 * steps * lr + tol,
              f"card vs CPU: an element of leaf {i} moved "
              f"{float(diff.max())!r}")
        worst, outside, total = (max(worst, float(diff.max())),
                                 outside + bad, total + diff.numel())
    check(outside <= total * share,
          f"card vs CPU: {outside} of {total} elements differ ({where})")
    return worst, outside, total, where


def phase_card_vs_cpu(torch, advanced_ncf, tower_mode):
    """Three full-width steps in f32 with dropout 0, from the same params
    and negatives, on the card and through the port on the CPU.
    ``tower_mode`` "off" runs the plain tower on both; "on" runs the fused
    kernels on the card and their plain version on the CPU."""
    from ncf_tpu_torch.convert import tree_map
    from ncf_tpu_torch.data import sample_negatives_stratified
    from ncf_tpu_torch.models import get_model
    from ncf_tpu_torch.ops import embedding, tower
    from ncf_tpu_torch.train import make_optimizer, make_train_step

    cfg, it, consts, _, _ = _training_setup(torch)
    cfg.model.compute_dtype = "float32"
    cfg.model.dropout = 0.0
    cfg.model.fused_tower = tower_mode
    # f32 table gradients: the rounding modes are held per kernel in
    # phase 3; here the two devices should differ only in summation order
    embedding.set_scatter_impl("xla")
    model = get_model("advanced_ncf")
    batches = [b for _, b in zip(range(3), it.epoch(0))]
    gen = torch.Generator(device="cuda").manual_seed(3)
    negs = [sample_negatives_stratified(
        gen, torch.as_tensor(b["item_ids"], device="cuda"),
        cfg.model.num_items, cfg.model.negative_samples,
        cdf=consts[0]).cpu() for b in batches]
    params = advanced_ncf.init(gen, cfg.model)
    host = tree_map(lambda t: t.detach().to("cpu", copy=True), params)
    out, losses = {}, {}
    for where, dev, p in (("card", "cuda", params), ("cpu", "cpu", host)):
        opt = make_optimizer(cfg.train, steps_per_epoch=100)
        state = opt.init(p)
        cdf = consts[0].to(dev)
        step = make_train_step(model, cfg, opt, cdf, *consts[1:], device=dev)
        g = torch.Generator(device=dev)
        t0 = time.perf_counter()
        f0 = tower.fused_tower.fwd_launches.value
        b0 = tower.fused_tower.bwd_launches.value
        losses[where] = []
        for b, n in zip(batches, negs):
            p, state, g, m = step(p, state, g, b, n)
            losses[where].append(float(m["loss"]))
        out[where] = (p, state)
        want = 3 if (tower_mode == "on" and dev == "cuda") else 0
        check(tower.fused_tower.fwd_launches.value - f0 == want
              and tower.fused_tower.bwd_launches.value - b0 == want,
              f"card_vs_cpu[{tower_mode}] on {dev}: tower kernel launches")
        log(f"card_vs_cpu[{tower_mode}]: 3 steps on {dev} in "
            f"{time.perf_counter() - t0:.1f} s, losses {losses[where]}")
    for a, b in zip(losses["card"], losses["cpu"]):
        check(abs(a - b) <= 1e-4 * abs(b), f"card vs CPU loss {a} vs {b}")
    # the fused tower rounds its f32 input and its activations to bf16:
    # where the two devices' f32 values (equal to ~1e-7) straddle a bf16
    # rounding boundary, that example's tower row moves by up to ~1e-2,
    # and so do the gradients of its user and item rows and, slightly,
    # every tower weight; Adam turns gradients near zero into steps of
    # either sign, so the share of elements beyond 1e-4 grows from 0 to
    # about 1% of the tree
    worst, outside, total, where = _tree_check(
        torch, out["card"][0], out["cpu"][0], cfg.train.learning_rate, 3,
        share=0.02 if tower_mode == "on" else 1e-4)
    check(int(out["card"][1]["count"]) == 3, "card: Adam count != 3")
    log(f"card_vs_cpu[{tower_mode}]: params agree (max |diff| {worst!r}, "
        f"{outside} of {total} elements beyond 1e-4 of their leaf's scale, "
        f"in leaves {where})")
    del out, params, host
    torch.cuda.empty_cache()
    return {"tower": tower_mode, "max_abs_param_diff": worst, "elements_outside": outside,
            "elements": total, "leaves_outside": where, "losses": losses}


SEQ_SCORE_TOL = 5e-3     # probabilities: a bf16 flip in the tower moves
                         # the MLP logit by ~1e-3


def phase_serving_sequence(torch, advanced_ncf, ModelServer):
    """Config B served: ``ModelServer`` over the quality config with the
    train split's ``recent_history(50)`` (``SequenceRescoreScorer``),
    random weights from a seed, held against the same server with
    ``fused_tower: off``: scores within ``SEQ_SCORE_TOL``, ids equal
    wherever the ``off`` server's scores of the two rivals differ by more.
    Every request on the ``auto`` server launches B4f, none on ``off``.
    Returns the B4f launches on the ``auto`` server."""
    import copy

    import numpy as np

    from ncf_tpu_torch.ops import tower

    cfg, _, _, inter, train_inter = _training_setup(torch, QUALITY)
    hist = train_inter.recent_history(cfg.model.history_len)
    dept, cat = np.asarray(inter.item_dept), np.asarray(inter.item_cat)
    gen = torch.Generator(device="cuda").manual_seed(11)
    params = advanced_ncf.init(gen, cfg.model)
    off_cfg = copy.deepcopy(cfg)
    off_cfg.model.fused_tower = "off"
    t0 = time.perf_counter()
    auto = ModelServer(cfg, params=params, item_dept=dept, item_cat=cat,
                       user_history=hist, device="cuda")
    off = ModelServer(off_cfg, params=params, item_dept=dept, item_cat=cat,
                      user_history=hist, device="cuda")
    launches = tower.fused_tower.fwd_launches
    launches.reset()
    log(f"serving_sequence: two servers over {cfg.model.num_users}x"
        f"{cfg.model.num_items} with history {list(hist.shape)} in "
        f"{time.perf_counter() - t0:.1f} s ({type(auto.scorer).__name__})")
    rng = np.random.default_rng(5)
    users = rng.choice(cfg.model.num_users, 64, replace=False)
    temporal = {"hour": 20, "day": 5, "month": 3, "day_of_year": 70}
    worst, swaps, n_req = 0.0, 0, 0

    def same(got, want, uids, what):
        nonlocal worst, swaps
        (gs, gi), (ws, wi) = got, want
        gs, gi = np.atleast_2d(gs), np.atleast_2d(gi)
        ws, wi = np.atleast_2d(ws), np.atleast_2d(wi)
        check(np.isfinite(gs).all() and gs.shape == ws.shape,
              f"serving_sequence {what}: bad scores")
        worst = max(worst, float(np.abs(gs - ws).max()))
        check(np.abs(gs - ws).max() <= SEQ_SCORE_TOL,
              f"serving_sequence {what}: scores differ by "
              f"{float(np.abs(gs - ws).max())!r}")
        for r, j in zip(*np.nonzero(gi != wi)):
            pair = off.get_predictions(int(uids[r]), [gi[r, j], wi[r, j]],
                                       None if "temporal" not in what
                                       else temporal)
            check(abs(float(pair[0] - pair[1])) <= SEQ_SCORE_TOL,
                  f"serving_sequence {what}: ids differ where the scores "
                  f"are not tied")
            swaps += 1

    def served(fn, what):
        nonlocal n_req
        n0 = launches.value
        out = fn(auto)
        check(launches.value > n0, f"serving_sequence {what}: B4f not "
              "launched")
        n1 = launches.value
        want = fn(off)
        check(launches.value == n1, f"serving_sequence {what}: the off "
              "server launched B4f")
        n_req += 1
        return out, want

    try:
        for u in users[:8]:
            got, want = served(lambda s: s.recommend(int(u), k=10)[:2],
                               "recommend")
            same(got, want, [u], "recommend")
        u = int(users[0])
        seen = rng.choice(cfg.model.num_items, 50, replace=False)
        seen[:5] = auto.recommend(u, k=5)[1]
        got, want = served(lambda s: s.recommend(
            u, k=10, exclude_items=seen.tolist())[:2], "exclusion")
        check(not set(seen.tolist()) & set(got[1].tolist()),
              "serving_sequence: an excluded item was served")
        same(got, want, [u], "exclusion")
        got, want = served(lambda s: s.recommend(
            u, k=10, temporal=temporal)[:2], "temporal")
        same(got, want, [u], "temporal")
        got, want = served(lambda s: s.recommend_batch(users, k=10)[:2],
                           "batch")
        same(got, want, users, "batch")
        items = rng.choice(cfg.model.num_items, 20, replace=False)
        got, want = served(lambda s: s.get_predictions(u, items), "pairs")
        check(np.abs(got - want).max() <= SEQ_SCORE_TOL,
              "serving_sequence: pair scores differ")
        worst = max(worst, float(np.abs(got - want).max()))
        ms = [auto.recommend(int(users[j % 64]), k=10)[2] for j in range(20)]
        many = [auto.recommend_batch(users, k=10)[2] for _ in range(10)]
    finally:
        auto.close()
        off.close()
    out = {"requests": n_req, "b4f_launches": launches.value,
           "max_score_diff": worst, "near_tie_id_swaps": swaps,
           "p50_ms_1_user": float(np.median(ms)),
           "p50_ms_64_users": float(np.median(many))}
    log(f"serving_sequence: {n_req} requests agree with the off path "
        f"(max |score diff| {worst!r}, {swaps} near-tie id swaps), B4f "
        f"launches {launches.value}; p50 {out['p50_ms_1_user']!r} ms (1 "
        f"user), {out['p50_ms_64_users']!r} ms (64 users)")
    del auto, off, params
    torch.cuda.empty_cache()
    return out


# logits: the largest score difference any eval comparison may measure
# (the serving check's 5e-3 on probabilities over the sigmoid's largest
# slope, 1/4); each comparison's near-tie window is twice the difference
# it measures, which a bf16 flip in the tower puts at ~1e-3
EVAL_SCORE_TOL = 2e-2
EVAL_FULL_USERS = 512    # users held against the naive whole-catalog oracle
EVAL_CPU_USERS = 128     # users held against the port on the CPU


def _near_ties(ref, pos, gap, hist=None):
    """Per user: the entries of the reference scores ``ref`` [U, N] (the
    positive's own, column ``pos``, left out), and of the history pairs
    ``hist`` = (user row, item, score) where given, that lie within
    ``2 * gap`` of the positive's score: an entry further off stays on
    its side when every score moves by at most ``gap``."""
    import numpy as np

    rows = np.arange(len(pos))
    sp = ref[rows, pos]
    near = np.abs(ref - sp[:, None]) <= 2 * gap
    near[rows, pos] = False
    out = near.sum(1)
    if hist is not None:
        hu, _, hs = hist
        out += np.bincount(hu, np.abs(hs - sp[hu]) <= 2 * gap,
                           len(pos)).astype(out.dtype)
    return out


def _hold_ranks(got, want, near, gap, what):
    """Ranks ``got`` against ``want`` under the near-tie rule: a rank may
    move only by the user's near ties, so users with none must have equal
    ranks.  Returns a summary with the near ties a user has (mean, max)."""
    import numpy as np

    check(gap <= EVAL_SCORE_TOL / 2, f"eval {what}: scores differ by "
          f"{gap!r}")
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    bad = int((diff > near).sum())
    check(bad == 0, f"eval {what}: {bad} users' ranks differ by more than "
          f"their near ties")
    return {"users": len(got), "max_score_diff": gap,
            "near_tie_users": int((near > 0).sum()),
            "near_ties_mean": float(near.mean()),
            "near_ties_max": int(near.max()),
            "ranks_differ": int((diff > 0).sum()),
            "equal_share": float((diff == 0).mean())}


def _split_values(torch, ev, params):
    """What ``FullCatalogEvaluator.ranks`` compares, formed as it forms
    them, on the host: the block logits of every (eval user, catalog
    item) pair [U, V], the positives' gathered logits [U], and the history
    pairs (user row, item, gathered logit)."""
    import numpy as np

    from ncf_tpu_torch.utils.device import torch_dtype

    cfg, C, V, U = ev.cfg, ev._C, ev.V, ev.U
    dtype = torch_dtype(cfg.compute_dtype)
    nblk = -(-V // C)
    blocks, pos, mf, u1s, hu, hi, hs = [], [], [], [], [], [], []
    with torch.no_grad():
        iv, imlp = ev._item_tables(params, dtype)
        a1 = [ev._item_part(params, imlp[b * C:(b + 1) * C], dtype)
              for b in range(nblk)]
        kv_t = (ev._seq_kv_table(params, dtype)
                if cfg.use_sequence and ev._hist is not None else None)
        for j in range(ev._users.shape[0]):
            t = {k: v[j] for k, v in ev._temporal.items()}
            h = ev._hist[j] if ev._hist is not None else None
            user_mf, u1 = ev._user_parts(params, ev._users[j], t, h, kv_t,
                                         dtype)
            pos.append(ev._pair_scores_gathered(params, iv, imlp, user_mf,
                                                u1, ev._pos[j], dtype).cpu())
            blocks.append(torch.cat([ev._pair_scores(
                params, user_mf, u1, iv[b * C:(b + 1) * C], a1[b], dtype)
                for b in range(nblk)], 1)[:, :V].cpu())
            mf.append(user_mf)
            u1s.append(u1)
        mf, u1s = torch.cat(mf)[:U], torch.cat(u1s)[:U]
        for uu, ii, ok in zip(ev._ex_u, ev._ex_i, ev._ex_valid):
            uu = uu.long()
            s = ev._pair_scores_gathered(params, iv, imlp, mf[uu], u1s[uu],
                                         ii, dtype)
            hu.append(uu[ok].cpu())
            hi.append(ii[ok].cpu())
            hs.append(s[ok].cpu())
    return (torch.cat(blocks)[:U].numpy(), torch.cat(pos)[:U].numpy(),
            (torch.cat(hu).numpy(), torch.cat(hi).long().numpy(),
             torch.cat(hs).numpy()))


def _ranks_of_values(blocks, pos_s, hist, pos):
    """The rank ``FullCatalogEvaluator.ranks`` forms from its values."""
    import numpy as np

    U = len(pos_s)
    ok = np.ones(blocks.shape, bool)
    ok[np.arange(U), pos] = False
    g = ((blocks > pos_s[:, None]) & ok).sum(1)
    ge = ((blocks >= pos_s[:, None]) & ok).sum(1)
    hu, _, hs = hist
    gh = np.bincount(hu, hs > pos_s[hu], U).astype(np.int64)
    geh = np.bincount(hu, hs >= pos_s[hu], U).astype(np.int64)
    return np.maximum(g - gh, ge - geh)


def _values_gap(a, b, pos):
    """The largest difference between two sets of ``_split_values`` of
    the same users and pairs (the positive's own block column, which the
    evaluator masks, left out)."""
    import numpy as np

    check(np.array_equal(a[2][0], b[2][0])
          and np.array_equal(a[2][1], b[2][1]), "eval: history pairs differ")
    d = np.abs(a[0] - b[0])
    d[np.arange(len(pos)), pos] = 0
    return float(max(d.max(), np.abs(a[1] - b[1]).max(),
                     np.abs(a[2][2] - b[2][2]).max(initial=0.0)))


def _block_scores(score, users, cands, temporal, B, dev="cuda"):
    """``score``'s logits (a scorer on ``dev``) for every eval user, in the
    evaluator's blocks of ``B`` (the last padded with its first row), on
    the host."""
    import numpy as np
    import torch

    out = []
    for start in range(0, len(users), B):
        sl = slice(start, start + B)
        u, c = users[sl], cands[sl]
        t = {k: v[sl] for k, v in temporal.items()}
        n = len(u)
        if n < B:
            u = np.concatenate([u, u[:1].repeat(B - n)])
            c = np.concatenate([c, c[:1].repeat(B - n, axis=0)])
            t = {k: np.concatenate([v, v[:1].repeat(B - n)])
                 for k, v in t.items()}
        s = score(torch.as_tensor(u, device=dev),
                  torch.as_tensor(c, device=dev),
                  {k: torch.as_tensor(v, device=dev) for k, v in t.items()})
        out.append(s.float().cpu().numpy()[:n])
    return np.concatenate(out)


def _timed(torch, fn):
    """(result, host s) of one whole evaluation, and its device time from
    the profiler (ms, the device's busy share of the window, the number
    of device operations, and the ten kernels with the most device time,
    each with its ms and launches)."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    host = time.perf_counter() - t0
    prof = device_profile(fn, 1, top=10, width=150) or {}
    return out, {"host_s": host,
                 "device_ms": prof.get("device_ms_per_call"),
                 "busy_share": prof.get("busy_share"),
                 "device_ops": prof.get("device_ops_per_call"),
                 "top_kernels": [
                     [n, ms, prof["kernels_launches_per_call"][n]]
                     for n, ms in prof["kernels_ms_per_call"].items()]
                 if prof else None}


def _eval_config(torch, advanced_ncf, path, card, params):
    """The eval phase for one config at full width, with the params its
    training phase left; returns (B4f launches of the sampled evaluation,
    summary)."""
    import copy

    import numpy as np

    from ncf_tpu_torch.convert import tree_map
    from ncf_tpu_torch.evals import (DeviceEvaluator, EvalSet,
                                     FullCatalogEvaluator, full_ranks_naive,
                                     make_score_fn, metrics_from_ranks,
                                     sample_eval_users)
    from ncf_tpu_torch.ops import tower
    from ncf_tpu_torch.utils.config import Config

    cfg = Config.from_yaml(path)
    inter, _ = _data(cfg)
    m = cfg.model
    m.num_users, m.num_items = inter.num_users, inter.num_items
    m.num_departments = inter.num_departments
    m.num_categories = inter.num_categories
    check(m.fused_tower == "auto" and m.compute_dtype == "bfloat16",
          f"eval {path}: not the shipped bf16 auto tower")
    off = copy.deepcopy(m)
    off.fused_tower = "off"
    name = os.path.basename(path)

    t0 = time.perf_counter()
    loo_train, users, items = inter.leave_one_out()
    users, items = sample_eval_users(users, items, cfg.data.eval_user_sample,
                                     seed=cfg.train.seed + 777)
    es = EvalSet.build(inter, users, items,
                       num_negatives=cfg.data.num_eval_negatives,
                       seed=cfg.train.seed)
    hist = loo_train.recent_history(m.history_len) if m.use_sequence \
        else None
    dept, cat = np.asarray(inter.item_dept), np.asarray(inter.item_cat)
    kw = dict(item_dept=dept, item_cat=cat, user_history=hist)
    B = cfg.data.eval_batch_size
    sampled = DeviceEvaluator(advanced_ncf, m, es, batch_size=B,
                              device="cuda", **kw)
    sampled_off = DeviceEvaluator(advanced_ncf, off, es, batch_size=B,
                                  device="cuda", **kw)
    full = FullCatalogEvaluator(
        m, inter, users, items, user_block=cfg.data.full_eval_user_block,
        item_block=cfg.data.full_eval_item_block, device="cuda", **kw)
    setup_s = time.perf_counter() - t0
    out = {"config": name, "eval_users": len(users),
           "candidates": list(es.candidates.shape), "setup_s": setup_s,
           "card": card}

    # sampled: B4f under auto, none under off
    launches = tower.fused_tower.fwd_launches
    launches.reset()
    r_auto, out["sampled_time"] = _timed(torch, lambda: sampled.ranks(params))
    b4f = launches.value
    check(b4f > 0, f"eval {name}: B4f was not launched by the sampled "
          f"evaluation")
    launches.reset()
    r_off = sampled_off.ranks(params)
    check(launches.value == 0, f"eval {name}: the off path launched B4f")
    s_auto = _block_scores(make_score_fn(advanced_ncf, params, m,
                                         device="cuda", **kw),
                           es.users, es.candidates, es.temporal, B)
    s_off = _block_scores(make_score_fn(advanced_ncf, params, off,
                                        device="cuda", **kw),
                          es.users, es.candidates, es.temporal, B)
    check(np.isfinite(s_auto).all() and s_auto.shape == es.candidates.shape,
          f"eval {name}: bad sampled scores")
    # the scores the evaluator ranked are these (same blocks, same calls)
    pr = lambda s: np.maximum((s[:, 1:] > s[:, :1]).sum(1),  # noqa: E731
                              (s[:, 1:] >= s[:, :1]).sum(1))
    check(np.array_equal(pr(s_auto), r_auto) and np.array_equal(
        pr(s_off), r_off), f"eval {name}: ranks are not their scores'")
    zero = np.zeros(len(users), np.int64)
    gap = float(np.abs(s_auto - s_off).max())
    out["sampled_vs_off"] = dict(
        _hold_ranks(r_auto, r_off, _near_ties(s_off, zero, gap), gap,
                    "sampled"), b4f_launches=b4f)
    out["sampled_metrics"] = metrics_from_ranks(r_auto)

    # full catalog: the split evaluator, then the naive oracle on a sample
    r_full, out["full_time"] = _timed(torch, lambda: full.ranks(params))
    check(r_full.shape == (len(users),) and (r_full >= 0).all()
          and (r_full < m.num_items).all(), f"eval {name}: bad full ranks")
    out["full_metrics"] = metrics_from_ranks(r_full)
    # what the split evaluator compared, for every user: its ranks must
    # be these values' ranks
    vals = _split_values(torch, full, params)
    check(np.array_equal(_ranks_of_values(*vals, items), r_full),
          f"eval {name}: full ranks are not their values'")
    rng = np.random.default_rng(11)
    sel = np.sort(rng.choice(len(users), EVAL_FULL_USERS, replace=False))
    su, si = users[sel], items[sel]
    rows = np.arange(len(sel))
    local = np.full(len(users), -1)
    local[sel] = rows
    keep = local[vals[2][0]] >= 0
    hu, hi = local[vals[2][0][keep]], vals[2][1][keep]
    catalog = np.tile(np.arange(m.num_items, dtype=np.int32), (len(su), 1))
    temporal = {k: v[sel] for k, v in es.temporal.items()}
    for tag, mc in (("auto", m), ("off", off)):
        launches.reset()
        naive = full_ranks_naive(advanced_ncf, params, mc, inter, su, si,
                                 device="cuda", **kw)
        check((launches.value > 0) == (tag == "auto"),
              f"eval {name}: naive[{tag}] B4f launches {launches.value}")
        s = _block_scores(make_score_fn(advanced_ncf, params, mc,
                                        device="cuda", **kw),
                          su, catalog, temporal, 256)
        hist = (hu, hi, s[hu, hi])
        check(np.array_equal(_ranks_of_values(s, s[rows, si], hist, si),
                             naive), f"eval {name}: naive[{tag}] ranks are "
              "not their scores'")
        # every value the split evaluator compared, against the naive
        # score of its pair
        gap = _values_gap((vals[0][sel], vals[1][sel],
                           (hu, hi, vals[2][2][keep])),
                          (s, s[rows, si], hist), si)
        out[f"full_vs_naive_{tag}"] = _hold_ranks(
            r_full[sel], naive, _near_ties(s, si, gap, hist), gap,
            f"full vs naive[{tag}]")

    # the port on the CPU, on the first users, against the card
    n = EVAL_CPU_USERS
    host = tree_map(lambda t: t.detach().to("cpu", copy=True), params)
    sub = EvalSet(users=es.users[:n], candidates=es.candidates[:n],
                  temporal={k: v[:n] for k, v in es.temporal.items()})
    r_cpu = DeviceEvaluator(advanced_ncf, m, sub, batch_size=B,
                            device="cpu", **kw).ranks(host)
    s_cpu = _block_scores(make_score_fn(advanced_ncf, host, m, device="cpu",
                                        **kw),
                          sub.users, sub.candidates, sub.temporal,
                          min(B, n), "cpu")
    check(np.array_equal(pr(s_cpu), r_cpu),
          f"eval {name}: CPU ranks are not their scores'")
    gap = float(np.abs(s_auto[:n] - s_cpu).max())
    held = _hold_ranks(r_auto[:n], r_cpu, _near_ties(s_cpu, zero[:n], gap),
                       gap, "sampled card vs cpu")
    # the split evaluator on the first users, on the card and on the CPU,
    # each held to the values it compared
    kw_full = dict(user_block=cfg.data.full_eval_user_block,
                   item_block=cfg.data.full_eval_item_block, **kw)
    f_card = FullCatalogEvaluator(m, inter, users[:n], items[:n],
                                  device="cuda", **kw_full)
    f_ev = FullCatalogEvaluator(m, inter, users[:n], items[:n],
                                device="cpu", **kw_full)
    f_gpu, f_cpu = f_card.ranks(params), f_ev.ranks(host)
    v_gpu, v_cpu = (_split_values(torch, f_card, params),
                    _split_values(torch, f_ev, host))
    check(np.array_equal(_ranks_of_values(*v_gpu, items[:n]), f_gpu)
          and np.array_equal(_ranks_of_values(*v_cpu, items[:n]), f_cpu),
          f"eval {name}: full ranks on {n} users are not their values'")
    gap = _values_gap(v_gpu, v_cpu, items[:n])
    # the CPU's block and history values are the reference; the
    # positive's is its gathered one
    ref = v_cpu[0].copy()
    ref[np.arange(n), items[:n]] = v_cpu[1]
    held_full = _hold_ranks(f_gpu, f_cpu, _near_ties(ref, items[:n], gap,
                                                     v_cpu[2]),
                            gap, "full card vs cpu")
    # each user's hr/ndcg/mrr/map term lies in [0, 1], so a mean moves by
    # at most the share of users whose ranks differ
    for what, a, b, h in (("sampled", r_auto[:n], r_cpu, held),
                          ("full", f_gpu, f_cpu, held_full)):
        ma, mb = metrics_from_ranks(a), metrics_from_ranks(b)
        tol = h["ranks_differ"] / n
        for k in ma:
            if k.split("@")[0] in ("hr", "ndcg", "mrr", "map"):
                check(abs(ma[k] - mb[k]) <= tol + 1e-12,
                      f"eval {name} {what}: card {k} {ma[k]!r} against the "
                      f"CPU's {mb[k]!r}")
        h["metric_tol"] = tol
        h["card_hr@10"], h["cpu_hr@10"] = ma["hr@10"], mb["hr@10"]
    out["sampled_card_vs_cpu"], out["full_card_vs_cpu"] = held, held_full
    del sampled, sampled_off, full, f_card, vals
    torch.cuda.empty_cache()
    return b4f, out


def phase_eval(torch, advanced_ncf, card, trained):
    """The evaluators at full width: ``advanced_ncf_ml1m.yaml`` and the
    sequence path's ``advanced_ncf_quality.yaml`` (history 50) over the
    smoke's ML-1M-scale synthetic log, with the weights their training
    phases left (``trained``: config path -> params; 30 steps from seeded
    weights).  Returns (B4f launches of the sampled evaluations,
    summaries)."""
    from ncf_tpu_torch.ops import embedding

    embedding.set_impl("xla")
    launches, summaries = 0, []
    for path in (ML1M, QUALITY):
        n, out = _eval_config(torch, advanced_ncf, path, card, trained[path])
        launches += n
        summaries.append(out)
        st, ft = out["sampled_time"], out["full_time"]
        log(f"eval[{out['config']}]: {out['eval_users']} users, sampled "
            f"{out['candidates']} host {st['host_s']!r} s, device "
            f"{st['device_ms']!r} ms (busy {st['busy_share']!r}), B4f "
            f"launches {n}; full catalog host {ft['host_s']!r} s, device "
            f"{ft['device_ms']!r} ms (busy {ft['busy_share']!r}); hr@10 "
            f"sampled {out['sampled_metrics']['hr@10']!r}, full "
            f"{out['full_metrics']['hr@10']!r}; {card}")
        for k in ("sampled_vs_off", "full_vs_naive_auto", "full_vs_naive_off",
                  "sampled_card_vs_cpu", "full_card_vs_cpu"):
            log(f"eval[{out['config']}]: {k} {json.dumps(out[k])}")
        for k, t in (("sampled", st), ("full", ft)):
            log(f"eval[{out['config']}]: {k} device ops {t['device_ops']!r}; "
                f"top kernels [name, ms, launches] "
                f"{json.dumps(t['top_kernels'])}")
    return launches, summaries


def _bound(nbytes, ops, peak_ops):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _device_fields(call, library=None):
    """Profiler device time of the kernel call (and its device operations)
    and, where a library call computes the same function, that call's."""
    ms, ops = device_split(call)
    out = {"device_ms": ms, "device_ops": ops}
    if library is not None:
        out["library_device_ms"] = device_split(library)[0]
    return out


def _deterministic_library(torch, det_lib, call):
    """Time ``det_lib`` (a library call that computes B2's function) under
    ``torch.use_deterministic_algorithms(True)``, and say whether two of
    its calls, and B2's own result, agree with it bit for bit."""
    torch.use_deterministic_algorithms(True)
    try:
        a, b = det_lib(), det_lib()
        torch.cuda.synchronize()
        out = {"det_library_ms": cuda_ms(det_lib, 50),
               "det_library_device_ms": device_split(det_lib)[0],
               "det_library_repeats": bool(torch.equal(a, b))}
    finally:
        torch.use_deterministic_algorithms(False)
    out["det_library_equals_kernel"] = bool(torch.equal(a, call()))
    return out


# the kernels that add B2's runs (this tree's, and an earlier tree's
# long-run kernel, for a comparison with it); every other device op of a
# call groups, but where the small tables' kernel ran, which groups and
# adds in one kernel
B2_ADDS = ("scatter_rows_kernel", "long_runs_kernel")
B2_ONE_KERNEL = "scatter_small_kernel"


def _scatter_step_cases(torch, batch, negs, cfg, consts):
    """B2's launches in a config A step (``fast``: bf16 rounding where the
    reference runs its kernel, split for the temporal tables): (table, ids,
    rows, D, grads dtype, mode) for the user, item, department, category,
    hour, weekday and month tables."""
    from ncf_tpu_torch.ops import embedding

    dev = torch.device("cuda")
    pos = torch.as_tensor(batch["item_ids"], device=dev)
    items = torch.cat([pos[:, None], torch.as_tensor(negs, device=dev)], 1)
    m = cfg.model
    out = []
    for what, ids, nrows, d, dtype in (
            ("user", batch["user_ids"], m.num_users, 128, torch.bfloat16),
            ("item", items, m.num_items, 128, torch.bfloat16),
            ("dept", consts[1], m.num_departments, 64, torch.float32),
            ("cat", consts[2], m.num_categories, 64, torch.float32),
            ("hour", batch["hour"], 24, 32, torch.float32),
            ("day", batch["day"], 7, 32, torch.float32),
            ("month", batch["month"], 12, 32, torch.float32)):
        ids = torch.as_tensor(ids, device=dev)
        mode = (embedding.backward_mode(nrows, d, ids.numel())
                if what not in ("hour", "day", "month") else "split")
        out.append((what, ids, nrows, d, dtype, mode))
    return out


def _time_scatter(torch, cases, seed=5):
    """B2 at each case of ``_scatter_step_cases``: CUDA events over 50
    calls, profiler device time, the device time of the grouping (every
    op of the call but the adds), each device op's ms, the host's enqueue
    µs a call, the library calls for the same function (``index_add_``,
    unordered; ``index_put_(accumulate=True)`` under deterministic mode),
    the plain version, the bound, and a hash of the result.  The grouping's
    time is None where the small tables' kernel groups and adds in one."""
    import hashlib

    from ncf_tpu_torch.ops import scatter

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    f32 = PEAK_FLOP_S["float32"]
    rows = []
    for what, ids, nrows, d, dtype, mode in cases:
        g = torch.randn(tuple(ids.shape) + (d,), generator=gen,
                        device=dev).to(dtype)
        flat_ids, flat_g = scatter._flat(ids, g)
        rounded = scatter.round_mode(flat_g, mode)
        lids = flat_ids.long()
        n = ids.numel()
        nbytes = (n * ids.element_size() + g.numel() * g.element_size()
                  + nrows * d * 4)
        bound, by = _bound(nbytes, n * d * {"f32": 1, "bf16": 2,
                                            "split": 5}[mode], f32)
        call = functools.partial(scatter.onehot_scatter_add, ids, g, nrows,
                                 mode=mode)

        def lib(nrows=nrows, d=d, lids=lids, rounded=rounded):
            return torch.zeros((nrows, d), device=dev).index_add_(
                0, lids, rounded)

        def det_lib(nrows=nrows, d=d, lids=lids, rounded=rounded):
            # the library's deterministic route for the same function: a
            # sort, then each row's values added in a fixed order
            return torch.zeros((nrows, d), device=dev).index_put_(
                (lids,), rounded, accumulate=True)

        det = _deterministic_library(torch, det_lib, call)
        ms, ops = device_split(call, top=16)
        one = ops is None or any(B2_ONE_KERNEL in k for k in ops)
        adds = (None if one else
                sum(v for k, v in ops.items() if any(a in k for a in B2_ADDS)))
        out = call().cpu().numpy()
        rows.append({"kernel": "onehot_scatter_add", "shape": what,
                     "mode": mode, "ids": list(ids.shape),
                     "ids_dtype": str(ids.dtype)[6:], "rows": nrows,
                     "ms": cuda_ms(call, 50), "device_ms": ms,
                     "device_ops": ops,
                     "group_device_ms": None if one else ms - adds,
                     "host_us": enqueue_us(call),
                     "library_device_ms": device_split(lib)[0], **det,
                     "plain_ms": cuda_ms(lambda: scatter.scatter_add_ref(
                         ids, g, nrows, mode), 3, warmup=1),
                     "library_ms": cuda_ms(lib, 50),
                     "bound_ms": bound, "bound_by": by,
                     "sha256": hashlib.sha256(out.tobytes()).hexdigest()})
    return rows


def _check_no_sort(rows):
    """B2 groups by itself up to ``ROW_LIMIT`` rows: no sort kernel among
    the device ops of such a launch (the profiler's names)."""
    from ncf_tpu_torch.ops import scatter

    for r in rows:
        if r["kernel"] != "onehot_scatter_add" or r["rows"] > scatter.ROW_LIMIT:
            continue
        ops = r["device_ops"]
        check(ops is not None, f"B2 {r['shape']}: no device ops measured")
        sorts = [k for k in ops if "sort" in k.lower() or "radix" in k.lower()]
        check(not sorts, f"B2 {r['shape']}: a sort on its route: {sorts}")


def _scatter_step_inputs(torch):
    """``_scatter_step_cases`` on config A's first batch with seeded
    stratified negatives, under ``set_scatter_impl("fast")``."""
    from ncf_tpu_torch.data import sample_negatives_stratified
    from ncf_tpu_torch.ops import embedding

    embedding.set_scatter_impl("fast")
    cfg, it, consts, _, _ = _training_setup(torch)
    batch = next(iter(it.epoch(1)))
    gen = torch.Generator(device="cuda").manual_seed(11)
    negs = sample_negatives_stratified(
        gen, torch.as_tensor(batch["item_ids"], device="cuda"),
        cfg.model.num_items, cfg.model.negative_samples, cdf=consts[0])
    return _scatter_step_cases(torch, batch, negs, cfg, consts)


def _log_scatter_rows(rows, tag):
    for r in rows:
        log(f"{tag}: B2 {r['shape']} {r['ids']} {r['ids_dtype']} into "
            f"{r['rows']} rows ({r['mode']}): events {r['ms']!r} ms, device "
            f"{r['device_ms']!r} ms, grouping {r['group_device_ms']!r} ms, "
            f"host {r['host_us']!r} us a call; index_add_ device "
            f"{r['library_device_ms']!r} ms; bound {r['bound_ms']!r} ms; "
            f"ops {json.dumps(r['device_ops'])}")


def _scatter_time_main(argv):
    """``--scatter-time ROOT``: B2's seven step launches timed with the
    package of the tree at ROOT (this one, or an earlier one unpacked
    beside it), on one JSON line."""
    import torch

    root = os.path.abspath(argv[argv.index("--scatter-time") + 1])
    sys.path.insert(0, root)
    torch.backends.cuda.matmul.allow_tf32 = False
    from ncf_tpu_torch.ops import _kernels

    check(os.path.abspath(_kernels.__file__).startswith(root + os.sep),
          f"scatter-time: imported {_kernels.__file__}, not {root}'s")
    secs = _kernels.build_all(["scatter_add", "tree_sampler"])
    rows = _time_scatter(torch, _scatter_step_inputs(torch))
    print("scatter_time_json: " + json.dumps(
        {"root": root, "build_s": secs, "rows": rows}), flush=True)
    return 0


def phase_scatter_ab(torch, parent):
    """B2 with an earlier tree's package (``parent``) and this tree's, in
    turns (parent, this, this, parent), each run a process of its own on
    the same seeded step inputs: every launch's result equal in all four
    runs; the rows of each."""
    runs = []
    for root in (parent, ROOT, ROOT, parent):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--scatter-time", root], capture_output=True,
                           text=True, timeout=900, cwd=ROOT)
        check(r.returncode == 0, f"scatter-time {root}: exit "
              f"{r.returncode}\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        line = [x for x in r.stdout.splitlines()
                if x.startswith("scatter_time_json: ")][-1]
        runs.append(json.loads(line.split(": ", 1)[1]))
        log(f"scatter_ab: {root} in {time.perf_counter() - t0:.1f} s")
        _log_scatter_rows(runs[-1]["rows"],
                          "parent" if root == parent else "change")
    for k, row in enumerate(runs[0]["rows"]):
        hashes = {run["rows"][k]["sha256"] for run in runs}
        check(len(hashes) == 1, f"scatter_ab: B2 {row['shape']} differs "
              f"between the trees or runs")
    log(f"scatter_ab: every launch equal bit for bit in the {len(runs)} runs")
    log("scatter_ab_json: " + json.dumps(runs))


def _time_training_kernels(torch, batch, negs, params, cfg, consts):
    """Each training kernel at the step's shapes: kernel, plain version,
    library call and bound.  Returns rows keyed by kernel and shape."""
    import torch.nn.functional as F

    from ncf_tpu_torch.models.temporal import sinusoidal_table
    from ncf_tpu_torch.ops import sampler, temporal_sum
    from ncf_tpu_torch.data.sampler import stratified_uniforms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    f32 = PEAK_FLOP_S["float32"]
    rows = []
    cdf, I = consts[0], cfg.model.num_items
    B = batch["user_ids"].shape[0]
    NEG = cfg.model.negative_samples

    def lib_b1(u, pos_bn):
        d = torch.searchsorted(cdf, u, right=True).clamp_(max=I - 1)
        pick = d[-1]
        for r in range(d.shape[0] - 2, -1, -1):
            pick = torch.where(d[r] != pos_bn, d[r], pick)
        return pick

    def empty():                 # one thread that spins for no cycles
        torch.cuda._sleep(0)

    # the card's floor for one launch, beside the µs-sized kernels B1, B3
    floor = {"launch_floor_ms": cuda_ms(empty, 50),
             "launch_floor_device_ms": device_split(empty)[0]}
    pos = torch.as_tensor(batch["item_ids"], device=dev)
    pooled = stratified_uniforms(gen, B * NEG, dev)[None]
    no_pos = torch.full((B * NEG,), -1, dtype=torch.int32, device=dev)
    iid = torch.rand((2, B * NEG), generator=gen, device=dev)
    for what, u, p in (("stratified", pooled, no_pos), ("iid", iid, pos)):
        NN = u.shape[1] // p.shape[0]
        pos_bn = p[:, None].expand(-1, NN).reshape(-1)
        # uniforms, CDF and ids; the positives only with a second round
        nbytes = (u.numel() * 4 + (p.numel() * 4 if u.shape[0] > 1 else 0)
                  + I * 4 + u.shape[1] * 4)
        ops = u.numel() * (I.bit_length() + 1)      # binary-search probes
        bound, by = _bound(nbytes, ops, f32)
        call = functools.partial(sampler.tree_sample_negatives, u, p, cdf, I)
        lib = functools.partial(lib_b1, u, pos_bn)
        rows.append({"kernel": "tree_sample_negatives", "shape": what,
                     "ms": cuda_ms(call, 50), **_device_fields(call, lib),
                     "plain_ms": cuda_ms(lambda: sampler.tree_sample_ref(
                         u, pos_bn, cdf, I), 5, warmup=1),
                     "library_ms": cuda_ms(lib, 50),
                     "bound_ms": bound, "bound_by": by, **floor})

    rows += _time_scatter(torch, _scatter_step_cases(torch, batch, negs,
                                                     cfg, consts))

    tables = [params["temporal"][k].detach() for k in ("hour", "day",
                                                       "month")]
    tables.append(sinusoidal_table(tables[0].shape[1], device=dev))
    ids = torch.stack([torch.as_tensor(batch[k], device=dev)
                       for k in ("hour", "day", "month", "day_of_year")])
    ids[3] %= 365
    bag = torch.cat(tables)                               # [408, dt]
    shift = torch.tensor([0, 24, 31, 43], device=dev)[:, None]
    bag_ids = (ids.long() + shift).T.contiguous()         # [B, 4]
    dt = tables[0].shape[1]
    nbytes = ids.numel() * 4 + bag.numel() * 4 + B * dt * 4
    bound, by = _bound(nbytes, 3 * B * dt, f32)
    call = functools.partial(temporal_sum.fused_lookup_sum, ids, tables)
    lib = functools.partial(F.embedding_bag, bag_ids, bag, mode="sum")
    rows.append({"kernel": "fused_lookup_sum", "shape": "step",
                 "ms": cuda_ms(call, 50), **_device_fields(call, lib),
                 "earlier_ms": EARLIER_MS[("fused_lookup_sum", "step")],
                 "plain_ms": cuda_ms(lambda: temporal_sum.lookup_sum_ref(
                     ids, tables), 50),
                 "library_ms": cuda_ms(lib, 50),
                 "bound_ms": bound, "bound_by": by, **floor})
    return rows


def _time_tower(torch):
    """B4f and B4b at the three tower shapes of the training steps and the
    two of the benchmark's training cells (dropout 0.2): the kernel call
    (CUDA events and profiler device time) beside its CUDA-core version's
    time (at the training steps' shapes), B4b's before its redesign for 16
    warps an SM (``B4B_BEFORE_MS``), its plain version, the plain layers
    that ``off`` runs instead (eager ``mlp_tower``, forward and forward +
    backward through autograd) and the bound.  No single PyTorch call
    computes the fused tower, so there is no library time.

    Bounds: B4f, its bf16 products against its bytes, and beside it
    ``philox_ms``, its masks' Philox draws (one per four activations) at
    the int32 rate.  B4b, the cheapest f32-faithful route on the tensor
    cores: the recomputed forward (one bf16 product), dW = h^T dz (h
    exact, dz in three bf16 pieces: three bf16 products) and dh = dz W^T
    (three TF32 products), against x, dy, dx and the parameters and their
    gradients once each; ``bound_f32_fma_ms`` is the bound stated for the
    CUDA-core kernel (four f32 products at the FMA rate)."""
    from ncf_tpu_torch.models.layers import mlp_tower
    from ncf_tpu_torch.ops import tower

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(41)
    rate = 0.2
    rows_out = []
    for rows, d0 in TOWER_SHAPES + CELL_TOWER_SHAPES:
        layers = _tower_layers(torch, d0, TOWER_HIDDEN, gen)
        flat = _tower_leaves(layers)
        x2 = torch.randn((rows, d0), generator=gen, device=dev).to(
            torch.bfloat16)
        dy = torch.randn((rows, TOWER_HIDDEN[-1]), generator=gen, device=dev)
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=gen, device=dev,
                             dtype=torch.int32)
        dims = [d0] + TOWER_HIDDEN
        macs = rows * sum(dims[i] * dims[i + 1] for i in range(3))
        n_params = sum(p.numel() for p in flat)
        fwd = functools.partial(tower._fwd_cuda, x2, seed, flat, rate)
        bwd = functools.partial(tower._bwd_cuda, x2, dy, seed, flat, rate)
        leaves = [p.detach().clone().requires_grad_(True) for p in flat]
        it = iter(leaves)
        tracked = [{"dense": {"w": next(it), "b": next(it)},
                    "norm": {"scale": next(it), "bias": next(it)}}
                   for _ in layers]

        def off_fwd():
            with torch.no_grad():
                mlp_tower(layers, x2, rate, gen, False, torch.bfloat16)

        def off_both():
            mlp_tower(tracked, x2, rate, gen, False,
                      torch.bfloat16).backward(dy)

        def fused_both():
            tower.fused_tower(tracked, x2, rate, gen, False).backward(dy)

        shape = f"[{rows}, {d0}]"
        b_f, by_f = _bound(rows * d0 * 2 + rows * dims[-1] * 4 + n_params * 4,
                           2 * macs, PEAK_FLOP_S["bfloat16"])
        bwd_bytes = rows * d0 * 4 + rows * dims[-1] * 4 + n_params * 8
        t_bytes = bwd_bytes / PEAK_BYTES_S * 1e3
        t_ops = (2 * macs * 4 / PEAK_FLOP_S["bfloat16"]
                 + 2 * macs * 3 / PEAK_FLOP_S["tf32"]) * 1e3
        b_b, by_b = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                          else "operations")
        fma_b, _ = _bound(bwd_bytes, 4 * macs, PEAK_FLOP_S["float32"])
        draws = rows * sum(-(-d // 4) for d in dims[1:])
        philox_ms = draws * PHILOX_OPS / PEAK_INT32_S * 1e3
        off_f, off_fb = cuda_ms(off_fwd, 20), cuda_ms(off_both, 10)
        for kernel, call, iters, plain, extra in (
                ("fused_tower_fwd", fwd, 20,
                 lambda: tower._fwd_ref(x2, seed, flat, rate),
                 {"off_path_ms": off_f, "bound_ms": b_f, "bound_by": by_f}),
                ("fused_tower_bwd", bwd, 10,
                 lambda: tower._bwd_ref(x2, dy, seed, flat, rate),
                 {"off_path_ms": off_fb,
                  "fused_fwd_bwd_ms": cuda_ms(fused_both, 10),
                  "bound_ms": b_b, "bound_by": by_b,
                  "bound_f32_fma_ms": fma_b})):
            pr7_ms, pr7_device_ms = EARLIER_MS.get((kernel, shape),
                                                   (None, None))
            if kernel == "fused_tower_bwd":
                extra["earlier_ms"] = B4B_BEFORE_MS[shape]
            rows_out.append({
                "kernel": kernel, "shape": shape, "ms": cuda_ms(call, iters),
                **_device_fields(call), "pr7_ms": pr7_ms,
                "pr7_device_ms": pr7_device_ms,
                "plain_ms": cuda_ms(plain, 3, warmup=1), "library_ms": None,
                "philox_ms": philox_ms, **extra})
        del layers, flat, leaves, tracked, x2, dy
        torch.cuda.empty_cache()
    return rows_out


def _time_step(torch, cfg, batches, consts, what, user_history=None):
    """Host-clock step time (median of five windows of 20), CUDA-event
    time and a profiler window of 20 steps; returns (summary, params, gen)."""
    from ncf_tpu_torch.models import advanced_ncf, get_model
    from ncf_tpu_torch.train import make_optimizer, make_train_step

    gen = torch.Generator(device="cuda").manual_seed(7)
    params = advanced_ncf.init(gen, cfg.model)
    opt = make_optimizer(cfg.train, steps_per_epoch=len(batches))
    state = opt.init(params)
    step = make_train_step(get_model("advanced_ncf"), cfg, opt, *consts,
                           user_history=user_history)
    box = {"p": params, "s": state, "g": gen, "i": 0}

    def one():
        b = batches[box["i"] % len(batches)]
        box["i"] += 1
        box["p"], box["s"], box["g"], _ = step(box["p"], box["s"], box["g"],
                                               b)

    for _ in range(5):
        one()
    # the host's clock varies with its neighbours: five windows, the median
    windows = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            one()
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) * 1e3 / 20)
    host_ms = statistics.median(windows)
    dev_ms = cuda_ms(one, 40, warmup=0)
    B = cfg.train.batch_size
    summary = {"what": what, "step_ms_host_clock": host_ms,
               "step_ms_windows": windows, "step_ms_cuda_events": dev_ms,
               "examples_per_s": B / (host_ms / 1e3), "batch": B}
    prof = device_profile(one, 20)
    if prof is not None:
        summary["device_ms_per_step"] = prof["device_ms_per_call"]
        summary["device_ops_per_step"] = prof["device_ops_per_call"]
        log("profile_json: " + json.dumps({"what": f"training step {what}",
                                           **prof}))
    log(f"training timing[{what}]: step {host_ms!r} ms (host clock, median "
        f"of 5 windows of 20: {windows}), {dev_ms!r} ms (CUDA events), "
        f"device {summary.get('device_ms_per_step')!r} ms and "
        f"{summary.get('device_ops_per_step')!r} operations a step, "
        f"{summary['examples_per_s']!r} examples/s at batch {B}")
    return summary, box["p"], box["g"]


def phase_training_timing(torch):
    """Step time and examples/s for config A (stratified, bf16, dropout
    0.2) under ``fused_tower`` auto and off in both candidate modes, and
    for config B; the training kernels' times."""
    from ncf_tpu_torch.data import sample_negatives_stratified
    from ncf_tpu_torch.ops import embedding

    embedding.set_scatter_impl("fast")
    steps = []
    cfg, it, consts, _, _ = _training_setup(torch)
    batches = list(it.epoch(1))
    for mode in ("joint", "independent"):
        for tower_mode in ("auto", "off"):
            cfg.model.candidate_mode, cfg.model.fused_tower = mode, tower_mode
            summary, params, gen = _time_step(
                torch, cfg, batches, consts, f"A {mode} {tower_mode}")
            steps.append(summary)
            if (mode, tower_mode) == ("joint", "auto"):
                main_params, main_gen = params, gen
            else:
                del params
    for path, name in ((QUALITY, "B quality"), (SEQUENCE, "B sequence")):
        bcfg, bit, bconsts, _, train_inter = _training_setup(torch, path)
        hist = train_inter.recent_history(bcfg.model.history_len)
        summary, params, _ = _time_step(
            torch, bcfg, list(bit.epoch(1)), bconsts,
            f"{name} {bcfg.model.candidate_mode} auto", hist)
        steps.append(summary)
        del params
    torch.cuda.empty_cache()
    cfg.model.candidate_mode, cfg.model.fused_tower = "joint", "auto"
    b = batches[0]
    negs = sample_negatives_stratified(
        main_gen, torch.as_tensor(b["item_ids"], device="cuda"),
        cfg.model.num_items, cfg.model.negative_samples, cdf=consts[0])
    rows = _time_training_kernels(torch, b, negs, main_params, cfg, consts)
    _check_no_sort(rows)
    rows += _time_tower(torch)
    for r in rows:
        log(f"timing: {r['kernel']} [{r['shape']}] kernel {r['ms']!r} ms "
            f"(device {r['device_ms']!r} ms), plain {r['plain_ms']!r} ms, "
            f"library {r['library_ms']!r} ms (device "
            f"{r.get('library_device_ms')!r} ms), off path "
            f"{r.get('off_path_ms')!r} ms, bound {r['bound_ms']!r} ms "
            f"({r['bound_by']})" + (
                f"; grouping {r['group_device_ms']!r} ms of device time, "
                f"host {r['host_us']!r} us a call, ops "
                f"{json.dumps(r['device_ops'])}; deterministic "
                f"library call (index_put_ accumulate) "
                f"{r['det_library_ms']!r} ms (device "
                f"{r['det_library_device_ms']!r} ms, repeats "
                f"{r['det_library_repeats']}, equals the kernel "
                f"{r['det_library_equals_kernel']})"
                if "group_device_ms" in r else "") + (
                f"; before the redesign {r['earlier_ms']!r} ms (events, "
                f"device)" if "earlier_ms" in r else "") + (
                f"; CUDA-core version (PR 7) {r['pr7_ms']!r} ms (device "
                f"{r['pr7_device_ms']!r} ms); Philox draws "
                f"{r['philox_ms']!r} ms at the int32 rate"
                if "pr7_ms" in r else "") + (
                f"; f32 FMA bound {r['bound_f32_fma_ms']!r} ms"
                if "bound_f32_fma_ms" in r else "") + (
                f"; an empty kernel {r['launch_floor_ms']!r} ms (device "
                f"{r['launch_floor_device_ms']!r} ms)"
                if "launch_floor_ms" in r else ""))
    log("training_timing_json: " + json.dumps(rows))
    log("training_json: " + json.dumps(steps))
    del main_params
    torch.cuda.empty_cache()
    return rows, steps


# ------------------------------------------------------- slice 4: kernels

NEUMF = os.path.join(ROOT, "configs", "neumf_ml1m.yaml")
NCF100K = os.path.join(ROOT, "configs", "ncf_ml100k.yaml")
INT8_OPS_S = 1979e12     # dense int8 tensor cores
NCF_SCORE_TOL = 5e-3     # probabilities: a bf16 flip in the tower moves a
                         # logit by up to ~1e-2


def _int8_cases(torch, topk, gen, dev):
    """B6 at the serving catalog and at one that does not divide the
    block, D 64 and 61, B 1 and 64 (and 1024), seg_top 1 and 2, k 1, 10
    and 64; then ties, real items below the padded rows' floor and fewer
    candidates than k.  Every case bit for bit."""
    n = 0
    for I, seg in ((4_000_000, 128), (1_000_003, 64)):
        for D in (64, 61):
            items = torch.randn((I, D), generator=gen, device=dev)
            bias = torch.randn((I,), generator=gen, device=dev)
            qs = torch.randn((1024, D), generator=gen, device=dev)
            prep = topk.prepare_items_int8(items, bias, qs.abs().amax(0)[None],
                                           seg_width=seg)
            del items, bias
            cases = [(B, st, k) for B in (1, 64) for st in (1, 2)
                     for k in (1, 10, 64)]
            if D == 64:
                cases.append((1024, 1, 10) if seg == 128 else (1024, 2, 64))
            for B, st, k in cases:
                q = qs[:B]
                kv, ki = topk.topk_scores_streaming_int8(q, prep, k,
                                                         seg_top=st)
                torch.cuda.synchronize()
                rv, ri = topk.topk_scores_streaming_int8_ref(q, prep, k,
                                                             seg_top=st)
                check(torch.equal(ki, ri) and torch.equal(kv, rv),
                      f"B6 I={I} D={D} B={B} seg={seg}/{st} k={k}: kernel "
                      "!= plain version")
                n += 1
            del prep, qs
            torch.cuda.empty_cache()
    items = torch.randint(-1, 2, (20_000, 8), generator=gen,
                          device=dev).float()
    q = torch.randint(-1, 2, (9, 8), generator=gen, device=dev).float()
    low = torch.full((300, 8), -1.0, device=dev)
    low[:, 0] += torch.linspace(0, 0.5, 300, device=dev)
    for it, b, qq, block, seg, k in (
            (items, torch.ones(20_000, device=dev), q, 512, 32, 64),
            (low, torch.full((300,), -1e9, device=dev),
             torch.ones((3, 8), device=dev), 256, 64, 10),
            (items[:200], None, q, 64, 64, 10)):
        prep = topk.prepare_items_int8(it, b, qq, block_items=block,
                                       seg_width=seg)
        for st in (1, 2):
            kv, ki = topk.topk_scores_streaming_int8(qq, prep, k, seg_top=st)
            torch.cuda.synchronize()
            rv, ri = topk.topk_scores_streaming_int8_ref(qq, prep, k,
                                                         seg_top=st)
            check(torch.equal(ki, ri) and torch.equal(kv, rv),
                  f"B6 ties/floor/fill I={it.shape[0]} seg={seg}/{st}: "
                  "kernel != plain version")
            n += 1
    return n


def _gather_cases(torch, gather, gen, dev):
    """B7 bit for bit against ``gather_rows_ref``: the serving tables
    (NeuMF, NCF) with 2-D, int32 and one-column ids; every row size of
    the kernel's plans (4 to 2,048 bytes: one word, an odd count of
    4-byte words, groups of 4 to 32 threads, a loop within the group);
    a table view 4 bytes off 8-byte alignment (the narrow word); 0 ids
    (no launch), 1, and counts off a block's rows; negative and
    non-contiguous ids.  Each launch is counted.  Returns the cases."""
    n7 = 0

    def case(table, i, what):
        nonlocal n7
        n0 = gather.gather_rows.launches.value
        got = gather.gather_rows(table, i)
        torch.cuda.synchronize()
        check(gather.gather_rows.launches.value == n0 + (i.numel() > 0),
              f"B7 {what}: launches counted wrong")
        check(torch.equal(got, gather.gather_rows_ref(table, i)),
              f"B7 {what} {tuple(table.shape)} {table.dtype} ids "
              f"{tuple(i.shape)} {i.dtype}: kernel != plain version")
        n7 += 1

    for rows, d, dtype in ((3706, 64, torch.float32), (6040, 64, torch.float32),
                           (3706, 64, torch.bfloat16),
                           (1682, 32, torch.bfloat16),
                           (1000, 34, torch.bfloat16), (500, 3, torch.float32)):
        table = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
        ids = torch.randint(0, rows, (64, 3706), generator=gen, device=dev)
        for i in (ids, ids.to(torch.int32), ids[:, :1]):
            case(table, i, "serving")
    for row_bytes in (4, 12, 64, 68, 128, 256, 512, 516, 2048):
        table = torch.randn((3001, row_bytes // 4), generator=gen,
                            device=dev)
        for n in (1, 255, 257, 40_003):
            ids = torch.randint(-3001, 3001, (n,), generator=gen, device=dev)
            case(table, ids, f"{row_bytes}-byte rows, n {n}")
            case(table, ids.to(torch.int32), f"{row_bytes}-byte rows, n {n}")
    big = torch.randn((4001, 33), generator=gen, device=dev)
    table = big[1:]                               # 132 bytes in
    check(table.data_ptr() % 8 == 4, "B7: the offset view is 8-aligned")
    ids = torch.randint(-4000, 4000, (64, 3706), generator=gen, device=dev)
    for i in (ids, ids.t(), ids[:, ::3], ids.to(torch.int32).t(),
              ids[:0]):
        case(table, i, "a view 4 bytes off, negative ids")
    return n7


def phase_slice4_kernels_vs_plain(torch, topk):
    """B6 and B7 bit for bit against their plain versions; B8 and B9
    through ``compare_topk`` with the queries in f32 (both kernels keep
    them so), and bit for bit on small-integer data (exact sums).
    Returns {kernel: max |kernel - plain|}."""
    from ncf_tpu_torch.ops import gather

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    errs = dict.fromkeys(("topk_scores_streaming_int8", "gather_rows",
                          "topk_scores_pallas", "topk_scores_segmented"), 0.0)
    t0 = time.perf_counter()
    n6 = _int8_cases(torch, topk, gen, dev)
    log(f"kernel_vs_plain: topk_scores_streaming_int8 {n6} cases equal bit "
        f"for bit ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    n7 = _gather_cases(torch, gather, gen, dev)
    log(f"kernel_vs_plain: gather_rows {n7} cases equal bit for bit "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    n8 = n9 = swaps = 0
    key_share = {}                       # B9: share of keys that differ
    # the rule's control: keys from one TF32 product (both operands rounded
    # to TF32, products exact in f32, summed in f32), held to the same rule
    control = {}
    for I in (100_003, 1_000_000):
        t32 = torch.randn((I, 64), generator=gen, device=dev)
        b = torch.randn((I,), generator=gen, device=dev)
        for B in (1, 64):
            q = torch.randn((B, 64), generator=gen, device=dev)
            for table in (t32, t32.to(torch.bfloat16)):
                for bias in (b, None):
                    for k in (10, 64, 256):
                        kv, ki = topk.topk_scores_pallas(q, table, k, bias)
                        torch.cuda.synchronize()
                        rv, ri = topk.topk_scores_pallas_ref(q, table, k,
                                                             bias)
                        e, s = compare_topk(
                            kv, ki, rv, ri, q, table, bias,
                            f"B8 I={I} B={B} {table.dtype} bias="
                            f"{bias is not None} k={k}", cast_q=False)
                        errs["topk_scores_pallas"] = max(
                            errs["topk_scores_pallas"], e)
                        swaps, n8 = swaps + s, n8 + 1
            for seg in (128, 32):
                for bias in (b, None):
                    kv, ki = topk.topk_scores_segmented(q, t32, 10, bias,
                                                        seg_width=seg)
                    torch.cuda.synchronize()
                    rv, ri = topk.topk_scores_segmented_ref(q, t32, 10, bias,
                                                            seg_width=seg)
                    e, s = compare_topk(
                        kv, ki, rv, ri, q, t32, bias,
                        f"B9 I={I} B={B} seg={seg} bias={bias is not None}",
                        cast_q=False)
                    errs["topk_scores_segmented"] = max(
                        errs["topk_scores_segmented"], e)
                    swaps, n9 = swaps + s, n9 + 1
        # the keys themselves, under the rule of csrc/topk_segmax.cu, at
        # batches on both sides of the user tiles, both table types
        t_one = tf32_rna(t32)            # a bf16 table is TF32 already
        for B in (1, 5, 64, 65):
            q = torch.randn((B, 64), generator=gen, device=dev)
            for table in (t32, t32.to(torch.bfloat16)):
                one_t = t_one if table.dtype == torch.float32 else table
                for seg in (128, 64, 32):
                    for bias in ((b, None) if B == 64 else (b,)):
                        keys = topk._segmax_cuda(q, table, bias, 2048, seg)
                        torch.cuda.synchronize()
                        want = topk.segmax_keys_ref(q, table, bias, 2048, seg)
                        what = (f"I={I} B={B} {str(table.dtype)[6:]} "
                                f"seg={seg} bias={bias is not None}")
                        differ, bad = topk.segmax_key_violations(
                            q, table, bias, keys, want, seg)
                        check(bad == 0, f"B9 keys {what}: {bad} of {differ} "
                              "differing keys outside the rule")
                        key_share[what] = differ / keys.numel()
                        one = topk.segmax_keys_ref(tf32_rna(q), one_t, bias,
                                                   2048, seg)
                        control[what] = topk.segmax_key_violations(
                            q, table, bias, one, want, seg)[1]
                        n9 += 1
        del t32, t_one, b
        torch.cuda.empty_cache()
    # small integers: exact sums, so values, ids and keys are equal; items
    # with a NEG_INF bias never surface, empty slots repeat the fill id
    t = torch.randint(-1, 2, (9_000, 16), generator=gen, device=dev).float()
    q = torch.randint(-1, 2, (17, 16), generator=gen, device=dev).float()
    b = torch.randint(0, 2, (9_000,), generator=gen, device=dev).float()
    b[:8_990] = NEG_INF
    for bias, k in ((None, 200), (b, 30)):
        for block in (2048, 512):
            got = topk.topk_scores_pallas(q, t, k, bias, block_items=block)
            want = topk.topk_scores_pallas_ref(q, t, k, bias,
                                               block_items=block)
            check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                  f"B8 ties/empty k={k} block={block}: kernel != plain")
            n8 += 1
    for seg in (128, 64, 32):
        keys = topk._segmax_cuda(q, t, None, 2048, seg)
        torch.cuda.synchronize()
        check(torch.equal(keys, topk.segmax_keys_ref(q, t, None, 2048, seg)),
              f"B9 integer keys seg={seg}: kernel != plain version")
        n9 += 1
    log(f"kernel_vs_plain: topk_scores_pallas {n8} cases, "
        f"topk_scores_segmented {n9} cases ok, max_abs_err "
        f"{json.dumps(errs)}, near-tie id swaps {swaps} "
        f"({time.perf_counter() - t0:.1f} s)")
    log("kernel_vs_plain: B9 share of keys that differ from the plain "
        "version's (each within the rule) " + json.dumps(key_share))
    log("kernel_vs_plain: B9 rule control, keys of one TF32 product outside "
        "the rule (the kernel: 0 in every case) " + json.dumps(control))
    # at 1M items and 5 users or more, one TF32 product must break the rule
    # in every case (6 to 482 segments in the H100 runs), as the kernel
    # never does: the rule tells the precision the tile pays for
    passed = [w for w, v in control.items()
              if w.startswith("I=1000000 ") and " B=1 " not in w and v == 0]
    check(not passed, f"B9: one TF32 product keeps the key rule in {passed}")
    return errs


# ------------------------------------------------------- slice 4: serving

def _served_scores(scorer, uids, s, i, k, mod, bias, exclude, rescored,
                   what):
    """Served int8-tier or exact-kernel answers: (hits of the exact
    top-k, slots, max |score - exact probability of the served id|).
    Rows must be sorted and free of repeats; rescored scores must be
    their ids' exact probabilities (1e-5)."""
    import numpy as np
    import torch

    hits, total = _check_served(scorer, uids, s, i, k, mod=mod, bias=bias,
                                exclude=exclude, exact=False, what=what)
    s = np.asarray(s, np.float64).reshape(len(uids), -1)
    i = np.asarray(i).reshape(len(uids), -1)
    check(all(len(set(r)) == len(r) for r in i.tolist()),
          f"{what}: an id repeats")
    check(bool((np.diff(s, axis=1) <= 1e-7).all()), f"{what}: not sorted")
    q = scorer.user_queries[torch.as_tensor(np.asarray(uids),
                                            device=scorer.device).long()]
    if mod is not None:
        q = q * mod[None, :]
    sc, _ = exact_scores(q, scorer.item_vecs, bias,
                         torch.as_tensor(i, device=scorer.device))
    want = (1.0 / (1.0 + torch.exp(-sc))).cpu().numpy()
    err = float(np.abs(s - want).max())
    if rescored:
        check(err <= 1e-5, f"{what}: scores are not the exact ones ({err!r})")
    return hits, total, err


def phase_serving_int8(torch, topk, big, ModelServer):
    """Bigvocab served under ``int8`` and ``int8-fast`` (B6; the 60-item
    exclusion at k=4 takes the bf16 tier's B5 branch under ``int8``),
    each request held against the same request with the plain B6 on the
    card (equal ids and scores) and against the exact top-k (recall, and
    exact scores under ``int8``); then ``AdvancedNCFScorer`` with
    ``impl="pallas"`` (B8, exact) and ``"segmented"`` (B9), each kernel
    then held against its plain version on the inputs it was served.
    Returns (launches by kernel, summary, {kernel: max |kernel - plain|})."""
    import numpy as np

    from ncf_tpu_torch.serving import AdvancedNCFScorer

    cfg, params, dept, cat, rng = big
    U, I = cfg.model.num_users, cfg.model.num_items
    b5 = topk.topk_scores_streaming.launches
    b6 = topk.topk_scores_streaming_int8.launches
    b8 = topk.topk_scores_pallas.launches
    b9 = topk.topk_scores_segmented.launches
    temporal = {"hour": 18, "day": 4, "month": 11, "day_of_year": 320}
    users = rng.choice(U, size=64, replace=False).astype(np.int32)
    summary = {}
    b5_0 = b5.value
    for c in (b6, b8, b9):
        c.reset()
    for preset in ("int8", "int8-fast"):
        cfg.serving.retrieval = preset
        t0 = time.perf_counter()
        server = ModelServer(cfg, params=params, item_dept=dept,
                             item_cat=cat, device="cuda")
        scorer = server.scorer
        try:
            bias0 = scorer.item_bias(None)
            bias_t = scorer.item_bias(temporal)
            mod, hbias = scorer._hour_mod(8), scorer._hourly_item_bias(8)
            u = int(users[0])
            seen = rng.choice(I, size=60, replace=False).astype(np.int32)
            seen[:3] = server.recommend(u, k=3)[1]
            torch.cuda.synchronize()
            log(f"serving[{preset}]: server, biases and int8 table ready in "
                f"{time.perf_counter() - t0:.1f} s")
            requests = [
                ("recommend", [u], 10, None, bias0, None,
                 lambda: server.recommend(u, k=10)[:2]),
                ("temporal", [u], 10, None, bias_t, None,
                 lambda: server.recommend(u, k=10, temporal=temporal)[:2]),
                ("hourly", [u], 10, mod, hbias, None,
                 lambda: server.recommend_hourly(u, hour=8, k=10)[:2]),
                ("batch", users, 10, None, bias0, None,
                 lambda: server.recommend_batch(users, k=10)[:2]),
                ("batch temporal", users, 10, None, bias_t, None,
                 lambda: server.recommend_batch(users, k=10,
                                                temporal=temporal)[:2]),
                ("exclusion", [u], 4, None, bias0, seen[None, :],
                 lambda: server.recommend(u, k=4,
                                          exclude_items=seen.tolist())[:2])]
            hits = total = 0
            worst = 0.0
            for what, uids, k, m, b, excl, fn in requests:
                n5, n6 = b5.value, b6.value
                s, i = fn()
                if what == "exclusion" and preset == "int8":
                    check(b5.value > n5 and b6.value == n6,
                          f"{preset} {what}: the B5 branch was not taken")
                else:
                    check(b6.value > n6, f"{preset} {what}: B6 not launched")
                if excl is not None:
                    check(not set(excl[0].tolist()) & set(i.tolist()),
                          f"{preset}: an excluded item was served")
                h, n, e = _served_scores(scorer, uids, s, i, k, m, b, excl,
                                         preset == "int8",
                                         f"{preset} {what}")
                hits, total, worst = hits + h, total + n, max(worst, e)
                real = topk.topk_scores_streaming_int8
                topk.topk_scores_streaming_int8 = (
                    topk.topk_scores_streaming_int8_ref)
                try:
                    ps, pi = fn()
                finally:
                    topk.topk_scores_streaming_int8 = real
                check(np.array_equal(i, pi) and np.array_equal(s, ps),
                      f"{preset} {what}: the kernel's answer differs from "
                      "the plain B6's on the card")
            recall = hits / total
            # the share of item biases that saturate the int8 bias range
            # (|bias| / q_scale > 32322): the tier's recall falls with it
            prep = scorer._prepared((), bias0)
            clipped = float(((bias0 / prep.q_scale).abs()
                             > topk._BIAS_INT_LIM).float().mean())
            one = [server.recommend(int(users[j % 64]), k=10)[2]
                   for j in range(40)]
            many = [server.recommend_batch(users, k=10)[2] for _ in range(20)]
            summary[preset] = {
                "recall_at_10_vs_exact": recall, "slots": total,
                "q_scale": float(prep.q_scale), "bias_clipped_share": clipped,
                "max_abs_score_vs_exact": worst,
                "p50_ms_1_user": float(np.median(one)),
                "p50_ms_64_users": float(np.median(many))}
            log(f"serving[{preset}]: {len(requests)} request kinds equal the "
                f"plain B6 path; recall@10 vs exact {recall!r} over {total} "
                f"slots ({clipped!r} of the biases clip), max |score - "
                f"exact| {worst!r}; p50 "
                f"{summary[preset]['p50_ms_1_user']!r} ms (1 user), "
                f"{summary[preset]['p50_ms_64_users']!r} ms (64 users)")
        finally:
            server.close()
        del server, scorer
        torch.cuda.empty_cache()
    cfg.serving.retrieval = "exact"

    dept_t = torch.as_tensor(dept, device="cuda")
    cat_t = torch.as_tensor(cat, device="cuda")
    held = {}
    for impl, counter in (("pallas", b8), ("segmented", b9)):
        sc = AdvancedNCFScorer(params, cfg.model, dept_t, cat_t, impl=impl)
        bias0 = sc.item_bias(None)
        n0 = counter.value
        s1, i1 = sc.topk_for_users(users[:1], k=10)
        s64, i64 = sc.topk_for_users(users, k=10)
        check(counter.value - n0 == 2, f"impl={impl}: kernel launches")
        exact = impl == "pallas"
        h, n = _check_served(sc, users, s64, i64, 10, bias=bias0,
                             exact=exact, what=f"impl={impl}")
        h1, n1 = _check_served(sc, users[:1], s1, i1, 10, bias=bias0,
                               exact=exact, what=f"impl={impl} 1 user")
        _, _, err = _served_scores(sc, users, s64, i64, 10, None, bias0,
                                   None, True, f"impl={impl}")
        t = []
        for j in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sc.topk_for_users(users[j:j + 1], k=10)
            t.append((time.perf_counter() - t0) * 1e3)
        tb = []
        for _ in range(5):
            t0 = time.perf_counter()
            sc.topk_for_users(users, k=10)
            tb.append((time.perf_counter() - t0) * 1e3)
        summary[f"impl={impl}"] = {
            "recall_at_10_vs_exact": (h + h1) / (n + n1),
            "ids_user0": i1[0].tolist(), "max_abs_score_vs_exact": err,
            "p50_ms_1_user": float(np.median(t)),
            "p50_ms_64_users": float(np.median(tb))}
        log(f"serving[impl={impl}]: 1 and 64 users, recall@10 vs exact "
            f"{(h + h1) / (n + n1)!r}, ids of user 0 {i1[0].tolist()}, "
            f"p50 {float(np.median(t))!r} ms (1 user), "
            f"{float(np.median(tb))!r} ms (64 users)")
        held[impl] = (sc.user_query(users), sc.item_vecs, bias0)
        del sc
        torch.cuda.empty_cache()
    launches = {"topk_scores_streaming": b5.value - b5_0,
                "topk_scores_streaming_int8": b6.value,
                "topk_scores_pallas": b8.value,
                "topk_scores_segmented": b9.value}
    log(f"serving_int8: launches {json.dumps(launches)}")

    # each kernel against its plain version on the queries, table and
    # bias the served path gave it (4M items, 1 and 64 users, k=10); these
    # launches come after the count above was read
    refs = {"pallas": ("topk_scores_pallas", topk.topk_scores_pallas_ref),
            "segmented": ("topk_scores_segmented",
                          topk.topk_scores_segmented_ref)}
    errs, swaps = {}, 0
    for impl, (q, items, bias) in held.items():
        name, ref = refs[impl]
        errs[name] = 0.0
        for qb in (q[:1], q):
            kv, ki = topk.topk_scores(qb, items, 10, bias, impl=impl)
            torch.cuda.synchronize()
            rv, ri = ref(qb, items, 10, bias)
            e, s = compare_topk(kv, ki, rv, ri, qb, items, bias,
                                f"served impl={impl} B={qb.shape[0]} "
                                f"I={items.shape[0]}", cast_q=False)
            errs[name], swaps = max(errs[name], e), swaps + s
    del held
    torch.cuda.empty_cache()
    log(f"serving_int8: kernel vs plain on the served inputs, max_abs_err "
        f"{json.dumps(errs)}, near-tie id swaps {swaps}")
    return launches, summary, errs


def phase_serving_ncf(torch, ModelServer, Config):
    """NeuMF (``neumf_ml1m.yaml``, 6040 x 3706) and NCF
    (``ncf_ml100k.yaml``, 943 x 1682) as shipped (bf16 compute), seeded
    random weights with the embedding tables at std 0.3 (0.01 leaves every
    score ~0.5), served through ``ModelServer`` -> ``BruteForceScorer``:
    on the card under ``set_impl("pallas")`` (every request launches B7),
    equal bit for bit to the card under ``"xla"`` (no B7 launch), and to
    the CPU within ``NCF_SCORE_TOL`` (ids equal wherever the CPU's scores
    of the two rivals differ by more).  Returns (B7 launches, summary)."""
    import numpy as np

    from ncf_tpu_torch.convert import tree_map
    from ncf_tpu_torch.models import get_model
    from ncf_tpu_torch.ops import embedding, gather

    b7 = gather.gather_rows.launches
    b7.reset()
    summary = {}
    for path, (U, I) in ((NEUMF, (6040, 3706)), (NCF100K, (943, 1682))):
        cfg = Config.from_yaml(path)
        cfg.model.num_users, cfg.model.num_items = U, I
        name = cfg.model.name
        gen = torch.Generator(device="cuda").manual_seed(21)
        params = get_model(name).init(gen, cfg.model)
        for key in ("gmf_user", "gmf_item", "mlp_user", "mlp_item"):
            params[key] *= 30.0
        host = tree_map(lambda t: t.detach().to("cpu", copy=True), params)
        rng = np.random.default_rng(7)
        users = rng.choice(U, 64, replace=False)
        u = int(users[0])
        seen = rng.choice(I, 30, replace=False).tolist()
        items = rng.choice(I, 20, replace=False)
        calls = [("recommend", lambda s: s.recommend(u, k=10)[:2]),
                 ("exclusion", lambda s: s.recommend(
                     u, k=10, exclude_items=seen)[:2]),
                 ("hourly", lambda s: s.recommend_hourly(u, hour=8,
                                                         k=10)[:2]),
                 ("batch", lambda s: s.recommend_batch(users, k=10)[:2]),
                 ("predictions", lambda s: (s.get_predictions(u, items),
                                            items))]
        cpu = ModelServer(cfg, params=host, device="cpu")
        results = {}
        try:
            for where, impl in (("pallas", "pallas"), ("xla", "xla")):
                embedding.set_impl(impl)
                server = ModelServer(cfg, params=params, device="cuda")
                try:
                    out = []
                    for what, fn in calls:
                        n0 = b7.value
                        out.append(fn(server))
                        check((b7.value > n0) == (impl == "pallas"),
                              f"{name} {what} under {impl}: B7 launches")
                    results[where] = out
                    if impl == "pallas":
                        one = [server.recommend(int(users[j % 64]), k=10)[2]
                               for j in range(20)]
                        many = [server.recommend_batch(users, k=10)[2]
                                for _ in range(10)]
                finally:
                    server.close()
            embedding.set_impl("xla")
            results["cpu"] = [fn(cpu) for _, fn in calls]
            worst, swaps = 0.0, 0
            for (what, _), a, b, c in zip(calls, results["pallas"],
                                          results["xla"], results["cpu"]):
                check(all(np.array_equal(np.asarray(x), np.asarray(y))
                          for x, y in zip(a, b)),
                      f"{name} {what}: the B7 path differs from xla")
                gs, gi = np.atleast_2d(a[0]), np.atleast_2d(a[1])
                cs, ci = np.atleast_2d(c[0]), np.atleast_2d(c[1])
                check(np.isfinite(gs[gs > -np.inf]).all()
                      and gs.shape == cs.shape, f"{name} {what}: bad scores")
                err = float(np.abs(gs - cs).max())
                worst = max(worst, err)
                check(err <= NCF_SCORE_TOL,
                      f"{name} {what}: card vs CPU scores differ by {err!r}")
                uids = users if what == "batch" else [u]
                for r, j in zip(*np.nonzero(gi != ci)):
                    pair = cpu.get_predictions(int(uids[r]),
                                               [gi[r, j], ci[r, j]])
                    check(abs(float(pair[0] - pair[1])) <= NCF_SCORE_TOL,
                          f"{name} {what}: ids differ where the scores are "
                          "not tied")
                    swaps += 1
        finally:
            embedding.set_impl("xla")
            cpu.close()
        summary[name] = {"users": U, "items": I,
                         "max_score_diff_vs_cpu": worst,
                         "near_tie_id_swaps": swaps,
                         "p50_ms_1_user": float(np.median(one)),
                         "p50_ms_64_users": float(np.median(many))}
        log(f"serving_ncf[{name}]: {U}x{I}, {len(calls)} request kinds equal "
            f"under pallas and xla on the card, card vs CPU max |score "
            f"diff| {worst!r} ({swaps} near-tie id swaps); p50 "
            f"{summary[name]['p50_ms_1_user']!r} ms (1 user), "
            f"{summary[name]['p50_ms_64_users']!r} ms (64 users)")
        del params, host
        torch.cuda.empty_cache()
    log(f"serving_ncf: B7 launches {b7.value}")
    return b7.value, summary


def _ptxas_report(_kernels, name):
    """``nvcc -Xptxas -v`` of ``csrc/<name>.cu``: each kernel's registers,
    spills and shared memory, as ptxas prints them."""
    src = os.path.join(os.path.dirname(_kernels.__file__), "csrc",
                       name + ".cu")
    out = os.path.join(_kernels.BUILD_DIR, f"ptxas_{name}.so")
    r = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas",
                        "-v", "-o", out, src], capture_output=True,
                       text=True, timeout=300)
    check(r.returncode == 0, f"nvcc -Xptxas -v {name}: {r.stderr}")
    return " | ".join(line.strip() for line in
                      (r.stdout + r.stderr).splitlines()
                      if "registers" in line or "spill" in line
                      or "Compiling entry" in line)


def enqueue_us(fn, iters=50):
    """Host microseconds a call of ``fn`` takes to return (the launch's
    enqueue; the card is left to finish afterwards)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def _time_gather(torch, gather, gen, dev, rounds=2):
    """B7 at NeuMF's and NCF's serving scans (64 users x 3706 candidates):
    [3706, 64] f32 (256-byte rows), [3706, 64] bf16 (128) and [1682, 32]
    bf16 (64).  Each round times, in turn, the kernel, ``index_select``
    (the library call) and the plain version, by CUDA events over 50
    calls and by the profiler's device time, and the kernel's host
    enqueue µs a call.  Returns a row a shape."""
    out = []
    ids = torch.randint(0, 3706, (64, 3706), generator=gen, device=dev,
                        dtype=torch.int32)
    n = ids.numel()
    for rows_, d, dtype in ((3706, 64, torch.float32),
                            (3706, 64, torch.bfloat16),
                            (1682, 32, torch.bfloat16)):
        table = torch.randn((rows_, d), generator=gen, device=dev).to(dtype)
        i = ids % rows_ if rows_ != 3706 else ids
        fi = i.reshape(-1)
        row_bytes = d * table.element_size()
        bound, by = _bound(n * 4 + n * row_bytes + table.numel()
                           * table.element_size(), 0, PEAK_FLOP_S["float32"])
        call = functools.partial(gather.gather_rows, table, i)
        lib = functools.partial(torch.index_select, table, 0, fi)
        plain = functools.partial(gather.gather_rows_ref, table, i)
        t = {"ms": [], "device_ms": [], "host_us": [], "library_ms": [],
             "library_device_ms": [], "plain_ms": []}
        for _ in range(rounds):
            t["ms"].append(cuda_ms(call, 50))
            t["device_ms"].append(device_split(call)[0])
            t["host_us"].append(enqueue_us(call))
            t["library_ms"].append(cuda_ms(lib, 50))
            t["library_device_ms"].append(device_split(lib)[0])
            t["plain_ms"].append(cuda_ms(plain, 50))
        plan = gather.launch_plan(
            row_bytes, table.data_ptr(), call().data_ptr(), n,
            gather._sm_count(torch.cuda.current_device()))
        row = {"kernel": "gather_rows",
               "shape": f"[{rows_}, {d}] {str(dtype)[6:]} x {n} ids",
               "bound_ms": bound, "bound_by": by, "plan": plan._asdict(),
               "rounds": t}
        for k, v in t.items():
            v = [x for x in v if x is not None]   # None: not measured
            row[k] = sum(v) / len(v) if v else None
        row["share_of_bound_events"] = bound / row["ms"]
        row["share_of_bound_device"] = (bound / row["device_ms"]
                                        if row["device_ms"] else None)
        out.append(row)
        log(f"timing: gather_rows [{row['shape']}] CUDA events "
            f"{t['ms']} ms, device {t['device_ms']} ms, host "
            f"{t['host_us']} us a call; index_select {t['library_ms']} "
            f"[{t['library_device_ms']}] ms; plain {t['plain_ms']} ms; "
            f"bound {bound!r} ms ({by}); plan {json.dumps(row['plan'])}")
    return out


def phase_timing_slice4(torch, topk):
    """B6, B8 and B9 at the bigvocab serving shape (B=64, 4M items, D=64;
    B6 also at B=1) and B7 at NeuMF's scan (3706 x 64 f32, 64 users x
    3706 candidates): kernel (CUDA events and profiler device time), plain
    version, library call and bound.  Returns rows keyed by kernel."""
    import torch.nn.functional as F

    from ncf_tpu_torch.ops import gather

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(77)
    f32 = PEAK_FLOP_S["float32"]
    rows = []
    I, D = 4_000_000, 64
    items = torch.randn((I, D), generator=gen, device=dev)
    bias = torch.randn((I,), generator=gen, device=dev)
    qs = torch.randn((64, D), generator=gen, device=dev)
    prep = topk.prepare_items_int8(items, bias, qs.abs().amax(0)[None],
                                   seg_width=128)
    ipad, K = prep.table.shape
    k = 16                                # k=10 plus the int8 over-fetch
    for B in (64, 1):
        q = qs[:B]
        call = functools.partial(topk.topk_scores_streaming_int8, q, prep, k)
        lib = lib_dev = None
        if B > 16:                        # torch._int_mm takes > 16 rows
            kp = -(-K // 8) * 8
            q8 = F.pad(topk._quantize_queries(q, prep), (0, kp - K))
            t8 = F.pad(prep.table, (0, kp - K))

            def lib_call():
                return torch.topk(torch._int_mm(q8, t8.t()), k)

            try:
                lib = cuda_ms(lib_call, 10)
                lib_dev = device_split(lib_call)[0]
            except RuntimeError as e:
                log(f"timing: B6 library call refused ({e!r})")
            del q8, t8
        bound, by = _bound(ipad * K + B * K + B * k * 8, 2.0 * B * ipad * K,
                           INT8_OPS_S)
        dev_ms, split = device_split(call)
        rows.append({"kernel": "topk_scores_streaming_int8",
                     "shape": f"B={B} I={I} D={D} seg 128/1 k={k}",
                     "ms": cuda_ms(call, 20), "device_ms": dev_ms,
                     "device_passes_ms": _passes(split, "seg_topk"),
                     "dp4a_ms": EARLIER_MS[("topk_scores_streaming_int8",
                                            B)],
                     "plain_ms": cuda_ms(lambda: topk.topk_scores_streaming_int8_ref(
                         q, prep, k), 3, warmup=1),
                     "library_ms": lib, "library_device_ms": lib_dev,
                     "bound_ms": bound, "bound_by": by})
    del prep
    torch.cuda.empty_cache()
    q, k = qs, 10
    nbytes = I * D * 4 + I * 4 + 64 * D * 4
    call = functools.partial(topk.topk_scores_pallas, q, items, k, bias)

    def lib_b8():
        return torch.topk(q @ items.T + bias, k)

    dev_ms, split = device_split(call)
    rows.append({"kernel": "topk_scores_pallas",
                 "shape": f"B=64 I={I} D={D} f32 k={k}",
                 "ms": cuda_ms(call, 10), "device_ms": dev_ms,
                 "device_passes_ms": _passes(split, "exact_tc"),
                 "cuda_core_ms": CUDA_CORE_MS[
                     ("topk_scores_pallas", 64, I, "float32")],
                 "plain_ms": cuda_ms(lambda: topk.topk_scores_pallas_ref(
                     q, items, k, bias), 3, warmup=1),
                 "library_ms": cuda_ms(lib_b8, 5),
                 "library_device_ms": device_split(lib_b8)[0],
                 **_tc_bounds(nbytes + 64 * k * 8, 64, I, D, "float32")})
    off = torch.arange(128, dtype=torch.int32, device=dev)

    def lib_b9(q):
        # the same keys from one unchunked product (1 GB of scores at
        # B=64): q @ items.T + bias, the key pack and a max per segment
        i = torch.addmm(bias, q, items.T).view(torch.int32)
        mono = i ^ ((i >> 31) & 0x7FFFFFFF)
        return ((mono & -128).view(q.shape[0], -1, 128) | off).amax(2)

    for B in (64, 1):
        q = qs[:B]
        nkeys = B * (-(-I // 2048) * 2048 // 128)
        call = functools.partial(topk._segmax_cuda, q, items, bias, 2048, 128)
        lib = functools.partial(lib_b9, q)
        rows.append({"kernel": "topk_scores_segmented",
                     "shape": f"B={B} I={I} D={D} f32 seg 128",
                     "ms": cuda_ms(call, 10), **_device_fields(call, lib),
                     "earlier_ms": EARLIER_MS.get(
                         ("topk_scores_segmented", B)),
                     "plain_ms": cuda_ms(lambda: topk.segmax_keys_ref(
                         q, items, bias, 2048, 128), 3, warmup=1),
                     "library_ms": cuda_ms(lib, 5),
                     "with_topk_and_rescore_ms": cuda_ms(
                         lambda: topk.topk_scores_segmented(q, items, k,
                                                            bias), 10),
                     **_tc_bounds(I * D * 4 + I * 4 + B * D * 4 + nkeys * 4,
                                  B, I, D, "float32")})
    del items, bias, qs, q
    torch.cuda.empty_cache()
    rows += _time_gather(torch, gather, gen, dev)
    for r in rows:
        was = (f" (CUDA-core version: {r['cuda_core_ms']!r} ms; device "
               f"by pass "
               f"{json.dumps(r['device_passes_ms'])}, f32 FMA bound "
               f"{r['bound_f32_fma_ms']!r} ms)" if "cuda_core_ms" in r
               else f" (__dp4a version: {r['dp4a_ms']!r} ms [device]; "
               f"device by pass {json.dumps(r['device_passes_ms'])})"
               if "dp4a_ms" in r else
               f" (CUDA-core version: {r['earlier_ms']!r} ms [device]; f32 "
               f"FMA bound {r['bound_f32_fma_ms']!r} ms; with top-k and "
               f"rescore {r['with_topk_and_rescore_ms']!r} ms)"
               if "earlier_ms" in r else "")
        log(f"timing: {r['kernel']} [{r['shape']}] kernel {r['ms']!r} ms "
            f"(device {r['device_ms']!r} ms){was}, plain {r['plain_ms']!r} "
            f"ms, library {r['library_ms']!r} ms (device "
            f"{r.get('library_device_ms')!r} ms), bound {r['bound_ms']!r} ms "
            f"({r['bound_by']})")
    log("slice4_timing_json: " + json.dumps(rows))
    return rows

# ------------------------------------------------- the Trainer and the gate

SMOKE_DIR = os.path.join(ROOT, "_smoke")     # git-ignored scratch space
TRAINER_SAVES = 3         # mid-epoch checkpoints an epoch, trainer phase
TRAINER_EPOCHS = 2
VARIANCE = os.path.join(ROOT, "results", "variance.jsonl")
# scripts/seed_study.py::build_cfg as overrides of advanced_ncf_ml1m.yaml
# (the yaml already sets the widths, dropout, bf16, batch 16384, the
# learning rate, the decay, 100 eval negatives and the synthetic log)
GATE_COMMON = ["data.validation_days=10", "train.early_stopping_patience=8",
               "train.lr_schedule=cosine", "train.log_every_steps=200",
               "train.steps_per_dispatch=1"]
# recipe -> (overrides, the epochs budget its reference rows were run at,
# seeds of the reference band)
GATE_RECIPES = {
    "indep40": (["model.candidate_mode=independent", "train.num_epochs=40",
                 "train.early_stopping_metric=hr@10"], 40, 5),
    "indep_seq": (["model.candidate_mode=independent",
                   "model.use_sequence=true", "model.history_len=50",
                   "train.num_epochs=40",
                   "train.early_stopping_metric=hr@10"], 40, 5),
    "joint": (["model.candidate_mode=joint", "train.num_epochs=24",
               "train.early_stopping_metric=val_loss"], 24, 3),
}
TRAINER_KERNELS = ("tree_sample_negatives", "onehot_scatter_add",
                   "fused_lookup_sum", "fused_tower_fwd", "fused_tower_bwd")


def _clone_tree(torch, tree):
    from ncf_tpu_torch.convert import tree_map

    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else x, tree)


def _trees_equal(torch, a, b, what):
    from ncf_tpu_torch.train.checkpoint import _leaves_with_path

    la, lb = dict(_leaves_with_path(a)), dict(_leaves_with_path(b))
    check(la.keys() == lb.keys(), f"{what}: the trees differ in their leaves")
    differ = [k for k in la if not torch.equal(la[k], lb[k])]
    check(not differ, f"{what}: leaves differ in their bits: {differ[:5]}")
    return len(la)


class _Warnings:
    """Collect the warnings a logger emits while it is entered."""

    def __init__(self, name):
        import logging

        self.logger, self.records = logging.getLogger(name), []
        self.handler = logging.Handler(logging.WARNING)
        self.handler.emit = self.records.append

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)

    def text(self):
        return " ".join(r.getMessage() for r in self.records)


def _trainer_cfg(ckpt_dir, spd=None):
    from ncf_tpu_torch.utils.config import Config

    cfg = Config.from_yaml(ML1M)
    cfg.train.checkpoint_dir = ckpt_dir
    if spd is not None:
        cfg.train.steps_per_dispatch = spd
    return cfg


def _jax_format_copy(src, dst):
    """``src`` with its rng leaf replaced by a JAX key (uint32[2], as the
    JAX package's ``Trainer`` saves it under its default generator)."""
    import shutil

    import numpy as np

    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    with open(os.path.join(dst, "manifest.json")) as f:
        manifest = json.load(f)
    meta = manifest["leaves"]["rng"]
    np.save(os.path.join(dst, meta["file"]), np.asarray([0, 1], np.uint32))
    meta["dtype"] = "uint32"
    with open(os.path.join(dst, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return dst


def phase_trainer(torch, card):
    """The ``Trainer`` on ``advanced_ncf_ml1m.yaml`` as shipped (autotuned
    steps per dispatch, the device epoch pipeline, ``TRAINER_SAVES``
    mid-epoch checkpoints an epoch) over the ML-1M-scale synthetic
    log: ``TRAINER_EPOCHS`` epochs, then ``validate``.  A second Trainer
    resumes from the first mid-epoch checkpoint and finishes epoch 0 in
    the same bits as the uninterrupted run; a third loads that checkpoint
    with a JAX key as its rng leaf and must warn.  Returns (launches of
    the training kernels through the Trainer, summary)."""
    import shutil

    import numpy as np

    from ncf_tpu_torch.train import Trainer
    from ncf_tpu_torch.train import checkpoint as ckpt_lib

    root = os.path.join(SMOKE_DIR, "trainer")
    shutil.rmtree(root, ignore_errors=True)
    cfg = _trainer_cfg(os.path.join(root, "a"))
    check(cfg.model.fused_tower == "auto", "trainer: fused_tower is not auto")
    inter, _ = _data(cfg)
    counters = _launch_counters()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    t = Trainer(cfg, inter)
    setup_s = time.perf_counter() - t0
    K = cfg.train.steps_per_dispatch
    check(t.device_pipeline is not None, "trainer: no device pipeline")
    steps = len(t.device_pipeline)
    # three mid-epoch checkpoints an epoch, at the K autotune chose
    every = -(-steps // K) // TRAINER_SAVES
    check(every > 0, f"trainer: {steps} steps in dispatches of {K} leave no "
          f"room for a mid-epoch checkpoint")
    cfg.train.checkpoint_every_dispatches = every
    log(f"trainer: set up in {setup_s:.1f} s (autotune chose "
        f"steps_per_dispatch={K}), {steps} steps an epoch of "
        f"{cfg.train.batch_size}, {len(t.train_inter)} train rows, a "
        f"checkpoint every {every} dispatches")
    epochs = []
    snapshot = None
    for e in range(TRAINER_EPOCHS):
        m = t.train_epoch(e)
        check(np.isfinite(m.get("loss", 0.0)), f"trainer: epoch {e} loss")
        epochs.append({"epoch": e, "seconds": m["epoch_seconds"],
                       "examples_per_s": m["examples_per_s"],
                       "ms_per_step": m["epoch_seconds"] / steps * 1e3,
                       "loss": m.get("loss")})
        log(f"trainer: epoch {e} {m['epoch_seconds']!r} s, "
            f"{m['examples_per_s']!r} examples/s, "
            f"{m['epoch_seconds'] / steps * 1e3!r} ms a step; {card}")
        if e == 0:
            # the uninterrupted run's state after epoch 0, and its first
            # mid-epoch checkpoint (copied: retention may delete it)
            mids = [p for p, m_ in _mid_epoch(cfg.train.checkpoint_dir)
                    if m_["epoch"] == 0]
            check(mids, "trainer: no mid-epoch checkpoint in epoch 0")
            first = shutil.copytree(mids[0], os.path.join(root, "mid0"))
            snapshot = (_clone_tree(torch, t.params),
                        _clone_tree(torch, t.opt_state), t.global_step)
    t0 = time.perf_counter()
    val = t.validate(TRAINER_EPOCHS - 1)
    torch.cuda.synchronize()
    validate_s = time.perf_counter() - t0
    launches = {k: counters[k].value for k in TRAINER_KERNELS}
    for k, n in launches.items():
        check(n > 0, f"trainer: {k} never launched through the Trainer")
    check(all(np.isfinite(v) for v in val.values()),
          f"trainer: validate gave {val}")
    chance = 10.0 / (1 + cfg.data.num_eval_negatives)
    check(val["hr@10"] > chance, f"trainer: hr@10 {val['hr@10']!r} is not "
          f"above chance {chance!r} after {TRAINER_EPOCHS} epochs")
    log(f"trainer: validate {validate_s!r} s, val_loss {val['val_loss']!r}, "
        f"hr@10 {val['hr@10']!r}; launches {json.dumps(launches)}")

    # the mid-epoch resume, bit for bit
    params0, opt0, step0 = snapshot
    cfg_b = _trainer_cfg(os.path.join(root, "b"), spd=K)
    tb = Trainer(cfg_b, inter)
    check(tb.resume(first), "trainer: resume failed")
    with open(os.path.join(first, "manifest.json")) as f:
        dispatch = json.load(f)["extra"]["dispatch"]
    check(tb.start_epoch == 0 and tb._resume_dispatch == dispatch,
          "trainer: resume did not re-enter epoch 0")
    tb.train_epoch(0)
    check(tb.global_step == step0, f"trainer: resumed run at step "
          f"{tb.global_step}, the uninterrupted one at {step0}")
    n = _trees_equal(torch, tb.params, params0, "trainer: resumed params")
    n += _trees_equal(torch, tb.opt_state, opt0, "trainer: resumed moments")
    log(f"trainer: resumed from dispatch {dispatch} of epoch 0 and finished "
        f"it: {n} leaves of params and Adam state equal bit for bit")
    del tb

    # a checkpoint whose rng leaf is a JAX key: loads, warns
    jdir = _jax_format_copy(first, os.path.join(root, "jax_format"))
    tc = Trainer(_trainer_cfg(os.path.join(root, "c"), spd=K), inter)
    with _Warnings("ncf_tpu_torch.train.trainer") as w:
        check(tc.resume(jdir), "trainer: resume of the JAX-format copy")
    check("no rng key" in w.text(), "trainer: no warning for the JAX key")
    want, _ = ckpt_lib.restore(first, {"params": tc.params})
    _trees_equal(torch, tc.params, want["params"], "trainer: JAX-format "
                 "params")
    log(f"trainer: the JAX-format copy loaded and warned: {w.text()!r}")
    del tc, t
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return launches, {"steps_per_dispatch": K, "setup_s": setup_s,
                      "steps_per_epoch": steps, "epochs": epochs,
                      "validate_s": validate_s,
                      "val_loss": val["val_loss"], "hr@10": val["hr@10"],
                      "resume_dispatch": dispatch, "launches": launches}


def _mid_epoch(ckpt_dir):
    out = []
    for name in sorted(os.listdir(ckpt_dir)):
        mf = os.path.join(ckpt_dir, name, "manifest.json")
        if os.path.isfile(mf):
            with open(mf) as f:
                m = json.load(f)
            if (m.get("extra") or {}).get("in_epoch"):
                out.append((os.path.join(ckpt_dir, name), m))
    return out


def _reference_bands():
    """recipe -> {"sampled"/"full": (mean, sd, N)} of hr@10 over the
    reference's seeds (``results/variance.jsonl``, the rows at the epochs
    budget of ``GATE_RECIPES``)."""
    rows = [json.loads(x) for x in open(VARIANCE) if x.strip()]
    out = {}
    for recipe, (_, epochs, n) in GATE_RECIPES.items():
        mine = [r for r in rows if r["config"] == recipe
                and r["epochs_budget"] == epochs]
        check(len(mine) == n, f"gate: {len(mine)} reference rows for "
              f"{recipe}, want {n}")
        out[recipe] = {p: (statistics.mean(r[p]["hr@10"] for r in mine),
                           statistics.stdev(r[p]["hr@10"] for r in mine), n)
                       for p in ("sampled", "full")}
    return out


def _cli(argv):
    """Run the port's CLI in this process; (exit code, its stdout)."""
    import contextlib
    import io

    from ncf_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def _gate_run(recipe, seed, card, keep=False):
    """One recipe at one seed through the port's CLI: ``train``, then
    ``evaluate --protocol full`` on the best checkpoint.  With ``keep``
    the run's directory stays (``run["dir"]``, its overrides under
    ``run["overrides"]``) for the caller to delete."""
    import ast
    import shutil

    from ncf_tpu_torch.train import checkpoint as ckpt_lib

    d = os.path.join(SMOKE_DIR, "gate", f"{recipe}_s{seed}")
    shutil.rmtree(d, ignore_errors=True)
    ov = (GATE_COMMON + GATE_RECIPES[recipe][0]
          + [f"train.seed={seed}", f"train.checkpoint_dir={d}",
             f"train.metrics_file={os.path.join(d, 'metrics.jsonl')}"])
    common = ["--config", ML1M, "--log-level", "WARNING"]
    t0 = time.perf_counter()
    rc, _ = _cli(["train"] + common + ov)
    train_s = time.perf_counter() - t0
    check(rc == 0, f"gate[{recipe} s{seed}]: train exited {rc}")
    best = ckpt_lib.find_best(d)
    check(best is not None, f"gate[{recipe} s{seed}]: no best checkpoint")
    with open(os.path.join(best, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(d, "metrics.jsonl")) as f:
        vals = [json.loads(x) for x in f]
    curve = [[r["epoch"], round(r["hr@10"], 5), round(r["val_loss"], 5)]
             for r in vals if r["kind"] == "val"]
    t0 = time.perf_counter()
    rc, out = _cli(["evaluate", "--protocol", "full"] + common + ov)
    eval_s = time.perf_counter() - t0
    check(rc == 0, f"gate[{recipe} s{seed}]: evaluate exited {rc}")
    full = next(ast.literal_eval(line.partition(" ")[2])
                for line in out.splitlines() if line.startswith("full "))
    run = {"recipe": recipe, "seed": seed, "best_epoch": manifest["epoch"],
           "epochs_run": len(curve),
           "sampled_hr10": manifest["metrics"]["hr@10"],
           "full_hr10": full["hr@10"], "train_s": train_s, "eval_s": eval_s}
    log(f"gate[{recipe} s{seed}]: {json.dumps(run)}; {card}")
    log(f"gate[{recipe} s{seed}]: epoch, hr@10, val_loss {json.dumps(curve)}")
    if keep:
        return dict(run, dir=d, best=best, overrides=ov)
    shutil.rmtree(d, ignore_errors=True)
    return run


def _memoized_interactions():
    """The CLI builds its log anew on every call; the generator is
    deterministic, so the gate builds each log once."""
    from ncf_tpu_torch import cli

    load, cache = cli._load_interactions, {}

    def cached(cfg):
        key = json.dumps(cfg.to_dict()["data"], sort_keys=True)
        if key not in cache:
            cache[key] = load(cfg)
        return cache[key]

    cli._load_interactions = cached


def phase_gate(torch, card, full_gate):
    """The quality gate through the port's CLI.  By default ``indep40`` at
    seed 0, which must land in the single-run band of the reference's
    seeds (|x - mean| <= 3 sd sqrt(1 + 1/N)) in sampled and full hr@10;
    with ``full_gate`` every recipe at its N seeds, each mean within
    3 sqrt(sd_ref^2/N_ref + sd_port^2/N_port) of the reference's.
    Returns (seconds, the default run with its kept directory, or None
    with ``full_gate``)."""
    import math

    _memoized_interactions()
    bands = _reference_bands()
    t_phase = time.perf_counter()
    runs = []
    plan = ([(r, s) for r, (_, _, n) in GATE_RECIPES.items()
             for s in range(n)] if full_gate else [("indep40", 0)])
    for recipe, seed in plan:
        runs.append(_gate_run(recipe, seed, card, keep=not full_gate))
    misses, table = [], []
    for recipe in dict.fromkeys(r for r, _ in plan):
        mine = [r for r in runs if r["recipe"] == recipe]
        for proto in ("sampled", "full"):
            mean_r, sd_r, n_r = bands[recipe][proto]
            xs = [r[f"{proto}_hr10"] for r in mine]
            mean_p = statistics.mean(xs)
            sd_p = statistics.stdev(xs) if len(xs) > 1 else None
            if full_gate:
                limit = 3 * math.sqrt(sd_r ** 2 / n_r
                                      + sd_p ** 2 / len(xs))
            else:
                limit = 3 * sd_r * math.sqrt(1 + 1 / n_r)
            ok = abs(mean_p - mean_r) <= limit
            row = {"recipe": recipe, "protocol": proto, "n_port": len(xs),
                   "port_mean": mean_p, "port_sd": sd_p,
                   "ref_mean": mean_r, "ref_sd": sd_r, "n_ref": n_r,
                   "limit": limit, "gap": mean_p - mean_r, "ok": ok,
                   "wall_s": sum(r["train_s"] + r["eval_s"] for r in mine)}
            table.append(row)
            log(f"gate: {recipe} {proto} hr@10 port {mean_p!r} (sd {sd_p!r}, "
                f"N {len(xs)}) vs reference {mean_r!r} (sd {sd_r!r}, N "
                f"{n_r}): gap {mean_p - mean_r!r}, limit {limit!r} -> "
                f"{'in' if ok else 'OUT OF'} band")
            if not ok:
                misses.append(f"{recipe} {proto}")
    added = time.perf_counter() - t_phase
    log("gate_json: " + json.dumps({"runs": runs, "table": table,
                                    "seconds": added, "card": card}))
    check(not misses, f"gate: out of band: {misses}")
    return added, (None if full_gate else runs[0])


# ------------------------------------------------------------ API (A3)

API_REC = "/api/v1/recommendations"
API_BATCH = "/api/v1/recommendations/batch"
API_INTEL = "/api/v1/intelligence"
API_TIMING = ("inference_time_ms", "total_time_ms", "uptime_s")
API_ITERS = (200, 200)    # timed requests of 1 and of 64 customers


def _api_call(api, method, path, body, what):
    """``api.dispatch``; any status but 2xx fails the run (a kernel that
    fails inside a request surfaces only as a 500)."""
    status, payload = api.dispatch(method, path, body)
    check(200 <= status < 300, f"api {what}: status {status}: {payload}")
    return payload


def _http(url, body=None, timeout=60):
    """(status, decoded body, headers) of one request to the API."""
    import urllib.error
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        url, data=data, method="POST" if data is not None else "GET",
        headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw, status, headers = resp.read(), resp.status, resp.headers
    except urllib.error.HTTPError as e:
        raw, status, headers = e.read(), e.code, e.headers
    ctype = headers.get("Content-Type", "")
    return (status, json.loads(raw) if ctype.startswith("application/json")
            else raw.decode(), dict(headers))


def _http_ok(url, body, what):
    status, payload, _ = _http(url, body)
    check(200 <= status < 300, f"http {what}: status {status}: {payload}")
    return payload


def _untimed(x):
    if isinstance(x, dict):
        return {k: _untimed(v) for k, v in x.items() if k not in API_TIMING}
    if isinstance(x, list):
        return [_untimed(v) for v in x]
    return x


def _same_recs(recs, scores, ids, what, tol=0.0):
    """An answer's records against (scores, ids) of ``ModelServer``: equal
    ids and ranks, scores equal (``tol`` 0) or within ``tol``.  Returns
    the largest score difference."""
    import numpy as np

    got_ids = [int(r["product_id"]) for r in recs]
    check(got_ids == [int(i) for i in ids],
          f"{what}: ids {got_ids} != the server's {list(map(int, ids))}")
    check([r["rank"] for r in recs] == list(range(1, len(recs) + 1)),
          f"{what}: ranks")
    err = float(np.max(np.abs(np.asarray([r["score"] for r in recs])
                              - np.asarray(scores, np.float64))))
    check(err <= tol, f"{what}: scores differ from the server's by {err}")
    return err


def _pcts(ms):
    import numpy as np

    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "max_ms": float(np.max(ms)), "n": len(ms)}


def _timed_ms(fn):
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _no_errors(api, what):
    summary = api.metrics.summary()
    check(summary.get("errors", 0) == 0,
          f"{what}: {summary.get('errors')} error records in the metrics")
    return summary


def _api_requests(api, server, users, what):
    """Single and batch requests through ``dispatch``, each held to the
    same request of ``ModelServer`` in this call; their latencies beside
    ``ModelServer.recommend``'s.  Returns the latency summary."""
    import numpy as np

    u = int(users[0])
    body1 = {"customer_id": str(u), "num_recommendations": 10}
    rec = _api_call(api, "POST", API_REC, body1, f"{what} single")
    s, i, _ = server.recommend(u, k=10)
    _same_recs(rec["recommendations"], s, i, f"{what} single")
    temporal = {"hour": 18, "day": 4, "month": 11, "day_of_year": 320}
    rec = _api_call(api, "POST", API_REC, dict(body1, context={"hour": 18,
                    "day": 4, "month": 11, "day_of_year": 320}),
                    f"{what} temporal")
    s, i, _ = server.recommend(u, k=10, temporal=temporal)
    _same_recs(rec["recommendations"], s, i, f"{what} temporal")
    body64 = {"customer_ids": [str(int(x)) for x in users],
              "num_recommendations": 10}
    batch = _api_call(api, "POST", API_BATCH, body64, f"{what} batch")
    s, i, _ = server.recommend_batch(users, k=10)
    check(len(batch["results"]) == len(users), f"{what} batch: results")
    for r, res in enumerate(batch["results"]):
        check(res["customer_id"] == str(int(users[r])), f"{what} batch: ids")
        _same_recs(res["recommendations"], s[r], i[r], f"{what} batch {r}")

    n1, n64 = API_ITERS
    one, direct, many = [], [], []
    for j in range(n1):
        uj = int(users[j % len(users)])
        direct.append(_timed_ms(lambda: server.recommend(uj, k=10)))
        one.append(_timed_ms(lambda: api.dispatch(
            "POST", API_REC, {"customer_id": str(uj),
                              "num_recommendations": 10})))
    for _ in range(n64):
        many.append(_timed_ms(lambda: api.dispatch("POST", API_BATCH,
                                                   body64)))
    out = {"dispatch_1": _pcts(one), "dispatch_64": _pcts(many),
           "recommend_1": _pcts(direct)}
    for n, fn in ((1, lambda: api.dispatch("POST", API_REC, body1)),
                  (64, lambda: api.dispatch("POST", API_BATCH, body64))):
        prof = device_profile(fn, 20)
        if prof is not None:
            log("profile_json: " + json.dumps(
                {"what": f"api dispatch[{what}] {n} customer(s)", **prof}))
            out[f"dispatch_{n}_profile"] = {
                k: prof[k] for k in ("busy_share", "device_ms_per_call",
                                     "host_self_ms_per_call")}
    return out


def _api_http(api, server, users, what):
    """The API over loopback (``serve(..., background=True)``): single and
    batch POSTs equal to ``dispatch``'s answers apart from the timing
    fields, 64 threads each POSTing one customer at once (coalesced
    behind the handler; ids equal to ``dispatch``'s, scores within 1e-6),
    ``GET /demo``, and the latencies of 1 and 64 customers."""
    import threading

    from ncf_tpu_torch.api import serve
    from ncf_tpu_torch.api.demo_page import DEMO_HTML

    httpd = serve(api, host="127.0.0.1", port=0, background=True)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        u = int(users[0])
        body1 = {"customer_id": str(u), "num_recommendations": 10}
        body64 = {"customer_ids": [str(int(x)) for x in users],
                  "num_recommendations": 10}
        for path, body in ((API_REC, body1), (API_BATCH, body64)):
            got = _http_ok(base + path, body, f"{what} {path}")
            want = _api_call(api, "POST", path, body, f"{what} {path}")
            check(_untimed(got) == _untimed(want),
                  f"http {what} {path}: the answer differs from dispatch's")
        status, html, headers = _http(base + "/demo")
        check(status == 200 and html == DEMO_HTML
              and headers.get("Content-Type", "").startswith("text/html")
              and "no-store" in headers.get("Cache-Control", ""),
              f"http {what}: GET /demo")

        want = {int(x): _api_call(api, "POST", API_REC,
                                  {"customer_id": str(int(x))},
                                  f"{what} single {int(x)}")
                for x in users}
        got, errors = {}, []
        barrier = threading.Barrier(len(users))

        def post(uid):
            try:
                barrier.wait(timeout=60)
                got[uid] = _http(base + API_REC, {"customer_id": str(uid)})
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))

        coal = server._coalescer
        b0 = coal.batched_calls if coal is not None else 0
        threads = [threading.Thread(target=post, args=(int(x),))
                   for x in users]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        check(not errors and not any(t.is_alive() for t in threads),
              f"http {what}: concurrent POSTs failed: {errors[:3]}")
        worst = 0.0
        for uid, (status, payload, _) in got.items():
            check(status == 200, f"http {what} concurrent {uid}: {status}")
            w = want[uid]["recommendations"]
            worst = max(worst, _same_recs(
                payload["recommendations"], [r["score"] for r in w],
                [r["product_id"] for r in w], f"http {what} concurrent {uid}",
                tol=1e-6))
        batched = coal.batched_calls - b0 if coal is not None else 0
        log(f"api_http[{what}]: 64 concurrent POSTs answered, {batched} "
            f"coalesced batches, largest score difference to dispatch "
            f"{worst!r}")

        n1, n64 = API_ITERS
        one = [_timed_ms(lambda j=j: _http_ok(
            base + API_REC, {"customer_id": str(int(users[j % len(users)])),
                             "num_recommendations": 10}, what))
            for j in range(n1)]
        many = [_timed_ms(lambda: _http_ok(base + API_BATCH, body64, what))
                for _ in range(n64)]
    finally:
        httpd.shutdown()
        httpd.server_close()
    return {"http_1": _pcts(one), "http_64": _pcts(many),
            "concurrent_64": {"coalesced_batches": batched,
                              "max_score_diff": worst}}


def _api_intelligence(api, server, u, what):
    """The dashboard route with and without ``hour``, under the gather
    kernel B7 (``set_impl("pallas")``), held to ``recommend`` and
    ``recommend_hourly`` and, apart from the timing fields, equal to the
    same request's answer under ``"xla"`` (the gather is exact, so every
    statistic agrees bit for bit); then health, metrics and index
    refresh, after which the single request answers as before.  Returns
    (metrics, {table: [the ids the route gathered]})."""
    import numpy as np

    from ncf_tpu_torch.ops import embedding

    gathered = {"user_emb": [], "item_emb": []}
    for hour in (None, 9):
        body = {"customer_id": str(u), "num_recommendations": 10}
        if hour is not None:
            body["hour"] = hour
        embedding.set_impl("pallas")
        try:
            out = _api_call(api, "POST", API_INTEL, body,
                            f"{what} intelligence hour={hour}")
        finally:
            embedding.set_impl("xla")
        plain = _api_call(api, "POST", API_INTEL, body,
                          f"{what} intelligence hour={hour} xla")
        check(_untimed(out) == _untimed(plain),
              f"{what} intelligence hour={hour}: the payload under B7 "
              f"differs from the plain gather's")
        s, i, _ = (server.recommend(u, k=10) if hour is None
                   else server.recommend_hourly(u, hour=hour, k=10))
        _same_recs(out["recommendations"], s, i,
                   f"{what} intelligence hour={hour}")
        intel = out["intelligence"]
        heads = np.asarray(intel["attention_head_importance"])
        check(len(heads) == server.cfg.model.num_heads
              and np.isfinite(heads).all()
              and abs(sum(intel["component_importance"].values()) - 1)
              < 1e-6 and len(intel["normalized_scores"]) == 10,
              f"{what} intelligence: payload {intel}")
        # the route's gathers: its 32 sample users and their candidates
        sample = np.arange(min(32, server.cfg.model.num_users))
        gathered["user_emb"].append(sample)
        gathered["item_emb"].append(np.tile(np.asarray(i)[None, :],
                                            (len(sample), 1)))
    body1 = {"customer_id": str(u), "num_recommendations": 10}
    before = _api_call(api, "POST", API_REC, body1, f"{what} single")
    check(_api_call(api, "GET", "/health", None, what)["status"] == "healthy",
          f"{what}: health")
    refreshed = _api_call(api, "POST", "/api/v1/index/refresh", {},
                          f"{what} refresh")
    check(refreshed["status"] == "refreshed", f"{what}: refresh {refreshed}")
    after = _api_call(api, "POST", API_REC, body1, f"{what} single")
    check(_untimed(after) == _untimed(before),
          f"{what}: the answer moved across an index refresh")
    return _api_call(api, "GET", "/metrics", None, f"{what} metrics"), gathered


def _b7_route_check(torch, gather, params, gathered):
    """B7 against ``gather_rows_ref``, bit for bit, on the tables the
    intelligence route gathered from (the user table, [12M, 128] f32, is
    5.7 GiB, past 32-bit byte offsets): the route's own ids, and rows
    spread over each table to its last (int64 and int32 ids).  Returns
    the number of cases."""
    n = 0
    for name, ids in gathered.items():
        table = params[name]
        rows = table.shape[0]
        spread = torch.cat([
            torch.arange(0, rows, max(rows // 4096, 1), device="cuda"),
            torch.tensor([rows - 1], device="cuda")])
        cases = [torch.as_tensor(i, dtype=torch.long, device="cuda")
                 for i in ids] + [spread, spread.to(torch.int32)]
        for i in cases:
            got = gather.gather_rows(table, i)
            torch.cuda.synchronize()
            check(torch.equal(got, gather.gather_rows_ref(table, i)),
                  f"B7 on the intelligence route's {name} "
                  f"{list(table.shape)} ids {tuple(i.shape)} {i.dtype}: "
                  f"kernel != plain version")
            n += 1
    return n


def _search_case(torch, topk, ps, plain, q, res, what):
    """Hold ``find_neighbors``'s answer for queries ``q`` through
    ``compare_topk`` against ``plain``, the plain version of the kernel
    that answered (the exact top-k where none launched); recall@k
    against the exact top-k.  Returns (max |value - plain|, recall)."""
    import numpy as np

    qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    qt = torch.from_numpy(np.ascontiguousarray(qn)).to("cuda")
    kv = torch.tensor([[v for _, v in r] for r in res], dtype=torch.float32,
                      device="cuda")
    ki = torch.tensor([[i for i, _ in r] for r in res], dtype=torch.long,
                      device="cuda")
    k = kv.shape[1]
    rv, ri = plain(qt, ps._emb, k)
    err, _ = compare_topk(kv, ki, rv, ri, qt, ps._emb, None, what,
                          cast_q=False)
    _, ei = topk.topk_scores_xla(qt, ps._emb, k)
    hits = sum(len(set(a) & set(b)) for a, b in zip(ki.tolist(), ei.tolist()))
    return err, hits / ki.numel()


def _api_search(torch, topk, server, users):
    """``ProductSearch`` over the server's item MLP embeddings (cosine) at
    ``impl`` ``"auto"`` (B5 at B=64; B=1 takes the dense path),
    ``"pallas"`` (B8) and ``"segmented"`` (B9), queries the users' MLP
    embeddings, B=64 and 1: each answer held by ``compare_topk``
    against the plain version, each kernel's counter must rise;
    ``find_neighbors``'s host and device ms at B=64.  Returns (summary,
    {kernel: max |kernel - plain|})."""
    import numpy as np

    from ncf_tpu_torch.serving import ProductSearch

    I = server.cfg.model.num_items
    t0 = time.perf_counter()
    emb = server.get_product_embedding(np.arange(I))["mlp"]
    q = server.get_user_embedding(users)["mlp"]
    log(f"api_search: {list(emb.shape)} item embeddings in "
        f"{time.perf_counter() - t0:.1f} s")
    kernels = {"auto": "topk_scores_streaming", "pallas": "topk_scores_pallas",
               "segmented": "topk_scores_segmented"}
    summary, errs = {}, {}
    for impl, name in kernels.items():
        counter = getattr(topk, name).launches
        t0 = time.perf_counter()
        ps = ProductSearch(emb, metric="cosine", impl=impl, device="cuda")
        build_s = time.perf_counter() - t0
        n0 = counter.value
        res64 = ps.find_neighbors(q, 10)
        n64 = counter.value - n0
        res1 = ps.find_neighbors(q[:1], 10)
        n1 = counter.value - n0 - n64
        check(n64 == 1 and n1 == (0 if impl == "auto" else 1),
              f"ProductSearch[{impl}]: {name} launches {n64}, {n1}")
        ref = getattr(topk, name + "_ref")

        def plain(n):     # the kernel's plain version where it launched
            return ref if n else topk.topk_scores_xla

        e64, r64 = _search_case(torch, topk, ps, plain(n64), q, res64,
                                f"ProductSearch[{impl}] B=64")
        e1, r1 = _search_case(torch, topk, ps, plain(n1), q[:1], res1,
                              f"ProductSearch[{impl}] B=1")
        errs[name] = max(e64, e1)
        host = [_timed_ms(lambda: ps.find_neighbors(q, 10))
                for _ in range(20)]
        host1 = [_timed_ms(lambda: ps.find_neighbors(q[:1], 10))
                 for _ in range(20)]
        device_ms = device_split(lambda: ps.find_neighbors(q, 10), 10)[0]
        summary[impl] = {
            "kernel_b64": name, "build_s": build_s,
            "host_ms_b64": float(np.median(host)),
            "host_ms_b1": float(np.median(host1)),
            "device_ms_b64": device_ms, "recall_at_10_vs_exact_b64": r64,
            "recall_at_10_vs_exact_b1": r1, "max_abs_err_vs_plain": errs[name],
            "stats": ps.get_index_stats()}
        log(f"api_search[{impl}]: {json.dumps(summary[impl])}")
        del ps
        torch.cuda.empty_cache()
    return summary, errs


def phase_api(torch, topk, big, ModelServer, card):
    """The HTTP API over the bigvocab server at full width (12M users x
    4M items): ``RecommendationAPI`` without a feature processor, through
    ``dispatch``, under ``retrieval="exact"`` (B5) and ``"int8"`` (B6):
    single, temporal and 64-customer requests equal to ``ModelServer``'s
    answers in this call; under ``exact`` also the intelligence route with
    and without ``hour`` (B7 through ``set_impl("pallas")``), health,
    metrics and index refresh, ``ProductSearch`` at 4M items (B5, B8,
    B9), and the same API over loopback HTTP (single, batch, 64
    concurrent POSTs, ``/demo``).  Any 5xx or error record fails the
    run.  Returns ({kernel: launches}, summary, {kernel: max |kernel -
    plain|})."""
    import numpy as np

    from ncf_tpu_torch.api import RecommendationAPI
    from ncf_tpu_torch.ops import gather

    cfg, params, dept, cat, rng = big
    cfg.train.checkpoint_dir = os.path.join(SMOKE_DIR, "api_none")
    counters = {"topk_scores_streaming": topk.topk_scores_streaming.launches,
                "topk_scores_streaming_int8":
                    topk.topk_scores_streaming_int8.launches,
                "gather_rows": gather.gather_rows.launches,
                "topk_scores_pallas": topk.topk_scores_pallas.launches,
                "topk_scores_segmented": topk.topk_scores_segmented.launches}
    users = rng.choice(cfg.model.num_users, size=64,
                       replace=False).astype(np.int32)
    summary, errs = {"card": card}, {}
    for c in counters.values():
        c.reset()
    for preset in ("exact", "int8"):
        cfg.serving.retrieval = preset
        t0 = time.perf_counter()
        server = ModelServer(cfg, params=params, item_dept=dept,
                             item_cat=cat, device="cuda")
        api = RecommendationAPI(server)
        try:
            log(f"api[{preset}]: server ready in "
                f"{time.perf_counter() - t0:.1f} s")
            out = _api_requests(api, server, users, preset)
            if preset == "exact":
                n0 = counters["gather_rows"].value
                out["metrics"], gathered = _api_intelligence(
                    api, server, int(users[1]), preset)
                check(counters["gather_rows"].value > n0,
                      "api intelligence: B7 not launched")
                out["search"], errs = _api_search(torch, topk, server, users)
            out.update(_api_http(api, server, users, preset))
            _no_errors(api, f"api[{preset}]")
            summary[preset] = out
            log(f"api[{preset}]: dispatch p50/p99 1 customer "
                f"{out['dispatch_1']['p50_ms']!r}/{out['dispatch_1']['p99_ms']!r}"
                f" ms, 64 {out['dispatch_64']['p50_ms']!r}/"
                f"{out['dispatch_64']['p99_ms']!r} ms; HTTP 1 "
                f"{out['http_1']['p50_ms']!r}/{out['http_1']['p99_ms']!r} ms, "
                f"64 {out['http_64']['p50_ms']!r}/{out['http_64']['p99_ms']!r}"
                f" ms; ModelServer.recommend p50 "
                f"{out['recommend_1']['p50_ms']!r} ms; {card}")
        finally:
            server.close()
        del server, api
        torch.cuda.empty_cache()
    launches = {k: c.value for k, c in counters.items()}
    check(all(launches.values()), f"api: a kernel never launched {launches}")
    # after the counts were read, so these comparison launches count nowhere
    n7 = _b7_route_check(torch, gather, params, gathered)
    log(f"api: gather_rows {n7} cases on the intelligence route's tables "
        f"equal bit for bit")
    errs["gather_rows"] = 0.0
    return launches, summary, errs


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_cli_server(ckpt, overrides):
    """``python -m ncf_tpu_torch.cli serve`` on a free loopback port in a
    process of its own; (process, base URL, log path, start time)."""
    port = _free_port()
    os.makedirs(SMOKE_DIR, exist_ok=True)
    log_path = os.path.join(SMOKE_DIR, "api_serve.log")
    cmd = [sys.executable, "-m", "ncf_tpu_torch.cli", "serve", "--config",
           ML1M, "--log-level", "WARNING", "--checkpoint",
           ckpt, "--port", str(port)] + list(overrides)
    with open(log_path, "w") as out:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=out,
                                stderr=subprocess.STDOUT)
    return proc, f"http://127.0.0.1:{port}", log_path, time.perf_counter()


def _await_health(proc, base, log_path, t0, timeout_s=300):
    """Seconds from the subprocess's start to its first 200 on /health."""
    import urllib.error

    while time.perf_counter() - t0 < timeout_s:
        if proc.poll() is not None:
            with open(log_path) as f:
                tail = f.read()[-2000:]
            check(False, f"cli serve exited {proc.returncode}: {tail}")
        try:
            status, body, _ = _http(base + "/health", timeout=5)
            if status == 200 and body.get("status") == "healthy":
                return time.perf_counter() - t0
        except (urllib.error.URLError, ConnectionError, OSError):
            pass
        time.sleep(0.25)
    check(False, f"cli serve: no /health within {timeout_s} s")


def phase_api_ml1m(torch, card, gate_run):
    """The API at ML-1M width over the gate run's ``indep40`` checkpoint,
    with features (``FeatureProcessor(FeatureStore(log))``) and
    ``exclude_purchased``; the CLI's ``score``, ``export --users``,
    ``consolidate`` and ``demo --hour 9`` (the export read back and
    searched, the consolidated checkpoint served); ``cli serve`` as a
    process of its own (start-up seconds, /health, one recommendation
    equal to the in-process API's); and the API over the sequence config
    (``advanced_ncf_quality.yaml`` with histories), which launches B4f and
    answers ``history_attention``.  Deletes the gate run's directory.
    Returns ({kernel: launches}, summary)."""
    import shutil

    import numpy as np

    from ncf_tpu_torch import cli
    from ncf_tpu_torch.api import RecommendationAPI
    from ncf_tpu_torch.models import advanced_ncf
    from ncf_tpu_torch.ops import tower
    from ncf_tpu_torch.serving import (FeatureProcessor, FeatureStore,
                                       ModelServer, ProductSearch,
                                       load_embeddings_jsonl)
    from ncf_tpu_torch.utils.config import Config

    best, ov = gate_run["best"], gate_run["overrides"]
    out_dir = os.path.join(SMOKE_DIR, "api_ml1m")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    summary = {"card": card}
    proc, base, serve_log, t_start = _start_cli_server(best, ov)
    try:
        cfg = Config.from_yaml(ML1M)
        cfg.apply_overrides(ov)
        inter = cli._load_interactions(cfg)
        cfg.model.num_users, cfg.model.num_items = (inter.num_users,
                                                    inter.num_items)
        cfg.model.num_departments = inter.num_departments
        cfg.model.num_categories = inter.num_categories
        t0 = time.perf_counter()
        server = ModelServer.from_checkpoint(
            cfg, best, item_dept=inter.item_dept, item_cat=inter.item_cat,
            device="cuda")
        proc_f = FeatureProcessor(FeatureStore(inter))
        api = RecommendationAPI(server, proc_f)
        summary["api_ready_s"] = time.perf_counter() - t0
        try:
            rng = np.random.default_rng(5)
            excluded = 0
            for u in rng.choice(inter.num_users, 8, replace=False).tolist():
                seen = [h["item_id"] for h in
                        proc_f.get_features(u)["sequence"]]
                out = _api_call(api, "POST", API_REC,
                                {"customer_id": str(u),
                                 "exclude_purchased": True}, "ml1m exclude")
                got = [int(r["product_id"]) for r in out["recommendations"]]
                check(not set(got) & set(seen),
                      f"ml1m: customer {u} was served an excluded item")
                s, i, _ = server.recommend(u, k=10, exclude_items=seen)
                _same_recs(out["recommendations"], s, i, f"ml1m exclude {u}")
                check(all(r["metadata"]["department"] is not None
                          and r["explanation"]
                          for r in out["recommendations"]),
                      "ml1m: a record without its enrichment")
                excluded += len(seen)
            body7 = {"customer_id": "7"}
            want7 = _api_call(api, "POST", API_REC, body7, "ml1m single")
            s, i, _ = server.recommend(7, k=10)
            _same_recs(want7["recommendations"], s, i, "ml1m single")
            summary["excluded_items_checked"] = excluded

            common = ["--config", ML1M, "--log-level", "WARNING"] + list(ov)
            csv = os.path.join(out_dir, "scores.csv")
            t0 = time.perf_counter()
            rc, _ = _cli(["score", "--checkpoint", best, "--num-users", "100",
                          "--output", csv] + common)
            summary["cli_score_s"] = time.perf_counter() - t0
            check(rc == 0, f"cli score exited {rc}")
            cu = np.random.default_rng(0).choice(inter.num_users, 100,
                                                 replace=False)
            s, i, _ = server.recommend_batch(cu, k=10)
            with open(csv) as f:
                rows = [line.split(",") for line in f.read().splitlines()[1:]]
            check([int(r[1]) for r in rows] == i.reshape(-1).tolist()
                  and [int(r[0]) for r in rows] == np.repeat(cu, 10).tolist(),
                  "cli score: the CSV differs from recommend_batch")

            items_p = os.path.join(out_dir, "items.jsonl")
            users_p = os.path.join(out_dir, "users.jsonl")
            t0 = time.perf_counter()
            rc, _ = _cli(["export", "--checkpoint", best, "--output", items_p,
                          "--users", "--users-output", users_p] + common)
            summary["cli_export_s"] = time.perf_counter() - t0
            check(rc == 0, f"cli export exited {rc}")
            ids, mat = load_embeddings_jsonl(items_p)
            uids, umat = load_embeddings_jsonl(users_p)
            check(mat.shape == (inter.num_items, cfg.model.mlp_dim)
                  and umat.shape == (inter.num_users, cfg.model.mlp_dim)
                  and ids == [str(x) for x in range(inter.num_items)],
                  f"cli export: shapes {mat.shape}, {umat.shape}")
            raw = server.get_product_embedding(
                np.arange(inter.num_items))["mlp"]
            q = server.get_user_embedding(np.arange(64))["mlp"]
            a = ProductSearch(mat, ids=ids).find_neighbors(q, 10)
            b = ProductSearch(raw, ids=ids).find_neighbors(q, 10)
            va, vb = (np.asarray([[v for _, v in r] for r in x])
                      for x in (a, b))
            check(np.abs(va - vb).max() <= 1e-5,
                  "search over the export: scores differ beyond 1e-5")
            pos = {int(i): v for r in b for i, v in r}
            for ra, rb in zip(a, b):
                for (ia, _), (ib, _) in zip(ra, rb):
                    check(ia == ib or abs(pos.get(int(ia), -9) - pos[int(ib)])
                          <= 1e-5, f"search over the export: {ia} != {ib}")
            summary["export_search_max_diff"] = float(np.abs(va - vb).max())

            cons = os.path.join(out_dir, "consolidated")
            rc, _ = _cli(["consolidate", "--checkpoint", best, "--output",
                          cons] + common)
            check(rc == 0, f"cli consolidate exited {rc}")
            again = ModelServer.from_checkpoint(
                cfg, cons, item_dept=inter.item_dept,
                item_cat=inter.item_cat, device="cuda")
            try:
                s2, i2, _ = again.recommend(7, k=10)
            finally:
                again.close()
            _same_recs(want7["recommendations"], s2, i2,
                       "the consolidated checkpoint")

            rc, text = _cli(["demo", "--checkpoint", best, "--customer", "7",
                             "--hour", "9"] + common)
            check(rc == 0 and "hour-of-day=9" in text
                  and "Model intelligence" in text, f"cli demo: {rc} {text}")
            summary["demo_lines"] = len(text.splitlines())

            summary["serve_startup_s"] = _await_health(proc, base, serve_log,
                                                       t_start)
            got = _http_ok(base + API_REC, body7, "cli serve")
            w = want7["recommendations"]
            summary["serve_max_score_diff"] = _same_recs(
                got["recommendations"], [r["score"] for r in w],
                [r["product_id"] for r in w], "cli serve", tol=1e-6)
            _no_errors(api, "api ml1m")
        finally:
            server.close()
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        shutil.rmtree(out_dir, ignore_errors=True)
        shutil.rmtree(gate_run["dir"], ignore_errors=True)
    log(f"api_ml1m: cli serve up in {summary['serve_startup_s']:.1f} s; "
        f"export {summary['cli_export_s']:.2f} s; {card}")

    # the sequence config with histories: B4f rescoring behind the API
    cfg = Config.from_yaml(QUALITY)
    inter, train_inter = _data(cfg)
    cfg.model.num_users, cfg.model.num_items = inter.num_users, inter.num_items
    cfg.model.num_departments = inter.num_departments
    cfg.model.num_categories = inter.num_categories
    hist = train_inter.recent_history(cfg.model.history_len)
    gen = torch.Generator(device="cuda").manual_seed(11)
    server = ModelServer(cfg, params=advanced_ncf.init(gen, cfg.model),
                         item_dept=inter.item_dept, item_cat=inter.item_cat,
                         user_history=hist, device="cuda")
    api = RecommendationAPI(server)
    b4f = tower.fused_tower.fwd_launches
    b4f.reset()
    try:
        users = np.arange(100, 1700, 100)
        u = int(np.argmax((hist >= 0).sum(1) >= 5))   # a user with history
        out = _api_call(api, "POST", API_REC, {"customer_id": str(u)},
                        "sequence single")
        s, i, _ = server.recommend(u, k=10)
        _same_recs(out["recommendations"], s, i, "sequence single")
        batch = _api_call(api, "POST", API_BATCH,
                          {"customer_ids": [str(u) for u in users]},
                          "sequence batch")
        s, i, _ = server.recommend_batch(users, k=10)
        for r, res in enumerate(batch["results"]):
            _same_recs(res["recommendations"], s[r], i[r],
                       f"sequence batch {r}")
        intel = _api_call(api, "POST", API_INTEL, {"customer_id": str(u)},
                          "sequence intelligence")["intelligence"]
        weights = [h["weight"] for h in intel.get("history_attention", [])]
        check(len(weights) == int((hist[u] >= 0).sum()) > 0
              and abs(sum(weights) - 1) < 1e-3,
              f"sequence intelligence: history_attention {weights}")
        _no_errors(api, "api sequence")
    finally:
        server.close()
    launches = {"fused_tower_fwd": b4f.value}
    check(b4f.value > 0, "api sequence: B4f not launched")
    summary["sequence_b4f_launches"] = b4f.value
    return launches, summary


# ------------------------------------------------- big-vocab training (A4)

BIGVOCAB = os.path.join(ROOT, "configs", "advanced_ncf_bigvocab.yaml")
BIG_LOSS_DISPATCHES = 30   # K=8 sparse steps each, the loss must fall
BIG_RUN_STEPS = 16         # two runs from one state end in equal bits
BIG_TIMED = (5, 3)         # windows x dispatches of the host-clock timing
BIG_ACTIVE_USERS = 400_000  # the users of the seeded batches
# one sparse step against one dense rowwise-Adagrad step from the same
# state: the two sum a row's duplicate occurrences in another order (f32)
# and take the clip's norm over other sums, so each leaf's change agrees
# within this share of its largest change, the accumulators within it
BIG_STEP_TOL = 1e-3
# phase 17: the CLI on a precompute-off log small enough for the default
# run (entities 400,000 > 4 x 16,384 x 5 = 327,680)
BIG_CLI = ["data.synthetic_users=300000", "data.synthetic_items=100000",
           "train.num_epochs=1", "train.checkpoint_every_dispatches=3",
           "train.keep_checkpoints=100"]
# the gate's bigvocab recipe: the reference's 9M x 3M run with rowwise
# Adagrad and sparse row updates (BENCH_r05.json:57-67; its epochs'
# hr@10 in results/bigvocab_metrics_sparse.jsonl).  N is 1 on each side,
# so the band is stated: the 250k-user sample alone carries ~0.002, the
# ML-1M joint recipe's sd is 0.011.
BIG_GATE = {"overrides": ["data.synthetic_users=9000000",
                          "data.synthetic_items=3000000",
                          "train.num_epochs=6", "train.keep_checkpoints=1"],
            "interactions": 31_768_738,
            "reference": [0.572476, 0.6128, 0.67834, 0.731456, 0.771136,
                          0.796128],
            "band": 0.02}


def _big_setup(torch):
    """The bigvocab config at full width (12M x 4M, batch 16,384, bf16,
    K 8) with seeded weights, its step's constants and seeded batches:
    users uniform over an active pool of ``BIG_ACTIVE_USERS`` ids spread
    over the 12M (so a user's row is updated more than once in the loss
    run), positives from a Zipf-like popularity over a seeded order of
    the items (so a batch repeats popular rows), temporal fields in
    range; the negatives' CDF is the inverse popularity of the log's
    expected counts (4M entries).  Returns (cfg, params, consts, draw)
    where ``draw(n, seed)`` gives ``n`` batches stacked ``[K, B]`` on the
    card."""
    import numpy as np

    from ncf_tpu_torch.data import make_sampling_cdf
    from ncf_tpu_torch.models import advanced_ncf
    from ncf_tpu_torch.utils.config import Config

    cfg = Config.from_yaml(BIGVOCAB)
    m, t = cfg.model, cfg.train
    m.num_users, m.num_items = cfg.data.synthetic_users, cfg.data.synthetic_items
    m.num_departments, m.num_categories = 9, 30
    U, I, B, K = m.num_users, m.num_items, t.batch_size, t.steps_per_dispatch
    rng = np.random.default_rng(13)
    dept = rng.integers(0, 9, I).astype(np.int32)
    cat = rng.integers(0, 30, I).astype(np.int32)
    pop = 1.0 / np.arange(1, I + 1, dtype=np.float64) ** 0.8
    rng.shuffle(pop)
    pop /= pop.sum()
    pos_cdf = np.cumsum(pop)
    active = rng.choice(U, BIG_ACTIVE_USERS, replace=False)
    cdf = make_sampling_cdf(1.0 / (pop * BIG_GATE["interactions"] + 1.0),
                            device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = advanced_ncf.init(gen, m)

    def draw(n, seed):
        r = np.random.default_rng(seed)
        shape = (n, K, B)
        cols = {"user_ids": active[r.integers(0, len(active), shape)],
                "item_ids": np.minimum(np.searchsorted(
                    pos_cdf, r.random(shape), side="right"), I - 1),
                "hour": r.integers(0, 24, shape),
                "day": r.integers(0, 7, shape),
                "month": r.integers(0, 12, shape),
                "day_of_year": r.integers(0, 365, shape)}
        cols = {k: torch.from_numpy(v.astype(np.int32)).cuda()
                for k, v in cols.items()}
        return [{k: v[i] for k, v in cols.items()} for i in range(n)]

    return cfg, params, (cdf, dept, cat), draw


def _max_change(torch, new, old):
    return float((new.float() - old.float()).abs().max())


def _untouched_equal(torch, new, old, ids, what):
    """Rows no id touches keep their bits; only touched rows change."""
    same = (new.view(torch.int32) == old.view(torch.int32)).all(1)
    touched = torch.zeros(new.shape[0], dtype=torch.bool, device=new.device)
    touched[ids.reshape(-1).long()] = True
    check(bool(same[~touched].all()), f"bigvocab step: {what}: "
          f"{int((~same[~touched]).sum())} untouched rows changed")
    check(not bool((~same & ~touched).any()), f"bigvocab step: {what}")
    return int(touched.sum()), int((~same).sum())


def _big_sparse_vs_dense(torch, cfg, params, consts, batch):
    """One sparse step and one dense rowwise-Adagrad step from the same
    state, the same negatives, dropout 0 and ewd 0."""
    import dataclasses

    from ncf_tpu_torch.convert import tree_leaves
    from ncf_tpu_torch.data import sample_negatives
    from ncf_tpu_torch.models import get_model
    from ncf_tpu_torch.train import (init_sparse_opt_state, make_optimizer,
                                     make_schedule, make_sparse_train_step,
                                     make_train_step)
    from ncf_tpu_torch.train.checkpoint import _leaves_with_path

    model = get_model("advanced_ncf")
    scfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dropout=0.0), train=dataclasses.replace(
        cfg.train, embedding_weight_decay=0.0))
    gen = torch.Generator(device="cuda").manual_seed(3)
    negs = sample_negatives(gen, batch["item_ids"], scfg.model.num_items,
                            scfg.model.negative_samples, cdf=consts[0])
    start = _clone_tree(torch, params)
    dense_opt = make_optimizer(dataclasses.replace(
        scfg.train, gradient_clip_norm=0.0), 1000)
    state = init_sparse_opt_state(dense_opt, params)
    step = make_sparse_train_step(model, scfg, dense_opt,
                                  make_schedule(scfg.train, 1000), *consts)
    params, state, _, m_s = step(params, state, gen, batch, negs)
    torch.cuda.synchronize()
    items = torch.cat([batch["item_ids"][:, None], negs], 1)
    rows = {}
    for k, ids in (("user_emb", batch["user_ids"]), ("item_emb", items)):
        rows[k] = _untouched_equal(torch, params[k], start[k], ids, k)
    change = {p: _max_change(torch, a, b) for (p, a), b in zip(
        _leaves_with_path(params), tree_leaves(start))}
    opt = make_optimizer(scfg.train, 1000)
    dstate = opt.init(start)
    dstep = make_train_step(model, scfg, opt, *consts)
    start, dstate, _, m_d = dstep(start, dstate, gen, batch, negs)
    torch.cuda.synchronize()
    worst = 0.0
    for (p, a), b in zip(_leaves_with_path(params), tree_leaves(start)):
        gap = _max_change(torch, a, b)
        share = gap / change[p] if change[p] else (0.0 if gap == 0 else 1.0)
        check(share <= BIG_STEP_TOL, f"bigvocab step: {p}: sparse and dense "
              f"differ by {gap!r}, {share!r} of the step's largest change "
              f"{change[p]!r}")
        worst = max(worst, share)
    for acc, table in (("user_acc", "user_emb"), ("item_acc", "item_emb")):
        want = dstate["embedding"]["sum_sq"][table]
        gap = _max_change(torch, state[acc], want)
        check(gap <= BIG_STEP_TOL * float(want.abs().max()),
              f"bigvocab step: {acc}: {gap!r} from the dense path's")
    check(abs(float(m_s["loss"]) - float(m_d["loss"]))
          <= 1e-6 * abs(float(m_d["loss"])), "bigvocab step: the losses")
    del start, dstate, state
    torch.cuda.empty_cache()
    return {"touched_rows": {k: v[0] for k, v in rows.items()},
            "changed_rows": {k: v[1] for k, v in rows.items()},
            "worst_share_of_change": worst, "loss": float(m_s["loss"])}


def _big_timed(torch, one, steps_a_call, B, what, card):
    """Host ms a step (median of BIG_TIMED windows), CUDA-event ms, a
    profiler window of one call, examples/s and peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    one()
    windows = []
    n_win, calls = BIG_TIMED
    for _ in range(n_win):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            one()
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) * 1e3
                       / (calls * steps_a_call))
    host = statistics.median(windows)
    out = {"what": what, "host_ms_per_step": host, "windows": windows,
           "cuda_event_ms_per_step": cuda_ms(one, 2, warmup=0)
           / steps_a_call,
           "examples_per_s": B / (host / 1e3),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    prof = device_profile(one, 1, top=8)
    if prof is not None:
        out["device_ms_per_step"] = prof["device_ms_per_call"] / steps_a_call
        out["busy_share"] = prof["busy_share"]
        out["device_ops_per_step"] = (prof["device_ops_per_call"]
                                      / steps_a_call)
        out["top_device_ms_per_step"] = {
            k: v / steps_a_call for k, v in
            prof["kernels_ms_per_call"].items()}
        log("profile_json: " + json.dumps({"what": f"bigvocab {what}",
                                           **prof}))
    log(f"bigvocab timing[{what}]: {host!r} ms a step (host clock, median "
        f"of {n_win} windows: {windows}), device "
        f"{out.get('device_ms_per_step')!r} ms, busy "
        f"{out.get('busy_share')!r}, {out['examples_per_s']!r} examples/s, "
        f"peak {out['peak_memory_gb']!r} GB; {card}")
    return out


def _b1_iid_at(torch, cdf, pos, NEG, ml1m_row):
    """B1's iid draw (two rounds, the positives) over the 4M-entry CDF:
    equal to its plain version, and timed beside the ML-1M draw."""
    from ncf_tpu_torch.ops import sampler

    dev = torch.device("cuda")
    I, B = cdf.shape[0], pos.shape[0]
    gen = torch.Generator(device=dev).manual_seed(17)
    u = torch.rand((2, B * NEG), generator=gen, device=dev)
    pos_bn = pos[:, None].expand(B, NEG).reshape(-1)
    got = sampler.tree_sample_negatives(u, pos, cdf, I).reshape(-1)
    want = sampler.tree_sample_ref(u, pos_bn, cdf, I)
    check(bool(sampler.ordered_for(u, cdf).all()), "B1 at 4M: the CDF")
    check(torch.equal(got, want), f"B1 at 4M: kernel != plain version in "
          f"{int((got != want).sum())} slots")

    def lib():
        d = torch.searchsorted(cdf, u, right=True).clamp_(max=I - 1)
        return torch.where(d[0] != pos_bn, d[0], d[1])

    check(torch.equal(lib(), want), "B1 at 4M: searchsorted != plain")
    call = functools.partial(sampler.tree_sample_negatives, u, pos, cdf, I)
    nbytes = u.numel() * 4 + B * 4 + I * 4 + B * NEG * 4
    bound, by = _bound(nbytes, u.numel() * (I.bit_length() + 1),
                       PEAK_FLOP_S["float32"])
    row = {"kernel": "tree_sample_negatives", "shape": f"iid, {I} items",
           "ms": cuda_ms(call, 50), **_device_fields(call, lib),
           # the plain version takes seconds at 4M entries: one call
           "plain_ms": cuda_ms(lambda: sampler.tree_sample_ref(
               u, pos_bn, cdf, I), 1, warmup=0),
           "library_ms": cuda_ms(lib, 50), "bound_ms": bound,
           "bound_by": by,
           "ml1m_iid_ms": (ml1m_row or {}).get("ms"),
           "ml1m_iid_device_ms": (ml1m_row or {}).get("device_ms")}
    log(f"timing: B1 iid over {I} items: kernel {row['ms']!r} ms (device "
        f"{row['device_ms']!r}), plain {row['plain_ms']!r}, searchsorted "
        f"{row['library_ms']!r} (device {row.get('library_device_ms')!r}), "
        f"bound {bound!r} ({by}); at ML-1M's 3,706 items "
        f"{row['ml1m_iid_ms']!r} ms (device {row['ml1m_iid_device_ms']!r})")
    return row


def _big_combine(torch, batch, cfg):
    """``combine_duplicate_rows`` (one B2 launch, through its grouped
    entry: the combine sorts once) against its former B2 call over each
    occurrence's segment, on the step's user and item ids and a skewed
    draw over the items: ``rep_ids`` and totals equal bit for bit."""
    from ncf_tpu_torch.ops import scatter
    from ncf_tpu_torch.train.sparse import combine_duplicate_rows

    gen = torch.Generator(device="cuda").manual_seed(17)
    u = torch.rand(65536, generator=gen, device="cuda")
    m = cfg.model
    cases = {"user": (batch["user_ids"], m.num_users),
             "item": (batch["item_ids"], m.num_items),
             "skewed": ((u.pow(-1.0 / 0.4) - 1.0).clamp(
                 max=m.num_items - 1).long(), m.num_items)}
    out = {}
    for what, (ids, V) in cases.items():
        ids = torch.as_tensor(ids, device="cuda").reshape(-1)
        n = ids.numel()
        g = torch.randn((n, 64), generator=gen, device="cuda")
        n0 = scatter.onehot_scatter_add.launches.value
        rep, totals = combine_duplicate_rows(ids, g, V)
        launches = scatter.onehot_scatter_add.launches.value - n0
        ids_s, order = torch.sort(ids.long(), stable=True)
        boundary = torch.ones_like(ids_s)
        boundary[1:] = ids_s[1:] != ids_s[:-1]
        seg_idx = torch.cumsum(boundary, 0) - 1
        seg_of = torch.empty_like(seg_idx)
        seg_of[order] = seg_idx
        want = scatter.onehot_scatter_add(seg_of, g, n, mode="f32")
        want_rep = torch.arange(n, device="cuda") + V
        want_rep.scatter_(0, seg_idx, ids_s)
        torch.cuda.synchronize()
        check(launches == 1, f"bigvocab: the combine of {what} ids launched "
              f"B2 {launches} times")
        check(torch.equal(rep, want_rep) and torch.equal(totals, want),
              f"bigvocab: the combine of {what} ids differs from its "
              "former B2 call")
        out[what] = {"ids": n, "segments": int(seg_idx[-1]) + 1}
    return out


def phase_bigvocab_step(torch, card, ml1m_iid_row=None):
    """Phase 16: the sparse table update at the shipped bigvocab config's
    full width on seeded batches.  Returns (launches of the training
    kernels in the loss run, summary)."""
    import dataclasses

    from ncf_tpu_torch.models import advanced_ncf, get_model
    from ncf_tpu_torch.ops import embedding
    from ncf_tpu_torch.train import (init_sparse_opt_state, make_optimizer,
                                     make_schedule,
                                     make_sparse_multi_train_step,
                                     make_train_step)

    embedding.set_scatter_impl("fast")
    t0 = time.perf_counter()
    cfg, params, consts, draw = _big_setup(torch)
    torch.cuda.synchronize()
    m, t = cfg.model, cfg.train
    K, B = t.steps_per_dispatch, t.batch_size
    check(K == 8 and t.embedding_optimizer == "rowwise_adagrad",
          "bigvocab: the shipped config is not K 8 rowwise Adagrad")
    log(f"bigvocab: {m.num_users}x{m.num_items} params, batch {B}, K {K}, "
        f"{m.compute_dtype}, set up in {time.perf_counter() - t0:.1f} s")
    batches = draw(BIG_LOSS_DISPATCHES, 1)
    step0 = {k: v[0] for k, v in batches[0].items()}
    summary = {"step_vs_dense": _big_sparse_vs_dense(
        torch, cfg, params, consts, step0)}
    log(f"bigvocab: one sparse step against one dense rowwise step: "
        f"{json.dumps(summary['step_vs_dense'])}")
    summary["combine"] = _big_combine(torch, step0, cfg)
    log(f"bigvocab: the sparse combine through B2's grouped entry equals "
        f"its former B2 call bit for bit: {json.dumps(summary['combine'])}")

    model = get_model("advanced_ncf")
    dense_opt = make_optimizer(dataclasses.replace(
        t, gradient_clip_norm=0.0), 1000)
    multi = make_sparse_multi_train_step(
        model, cfg, dense_opt, make_schedule(t, 1000), *consts)
    state = init_sparse_opt_state(dense_opt, params)
    # two runs of BIG_RUN_STEPS from one state end in equal bits
    base, base_state = _clone_tree(torch, params), _clone_tree(torch, state)
    ends = []
    for run in range(2):
        p, s = ((params, state) if run == 0 else (base, base_state))
        gen = torch.Generator(device="cuda").manual_seed(11)
        for i in range(BIG_RUN_STEPS // K):
            p, s, gen, _ = multi(p, s, gen, batches[i])
        torch.cuda.synchronize()
        ends.append((p, s))
    n = _trees_equal(torch, ends[0][0], ends[1][0], "bigvocab: two runs")
    n += _trees_equal(torch, ends[0][1], ends[1][1], "bigvocab: two runs' "
                      "state")
    del base, base_state, ends, p, s
    torch.cuda.empty_cache()
    log(f"bigvocab: two runs of {BIG_RUN_STEPS} sparse steps end in equal "
        f"bits ({n} leaves)")

    # the loss run starts from fresh seeded weights (an untrained model's
    # loss is ln 2 a slot)
    del params, state
    torch.cuda.empty_cache()
    params = advanced_ncf.init(torch.Generator(device="cuda").manual_seed(1),
                               m)
    state = init_sparse_opt_state(dense_opt, params)
    counters = _launch_counters()
    for c in counters.values():
        c.reset()
    gen = torch.Generator(device="cuda").manual_seed(12)
    losses = []
    for b in batches:
        params, state, gen, mt = multi(params, state, gen, b)
        losses.append(mt["loss"])
    launches = {k: c.value for k, c in counters.items()}
    steps = BIG_LOSS_DISPATCHES * K
    for k, c in launches.items():
        check(c == PER_STEP[k] * steps, f"bigvocab: {k} launched {c} times "
              f"in {steps} sparse steps, want {PER_STEP[k]} a step")
    losses = torch.stack(losses).float().cpu()
    check(bool(torch.isfinite(losses).all()), "bigvocab: non-finite loss")
    log(f"bigvocab: loss a dispatch {losses.tolist()}")
    first, last = _loss_fell(losses, "bigvocab sparse")
    summary.update(loss_first=first, loss_last=last, launches=launches,
                   losses=losses.tolist())
    log(f"bigvocab: loss {first!r} -> {last!r} over {BIG_LOSS_DISPATCHES} "
        f"dispatches of {K}; launches {json.dumps(launches)}")

    box = {"i": 0, "p": params, "s": state, "g": gen}

    def sparse_call():
        b = batches[box["i"] % len(batches)]
        box["i"] += 1
        box["p"], box["s"], box["g"], _ = multi(box["p"], box["s"],
                                                box["g"], b)

    timing = [_big_timed(torch, sparse_call, K, B, "sparse", card)]
    params = box["p"]
    del box, state, multi
    torch.cuda.empty_cache()
    opt = make_optimizer(t, 1000)
    dbox = {"i": 0, "s": opt.init(params), "g": gen}
    dstep = make_train_step(model, cfg, opt, *consts)

    def dense_call():
        b = batches[dbox["i"] % len(batches)]
        dbox["i"] += 1
        _, dbox["s"], dbox["g"], _ = dstep(params, dbox["s"], dbox["g"],
                                           {k: v[0] for k, v in b.items()})

    timing.append(_big_timed(torch, dense_call, 1, B, "dense rowwise",
                             card))
    del dbox, dstep, opt
    torch.cuda.empty_cache()
    summary["timing"] = timing
    summary["b1_iid"] = _b1_iid_at(torch, consts[0],
                                   batches[0]["item_ids"][0],
                                   m.negative_samples, ml1m_iid_row)
    del params
    torch.cuda.empty_cache()
    return launches, summary


def _memo_load(cli):
    """``cli._load_interactions`` made once per data section (the gate
    and phase 17 build each log once)."""
    if not getattr(cli._load_interactions, "memoized", False):
        _memoized_interactions()
        cli._load_interactions.memoized = True
    return cli._load_interactions


# ------------------------------------------------- phase H: HSTU's H1

# H1 at the HSTU cell's shapes (benchmark/traffic/train-hstu-t262144.json,
# ncf_tpu_torch/configs/hstu_large_retail4m.yaml): packed batches of
# 262,144 target positions, history lengths log-uniform over 512-8,192,
# 2 heads of 25, N 8,192
HSTU_CONFIG = os.path.join(ROOT, "ncf_tpu_torch", "configs",
                           "hstu_large_retail4m.yaml")
HSTU_TARGETS = 262144
HSTU_LENS = (512, 8192)
HSTU_STEPS = 3
# tests/test_torch_hstu.py's tolerances, by norm of the difference over
# the plain version's: the output 2e-4 (bf16 operands on both sides, f32
# sums in another order), each gradient 1e-2 (A and dA rounded to bf16
# where the plain version's autograd keeps f32)
HSTU_OUT_TOL, HSTU_GRAD_TOL = 2e-4, 1e-2


def _hstu_batch(np, n_targets, rng):
    """(offsets int64 [S + 1], timestamps int64 [T]) of a packed batch of
    ``n_targets`` target positions: lengths log-uniform over
    ``HSTU_LENS``, the last cut to the budget; baskets that share a
    timestamp, gaps log-uniform over 1 hour to 60 days."""
    lo, hi = HSTU_LENS
    lens, left = [], n_targets
    while left > 0:
        L = min(int(np.exp(rng.uniform(np.log(lo), np.log(hi + 1)))),
                hi, left + 1)
        lens.append(L)
        left -= L - 1
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    T = int(off[-1])
    gaps = np.exp(rng.uniform(np.log(3600), np.log(5_184_000), T))
    gaps = np.where(rng.random(T) < 0.4, gaps, 0.0).astype(np.int64)
    return off, np.cumsum(gaps) + 1_500_000_000


def _hstu_rel(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _hstu_bounds(off, H, D, N):
    """(forward, backward) bound ms of one launch: the useful causal
    pairs' products at the bf16 peak, or Q, K, V (and dO) read and the
    outputs written once in bf16, the offsets, timestamps and bias tables
    (``benchmark/counts/hstu.py``'s counts), whichever is longer."""
    import numpy as np

    lens = np.diff(off)
    T, S = int(off[-1]), lens.size
    pairs = float((lens * (lens + 1) // 2).sum())
    tables = (2 * N - 1 + 129) * 4
    pos = (S + 1 + T) * 8
    fwd = _bound(T * H * 4 * D * 2 + pos + tables,
                 pairs * H * 2.0 * 2 * D, PEAK_FLOP_S["bfloat16"])
    bwd = _bound(T * H * 7 * D * 2 + pos + 2 * tables,
                 pairs * H * 2.0 * 5 * D, PEAK_FLOP_S["bfloat16"])
    return fwd, bwd


def _hstu_plain(torch, hsa, uvqk, w_pos, w_ts, ts, off, N, go, H, D):
    """The plain version's output and gradients of (uvqk, w_pos, w_ts),
    one sequence at a time, each sequence's graph freed before the
    next (the whole batch's would not fit the card)."""
    out = torch.empty((uvqk.shape[0], H, D), device=uvqk.device)
    grads = [torch.zeros_like(x) for x in (uvqk, w_pos, w_ts)]
    for a, b in zip(off[:-1].tolist(), off[1:].tolist()):
        x = uvqk[a:b].detach().requires_grad_(True)
        wp = w_pos.detach().requires_grad_(True)
        wt = w_ts.detach().requires_grad_(True)
        v, q, k = (x[:, c * H * D:(c + 1) * H * D].reshape(b - a, H, D)
                   for c in (1, 2, 3))
        with torch.enable_grad():
            o = hsa.hstu_attention_ref(q, k, v, wp, wt, ts[a:b], [0, b - a],
                                       N)
            gx, gp, gt = torch.autograd.grad(o, (x, wp, wt), go[a:b])
        out[a:b] = o.detach()
        grads[0][a:b] = gx
        grads[1] += gp
        grads[2] += gt
    return out, grads


def _hstu_compare(torch, hsa, off, ts, N, H, D, seed):
    """H1 against its plain version on one packed batch, forward and
    every gradient; two backward runs in equal bits; each call one
    launch of each.  Returns the timing row's fields."""
    import numpy as np

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    T = int(off[-1])
    # q, k, v as the model passes them: column views of one wider row
    uvqk = torch.randn((T, 4 * H * D), generator=g, device=dev)
    w_pos = torch.randn(2 * N - 1, generator=g, device=dev) * 0.5
    w_ts = torch.randn(129, generator=g, device=dev) * 0.5
    go = torch.randn((T, H, D), generator=g, device=dev)
    ts = torch.from_numpy(ts).to(dev)
    leaves = [x.requires_grad_(True) for x in (uvqk, w_pos, w_ts)]
    v, q, k = (uvqk[:, c * H * D:(c + 1) * H * D].reshape(T, H, D)
               for c in (1, 2, 3))
    plan = hsa.Plan(off, dev)
    fwd_c = hsa.hstu_attention.fwd_launches
    bwd_c = hsa.hstu_attention.bwd_launches
    fwd_c.reset()
    bwd_c.reset()
    out = hsa.hstu_attention(q, k, v, w_pos, w_ts, ts, plan, N)
    got = torch.autograd.grad(out, leaves, go)
    check((fwd_c.value, bwd_c.value) == (1, 1),
          f"H1: a call launched {fwd_c.value} forwards and {bwd_c.value} "
          "backwards, not one each")
    again = torch.autograd.grad(
        hsa.hstu_attention(q, k, v, w_pos, w_ts, ts, plan, N), leaves, go)
    for name, a, b in zip(("uvqk", "w_pos", "w_ts"), got, again):
        check(torch.equal(a, b), f"H1: two backward runs differ in d{name}")
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    want_out, want = _hstu_plain(torch, hsa, uvqk, w_pos, w_ts, ts, off, N,
                                 go, H, D)
    stop.record()
    torch.cuda.synchronize()
    plain_fb_ms = start.elapsed_time(stop)
    out = out.detach()
    gaps = {"out": _hstu_rel(out, want_out)}
    gaps.update({f"d{n}": _hstu_rel(a, b)
                 for n, a, b in zip(("uvqk", "w_pos", "w_ts"), got, want)})
    max_abs = float((out - want_out).abs().max())
    del want_out, want, got, again
    check(gaps["out"] <= HSTU_OUT_TOL,
          f"H1: output {gaps['out']!r} from the plain version's "
          f"(tolerance {HSTU_OUT_TOL})")
    for n in ("duvqk", "dw_pos", "dw_ts"):
        check(gaps[n] <= HSTU_GRAD_TOL,
              f"H1: {n} {gaps[n]!r} from the plain version's (tolerance "
              f"{HSTU_GRAD_TOL})")

    with torch.no_grad():
        qd, kd, vd, wp, wt = (x.detach() for x in (q, k, v, w_pos, w_ts))

        def fwd():
            return hsa._forward_cuda(qd, kd, vd, wp, wt, ts, plan, N)

        _, ops = fwd()

        def bwd():
            return hsa._backward_cuda(ops, go, wp, wt, ts, plan, N)

        def plain_fwd():
            return hsa.hstu_attention_ref(qd, kd, vd, wp, wt, ts, off, N)

        fwd_ms, bwd_ms = cuda_ms(fwd, 10), cuda_ms(bwd, 10)
        plain_fwd_ms = cuda_ms(plain_fwd, 1, warmup=1)
        fwd_dev, bwd_dev = _device_fields(fwd), _device_fields(bwd)
    (fb, fby), (bb, bby) = _hstu_bounds(off, H, D, N)
    lens = np.diff(off)
    shape = (f"T {int(off[-1])}, {lens.size} histories of {int(lens.min())}"
             f"-{int(lens.max())}, H {H}, D {D}, N {N}")
    rows = [
        {"kernel": "hstu_attn_fwd", "shape": shape, "ms": fwd_ms, **fwd_dev,
         "plain_ms": plain_fwd_ms, "bound_ms": fb, "bound_by": fby,
         "library_ms": None},
        {"kernel": "hstu_attn_bwd", "shape": shape, "ms": bwd_ms, **bwd_dev,
         "plain_ms": plain_fb_ms - plain_fwd_ms, "bound_ms": bb,
         "bound_by": bby, "library_ms": None}]
    return rows, gaps, max_abs


def _hstu_steps(torch, batches, N):
    """``HSTU_STEPS`` steps of the shipped configuration at 4M items on
    the main path (``make_sparse_train_step``, as the Trainer builds it),
    the launch counters reset just before: (H1's launches, the steps'
    losses, CUDA-event ms a step, peak GiB)."""
    import dataclasses

    from ncf_tpu_torch.models import get_model
    from ncf_tpu_torch.ops import embedding
    from ncf_tpu_torch.ops.hstu_attention import hstu_attention
    from ncf_tpu_torch.train import (init_sparse_opt_state, make_optimizer,
                                     make_schedule, make_sparse_train_step)
    from ncf_tpu_torch.train.trainer import _SCATTER
    from ncf_tpu_torch.utils.config import Config

    dev = torch.device("cuda")
    cfg = Config.from_yaml(HSTU_CONFIG)
    cfg.model.num_items = cfg.data.synthetic_items
    cfg.validate()
    check(cfg.model.max_sequence_length == N, "H1: the config's N")
    model = get_model(cfg.model.name)
    embedding.set_scatter_impl(*_SCATTER[cfg.train.embedding_scatter])
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        cfg.model, device=dev)
    opt = make_optimizer(dataclasses.replace(cfg.train,
                                             gradient_clip_norm=0.0),
                         HSTU_STEPS)
    state = init_sparse_opt_state(opt, params)
    step = make_sparse_train_step(model, cfg, opt,
                                  make_schedule(cfg.train, HSTU_STEPS),
                                  device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    counters = (hstu_attention.fwd_launches, hstu_attention.bwd_launches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset()
    losses = []
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for b in batches:
        params, state, gen, met = step(params, state, gen, b)
        losses.append(met["loss"])
    stop.record()
    torch.cuda.synchronize()
    launches = [c.value for c in counters]
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated() / 2**30
    del params, state, step
    torch.cuda.empty_cache()
    return launches, losses, start.elapsed_time(stop) / len(batches), peak


def phase_hstu(torch):
    """Phase H: HSTU's attention (H1) at the cell's shapes.  H1 against
    its plain version on a packed batch of 262,144 target positions,
    forward and every gradient at the tolerances of its tests, two
    backward runs in equal bits; its times beside the plain version's
    and the bound; then ``HSTU_STEPS`` steps of the shipped
    configuration at 4M items on the main path with H1's launches
    counted (8 forwards and 8 backwards a step, one a block), and the
    shipped configuration through ``cli train`` at 2,000 users (the
    Trainer, evaluation off).  Returns (H1's launches on the main path,
    its timing rows, worst absolute output error, summary)."""
    import shutil

    import numpy as np

    from ncf_tpu_torch.ops import embedding
    from ncf_tpu_torch.ops import hstu_attention as hsa
    from ncf_tpu_torch.utils.config import Config

    # the steps and the CLI's Trainer set the scatter's rounding
    # process-wide: the later phases get theirs back
    before = (embedding._SCATTER_IMPL, embedding._SCATTER_MODE)
    cfg = Config.from_yaml(HSTU_CONFIG)
    N, H = cfg.model.max_sequence_length, cfg.model.num_heads
    D = cfg.model.attention_dim
    check(D == cfg.model.linear_dim, "H1: d_qk and d_v differ")
    rng = np.random.default_rng(2026)
    off, ts = _hstu_batch(np, HSTU_TARGETS, rng)
    t0 = time.perf_counter()
    rows, gaps, max_abs = _hstu_compare(torch, hsa, off, ts, N, H, D, 17)
    compare_s = time.perf_counter() - t0
    for r in rows:
        log(f"timing: {r['kernel']} {r['shape']} kernel {r['ms']!r} ms "
            f"(device {r['device_ms']!r} ms, {r['device_ops']}), plain "
            f"{r['plain_ms']!r} ms, bound {r['bound_ms']!r} ms "
            f"({r['bound_by']})")
    log("hstu_compare_json: " + json.dumps(
        {"gaps": gaps, "tolerances": [HSTU_OUT_TOL, HSTU_GRAD_TOL],
         "max_abs_err": max_abs, "seconds": compare_s}))
    torch.cuda.empty_cache()

    batches = []
    for _ in range(HSTU_STEPS):
        o, t = _hstu_batch(np, HSTU_TARGETS, rng)
        batches.append({"item_ids": rng.integers(0, cfg.data.synthetic_items,
                                                 int(o[-1])),
                        "timestamps": t, "offsets": o})
    launches, losses, step_ms, peak = _hstu_steps(torch, batches, N)
    per_step = cfg.model.num_blocks * HSTU_STEPS
    check(launches == [per_step, per_step],
          f"H1: {launches} forward and backward launches over "
          f"{HSTU_STEPS} steps, not {per_step} each")
    check(all(np.isfinite(losses)), f"H1: losses {losses}")

    d = os.path.join(SMOKE_DIR, "hstu_cli")
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    rc, out = _cli(["train", "--config", HSTU_CONFIG, "--log-level",
                    "WARNING", "data.synthetic_users=2000",
                    "train.batch_size=65536", f"train.checkpoint_dir={d}",
                    "train.metrics_file="])
    cli_s = time.perf_counter() - t0
    check(rc == 0, f"hstu cli: train exited {rc}")
    check(os.listdir(d), "hstu cli: no checkpoint written")
    shutil.rmtree(d, ignore_errors=True)
    embedding.set_scatter_impl(*before)
    summary = {"main_path_launches": dict(zip(
                   ("hstu_attn_fwd", "hstu_attn_bwd"), launches)),
               "steps": HSTU_STEPS, "losses": losses, "step_ms": step_ms,
               "peak_gib": peak, "cli_s": cli_s,
               "cli_out": out.strip().splitlines()[-1:]}
    return dict(zip(("hstu_attn_fwd", "hstu_attn_bwd"), launches)), rows, \
        max_abs, summary


def phase_bigvocab_trainer(torch, card):
    """Phase 17: ``python -m ncf_tpu_torch.cli train`` on the bigvocab
    config at a precompute-off size small enough for the default run
    (sparse auto: K 8, one epoch, ``validate``, mid-epoch checkpoints);
    then a ``Trainer`` resumes the first mid-epoch checkpoint and ends
    the epoch in the same bits as the CLI's run.  Returns (launches of
    the training kernels through the CLI, summary)."""
    import shutil

    import numpy as np

    from ncf_tpu_torch import cli
    from ncf_tpu_torch.train import Trainer
    from ncf_tpu_torch.train import checkpoint as ckpt_lib
    from ncf_tpu_torch.train.checkpoint import _leaves_with_path
    from ncf_tpu_torch.utils.config import Config

    d = os.path.join(SMOKE_DIR, "bigvocab_cli")
    shutil.rmtree(d, ignore_errors=True)
    ov = BIG_CLI + [f"train.checkpoint_dir={d}",
                    f"train.metrics_file={os.path.join(d, 'metrics.jsonl')}"]
    load = _memo_load(cli)
    cfg = Config.from_yaml(BIGVOCAB)
    cfg.apply_overrides(ov)
    t0 = time.perf_counter()
    inter = load(cfg)
    data_s = time.perf_counter() - t0
    counters = _launch_counters()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    rc, out = _cli(["train", "--config", BIGVOCAB, "--log-level",
                    "WARNING"] + ov)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = {k: c.value for k, c in counters.items()}
    check(rc == 0, f"bigvocab cli: train exited {rc}")
    for k, n in launches.items():
        check(n > 0, f"bigvocab cli: {k} never launched through the CLI")
    with open(os.path.join(d, "metrics.jsonl")) as f:
        recs = [json.loads(x) for x in f]
    val = [r for r in recs if r["kind"] == "val"]
    check(len(val) == 1, f"bigvocab cli: {len(val)} validations")
    val = val[0]
    chance = 10.0 / (1 + cfg.data.num_eval_negatives)
    check(np.isfinite(val["val_loss"]) and val["hr@10"] > chance,
          f"bigvocab cli: validate gave {val}")
    final = ckpt_lib.find_best(d)
    mids = [p for p, m_ in _mid_epoch(d) if m_["epoch"] == 0]
    check(final is not None and mids, "bigvocab cli: checkpoints missing")
    with open(os.path.join(mids[0], "manifest.json")) as f:
        dispatch = json.load(f)["extra"]["dispatch"]
    log(f"bigvocab cli: {len(inter)} interactions made in {data_s:.1f} s; "
        f"train exited 0 in {cli_s!r} s: val_loss {val['val_loss']!r}, "
        f"hr@10 {val['hr@10']!r}; launches {json.dumps(launches)}; {card}")

    cfg.train.checkpoint_dir = d + "_resumed"
    tb = Trainer(cfg, inter)
    check(tb.sparse_tables and cfg.train.steps_per_dispatch == 8,
          "bigvocab cli: the Trainer is not sparse at K 8")
    check(tb.resume(mids[0]), "bigvocab cli: resume failed")
    check(tb.start_epoch == 0 and tb._resume_dispatch == dispatch,
          "bigvocab cli: resume did not re-enter epoch 0")
    tb.train_epoch(0)
    want, manifest = ckpt_lib.restore(final, tb._state())
    check(tb.global_step == manifest["step"], "bigvocab cli: steps differ")
    got = {"params": tb.params, "opt_state": tb._named_opt_state()}
    n = _trees_equal(torch, got, {"params": want["params"],
                                  "opt_state": want["opt_state"]},
                     "bigvocab cli: resumed run")
    check(torch.equal(tb.rng.get_state().cpu(), want["rng"].cpu()),
          "bigvocab cli: the generators differ")
    log(f"bigvocab cli: resumed at dispatch {dispatch} of epoch 0 and "
        f"ended it in the CLI run's bits ({n} leaves, the generator too)")
    del tb
    torch.cuda.empty_cache()
    shutil.rmtree(d, ignore_errors=True)
    shutil.rmtree(d + "_resumed", ignore_errors=True)
    return launches, {"interactions": len(inter), "cli_s": cli_s,
                      "val_loss": val["val_loss"], "hr@10": val["hr@10"],
                      "resume_dispatch": dispatch, "leaves_equal": n,
                      "launches": launches,
                      "n_leaves": len(list(_leaves_with_path(got)))}


def phase_gate_bigvocab(torch, card):
    """The gate's ``bigvocab`` recipe: the shipped config at 9M x 3M
    through the CLI, six epochs, each epoch's hr@10 beside the
    reference's; the best must lie within ``BIG_GATE["band"]`` of the
    reference's best.  Returns (seconds, summary)."""
    import shutil

    from ncf_tpu_torch import cli
    from ncf_tpu_torch.utils.config import Config

    t_phase = time.perf_counter()
    d = os.path.join(SMOKE_DIR, "gate", "bigvocab")
    shutil.rmtree(d, ignore_errors=True)
    ov = BIG_GATE["overrides"] + [
        f"train.checkpoint_dir={d}",
        f"train.metrics_file={os.path.join(d, 'metrics.jsonl')}"]
    cfg = Config.from_yaml(BIGVOCAB)
    cfg.apply_overrides(ov)
    t0 = time.perf_counter()
    inter = _memo_load(cli)(cfg)
    data_s = time.perf_counter() - t0
    check(len(inter) == BIG_GATE["interactions"],
          f"gate[bigvocab]: {len(inter)} interactions, the reference's log "
          f"has {BIG_GATE['interactions']}")
    log(f"gate[bigvocab]: {inter.num_users}x{inter.num_items}, {len(inter)} "
        f"interactions made in {data_s:.1f} s")
    t0 = time.perf_counter()
    rc, _ = _cli(["train", "--config", BIGVOCAB, "--log-level", "WARNING"]
                 + ov)
    train_s = time.perf_counter() - t0
    check(rc == 0, f"gate[bigvocab]: train exited {rc}")
    with open(os.path.join(d, "metrics.jsonl")) as f:
        recs = [json.loads(x) for x in f]
    val = [r for r in recs if r["kind"] == "val"]
    curve = [[int(r["epoch"]), r["hr@10"], ref, r["val_loss"]]
             for r, ref in zip(val, BIG_GATE["reference"])]
    rates = [r["examples_per_s"] for r in recs if r["kind"] == "train"]
    for e, hr, ref, vl in curve:
        log(f"gate[bigvocab]: epoch {e} hr@10 {hr!r} (reference {ref!r}), "
            f"val_loss {vl!r}")
    best = max(r["hr@10"] for r in val)
    gap = best - max(BIG_GATE["reference"])
    out = {"epochs": curve, "best": best, "reference_best":
           max(BIG_GATE["reference"]), "gap": gap, "band": BIG_GATE["band"],
           "train_s": train_s, "data_s": data_s,
           "examples_per_s_median": statistics.median(rates) if rates else
           None, "card": card}
    log("gate_bigvocab_json: " + json.dumps(out))
    shutil.rmtree(d, ignore_errors=True)
    check(gap >= -BIG_GATE["band"], f"gate[bigvocab]: best hr@10 {best!r} "
          f"is {-gap!r} below the reference's {max(BIG_GATE['reference'])!r}")
    return time.perf_counter() - t_phase, out


# ------------------------------------------------- the tools (phase 22)

TOOLS_DIR = os.path.join(SMOKE_DIR, "tools")
# ML-1M's users and items, the warehouse's default stores, two months
WAREHOUSE = {"num_users": 6040, "num_items": 3706, "num_stores": 20,
             "num_days": 60, "seed": 0}
WAREHOUSE_TABLES = ("loyalty_customer_dim", "store_dim", "product_features",
                    "transaction_header_fact", "transaction_body_fact")
WAREHOUSE_SAMPLE = 1000     # rows of each table held to its schema
TOOLS_STEPS = 20            # bare steps timed by the host clock
TOOLS_TRACED = 3            # steps inside the trace, after the timed ones
TOOLS_TRACE_TRIES = 3       # traces taken until one holds every kernel
TOOLS_SINGLES = 64          # single-customer dispatch calls
# each training kernel's symbol, as a device event of the trace shows it
TOOLS_SYMBOLS = {"tree_sample_negatives": "tree_sample_kernel",
                 "onehot_scatter_add": "scatter_rows_kernel",
                 "fused_lookup_sum": "temporal_sum_kernel",
                 "fused_tower_fwd": "tower_fwd_kernel",
                 "fused_tower_bwd": "tower_bwd_kernel"}
DOCTOR_CHECKS = ("config", "devices", "compile", "hbm", "mesh",
                 "artifact_store", "native", "redis")
# the bigvocab config at the vocabulary it trains (the doctor reads the
# model's as the config writes it), and its estimate in bytes
DOCTOR_BIGVOCAB = ["model.num_users=12000000", "model.num_items=4000000"]
DOCTOR_BIGVOCAB_BYTES = 16_733_130_752
# phase 16's measured peaks (NVIDIA H100 80GB HBM3, 700 W), printed beside
# the estimate
BIG_PEAKS_GB = {"sparse": "9.0-9.2", "dense rowwise": "33"}


def _sample_rows(path, n, seed=0):
    """``n`` rows of a JSONL table, drawn without replacement."""
    import numpy as np

    with open(path) as f:
        lines = f.readlines()
    pick = np.random.default_rng(seed).choice(
        len(lines), min(n, len(lines)), replace=False)
    return [json.loads(lines[i]) for i in sorted(pick)]


def _tools_warehouse(root):
    """Part 1: the warehouse at ML-1M's users and items on the host, each
    table counted and a sample of each held to its schema."""
    from ncf_tpu_torch.data.generators import build_warehouse
    from ncf_tpu_torch.data.schemas import DatasetWriter, validate_row

    t0 = time.perf_counter()
    inter = build_warehouse(root, **WAREHOUSE)
    build_s = time.perf_counter() - t0
    writer = DatasetWriter(root)
    counts = {t: writer.count_rows(t) for t in WAREHOUSE_TABLES}
    want = {"loyalty_customer_dim": WAREHOUSE["num_users"],
            "store_dim": WAREHOUSE["num_stores"],
            "product_features": WAREHOUSE["num_items"],
            "transaction_body_fact": len(inter)}
    for t, n in want.items():
        check(counts[t] == n, f"warehouse: {t} has {counts[t]} rows, want {n}")
    check(0 < counts["transaction_header_fact"] <= len(inter),
          f"warehouse: {counts['transaction_header_fact']} visits")
    for t in WAREHOUSE_TABLES:
        for row in _sample_rows(os.path.join(root, f"{t}.jsonl"),
                                WAREHOUSE_SAMPLE):
            errs = validate_row(t, row)
            check(not errs, f"warehouse: a {t} row breaks its schema: {errs}")
    mb = sum(os.path.getsize(os.path.join(root, f"{t}.jsonl"))
             for t in WAREHOUSE_TABLES) / 1e6
    log(f"tools: warehouse {WAREHOUSE['num_users']}x{WAREHOUSE['num_items']}"
        f" in {build_s!r} s (host), {len(inter)} interactions, {mb:.1f} MB "
        f"of JSONL, rows {json.dumps(counts)}; {WAREHOUSE_SAMPLE} rows of "
        f"each table pass validate_row")
    return inter, {"build_s": build_s, "rows": counts, "jsonl_mb": mb,
                   "interactions": len(inter)}


def _tools_trainer(torch, inter, root):
    """Part 2: the ``Trainer`` on the warehouse log, config A as shipped
    with the model sized to the log and one step a dispatch: one epoch,
    each step's training kernels counted, ``validate``, a best
    checkpoint.  A train record a dispatch (``log_every_steps`` 1: the
    logging cadence only) shows the loss falling.  Returns (trainer,
    sized config, best checkpoint, launches, summary)."""
    from ncf_tpu_torch.train import Trainer
    from ncf_tpu_torch.train import checkpoint as ckpt_lib

    # one step a dispatch: the warehouse log's epoch is ~28 steps, and an
    # autotuned K (timed, up to 32) can leave a single record
    cfg = _trainer_cfg(os.path.join(root, "ckpt"), spd=1)
    cfg.model.num_users, cfg.model.num_items = inter.num_users, inter.num_items
    cfg.model.num_departments = inter.num_departments
    cfg.model.num_categories = inter.num_categories
    cfg.train.log_every_steps = 1
    check(cfg.model.fused_tower == "auto", "tools: fused_tower is not auto")
    t0 = time.perf_counter()
    t = Trainer(cfg, inter)
    setup_s = time.perf_counter() - t0
    counters = _launch_counters()
    for c in counters.values():
        c.reset()
    m = t.train_epoch(0)
    steps = t.global_step
    launches = {k: c.value for k, c in counters.items()}
    check(steps > 0, "tools: the epoch took no step")
    for k, n in launches.items():
        check(n == PER_STEP[k] * steps, f"tools: {k} launched {n} times in "
              f"{steps} steps, want {PER_STEP[k]} a step")
    t0 = time.perf_counter()
    val = t.validate(0)
    torch.cuda.synchronize()
    validate_s = time.perf_counter() - t0
    best = t.save_checkpoint(0, val)
    ckpt_lib.mark_best(cfg.train.checkpoint_dir, best)
    check(ckpt_lib.find_best(cfg.train.checkpoint_dir) == best,
          "tools: the best checkpoint is not found")
    losses = [r["loss"] for r in t.metrics_logger.recent(4096)
              if r.get("kind") == "train"]
    check(len(losses) >= 2, f"tools: {len(losses)} train records")
    h = max(1, len(losses) // 3)
    first, last = sum(losses[:h]) / h, sum(losses[-h:]) / h
    check(last < first, f"tools: the loss did not fall ({first!r} -> "
          f"{last!r})")
    check(all(v == v for v in val.values()), f"tools: validate gave {val}")
    log(f"tools: Trainer set up in {setup_s!r} s (steps_per_dispatch="
        f"{cfg.train.steps_per_dispatch}), epoch of {steps} steps in "
        f"{m['epoch_seconds']!r} s ({m['examples_per_s']!r} examples/s), "
        f"loss {first!r} -> {last!r} (first and last third of "
        f"{len(losses)} records), validate {validate_s!r} s: val_loss "
        f"{val['val_loss']!r}, hr@10 {val['hr@10']!r}; launches "
        f"{json.dumps(launches)}")
    return t, cfg, best, launches, {
        "setup_s": setup_s, "steps": steps,
        "steps_per_dispatch": cfg.train.steps_per_dispatch,
        "epoch_s": m["epoch_seconds"], "examples_per_s": m["examples_per_s"],
        "loss_first": first, "loss_last": last, "validate_s": validate_s,
        "val_loss": val["val_loss"], "hr@10": val["hr@10"]}


def _trace_kernels(trace_dir):
    """(the steps' ``step`` spans, {kernel: device events}) of the Chrome
    trace written under ``trace_dir``."""
    import glob

    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    check(len(files) == 1, f"tools: trace files {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = sum(1 for e in events if e.get("name") == "step")
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return spans, {k: sum(1 for n in kernels if sym in n)
                   for k, sym in TOOLS_SYMBOLS.items()}


def _tools_profiling(torch, t, cfg, root, phase11):
    """Part 3: ``TOOLS_STEPS`` bare steps on the warehouse batches from
    seeded params, timed by the host clock up to one closing device
    sync, then ``TOOLS_TRACED`` more inside ``profiling.trace`` (after
    the timed steps: the profiler's start-up, seconds on its first use,
    and the trace's write stay out of the timing); the written trace
    must hold each step's ``step`` span and a device event of each
    training kernel (traced again, up to ``TOOLS_TRACE_TRIES`` times,
    where a trace comes back without them)."""
    import shutil

    from ncf_tpu_torch.models import advanced_ncf, get_model
    from ncf_tpu_torch.train import make_optimizer, make_train_step
    from ncf_tpu_torch.utils.profiling import trace

    batches = list(t.train_iter.epoch(1))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = advanced_ncf.init(gen, cfg.model)
    opt = make_optimizer(cfg.train, steps_per_epoch=len(batches))
    state = opt.init(params)
    step = make_train_step(get_model("advanced_ncf"), cfg, opt, t.neg_cdf,
                           t.item_dept, t.item_cat)
    counters = _launch_counters()
    for c in counters.values():
        c.reset()
    box = {"p": params, "s": state, "g": gen, "i": 0, "loss": []}

    def one():
        b = batches[box["i"] % len(batches)]
        box["i"] += 1
        box["p"], box["s"], box["g"], m_ = step(box["p"], box["s"],
                                                box["g"], b)
        box["loss"].append(m_["loss"])

    def traced(d):
        shutil.rmtree(d, ignore_errors=True)
        with trace(d):
            for _ in range(TOOLS_TRACED):
                one()

    one()                                   # allocates the optimizer state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TOOLS_STEPS):
        one()                               # no device sync
    torch.cuda.synchronize()
    bare_s = time.perf_counter() - t0
    stats = {"steps": TOOLS_STEPS,
             "step_ms_mean": bare_s / TOOLS_STEPS * 1e3,
             "examples_per_s": cfg.train.batch_size * TOOLS_STEPS / bare_s}
    trace_dir = os.path.join(root, "trace")
    t0 = time.perf_counter()
    traced(trace_dir)
    trace_s = time.perf_counter() - t0
    tries = 1
    spans, events = _trace_kernels(trace_dir)
    while min(events.values()) == 0 and tries < TOOLS_TRACE_TRIES:
        log(f"tools: trace {tries} holds no device event of "
            f"{[k for k, n in events.items() if n == 0]}; tracing again")
        tries += 1
        traced(trace_dir)
        spans, events = _trace_kernels(trace_dir)
    check(spans == TOOLS_TRACED, f"tools: {spans} step spans in the "
          f"trace, want {TOOLS_TRACED}")
    missing = [k for k, n in events.items() if n == 0]
    check(not missing, f"tools: no device event of {missing} in "
          f"{TOOLS_TRACE_TRIES} traces")
    n_steps = box["i"]
    launches = {k: c.value for k, c in counters.items()}
    for k, n in launches.items():
        check(n == PER_STEP[k] * n_steps, f"tools: bare steps launched {k} "
              f"{n} times in {n_steps} steps")
    losses = torch.stack(box["loss"]).float().cpu()
    first, last = _loss_fell(losses, "tools bare steps")
    ref = ("not run (--tools-only)" if phase11 is None else
           f"{phase11['step_ms_host_clock']!r} ms, "
           f"{phase11['examples_per_s']!r} examples/s")
    log(f"tools: {TOOLS_STEPS} bare steps: mean "
        f"{stats['step_ms_mean']!r} ms, {stats['examples_per_s']!r} "
        f"examples/s at batch {cfg.train.batch_size}; phase "
        f"11's config A joint auto: {ref}; trace of {TOOLS_TRACED} steps "
        f"{trace_s!r} s, {tries} tr(y/ies), spans {spans}, device events "
        f"{json.dumps(events)}; loss {first!r} -> {last!r}")
    return launches, {"bare_steps": stats, "phase11_a_joint_auto": (
        None if phase11 is None else {k: phase11[k] for k in (
            "step_ms_host_clock", "examples_per_s")}),
        "trace_s": trace_s, "trace_tries": tries, "trace_spans": spans,
        "trace_device_events": events, "loss_first5": first,
        "loss_last5": last}


def _tools_monitoring(t, cfg, best, inter, card):
    """Part 4: ``AlertManager`` over the ``Trainer``'s records (``low-hr10``
    fires exactly when the val record's hr@10 is below 0.3); the API at
    ML-1M width over the warehouse ``Trainer``'s best checkpoint answers
    ``TOOLS_SINGLES`` single-customer ``dispatch`` calls and
    ``_api_requests``; ``build_dashboard`` over its records gives the
    latency p50/p99 computed from the records directly, and no errors."""
    import numpy as np

    from ncf_tpu_torch.api import RecommendationAPI
    from ncf_tpu_torch.serving import (FeatureProcessor, FeatureStore,
                                       ModelServer)
    from ncf_tpu_torch.utils.monitoring import (AlertManager,
                                                build_dashboard,
                                                render_dashboard_text,
                                                save_dashboard_json)

    fired = AlertManager(t.metrics_logger, notifier=lambda a: None).check()
    vals = [r for r in t.metrics_logger.recent(4096) if r.get("kind") == "val"]
    check(len(vals) == 1, f"tools: {len(vals)} val records")
    hr = vals[0]["hr@10"]
    names = sorted(a["policy"] for a in fired)
    check(names == (["low-hr10"] if hr < 0.3 else []),
          f"tools: alerts {names} for a val hr@10 of {hr!r}")

    server = ModelServer.from_checkpoint(
        cfg, best, item_dept=inter.item_dept, item_cat=inter.item_cat,
        device="cuda")
    try:
        api = RecommendationAPI(server, FeatureProcessor(FeatureStore(inter)))
        users = np.random.default_rng(22).choice(inter.num_users,
                                                 TOOLS_SINGLES, replace=False)
        for u in users.tolist():
            rec = _api_call(api, "POST", API_REC, {"customer_id": str(u)},
                            "tools single")
            s, i, _ = server.recommend(u, k=10)
            _same_recs(rec["recommendations"], s, i, f"tools single {u}")
        latency = _api_requests(api, server, users, "tools")
        summary = _no_errors(api, "tools")
        window = 1000
        records = api.metrics.recent(4096)
        check(len(records) <= window, f"tools: {len(records)} records "
              f"exceed the dashboard's window of {window}")
        spec = build_dashboard(api.metrics, window=window)
        panels = {p["metric"]: p["values"] for p in spec["panels"]}
        ms = sorted(float(r["latency_ms"]) for r in records
                    if "latency_ms" in r)
        direct = {"p50": ms[len(ms) // 2],
                  "p99": ms[min(len(ms) - 1, int(len(ms) * 0.99))]}
        got = {k: panels["latency_ms"][k] for k in ("p50", "p99")}
        check(got == direct and got == {
            "p50": summary["latency_ms_p50"], "p99": summary["latency_ms_p99"]},
            f"tools: dashboard latency {got}, records {direct}, summary "
            f"{summary}")
        check(panels["_errors"]["count"] == 0.0,
              f"tools: the dashboard counts {panels['_errors']} errors")
        save_dashboard_json(spec, os.path.join(TOOLS_DIR, "dashboard.json"))
        text = render_dashboard_text(spec)
    finally:
        server.close()
    for line in text.splitlines():
        log(f"tools: {line}")
    log(f"tools: alerts on the Trainer's records {names} (val hr@10 "
        f"{hr!r}); the dashboard's latency {got} over {len(ms)} records "
        f"equals the records'; {card}")
    return {"alerts": names, "val_hr@10": hr, "requests": len(ms),
            "dashboard_latency_ms": got, "api_latency": latency}


def _start_doctor(config, overrides, ckpt_dir):
    """``python -m ncf_tpu_torch.cli doctor`` started as a process of its
    own; (process, start time)."""
    cmd = [sys.executable, "-m", "ncf_tpu_torch.cli", "doctor", "--config",
           config, "--log-level", "WARNING",
           f"train.checkpoint_dir={ckpt_dir}"] + list(overrides)
    return (subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True),
            time.perf_counter())


def _finish_doctor(job, what):
    """(exit code, stdout, {check: (icon, message)}, wall seconds) of a
    doctor process; its eight checks must be listed in order."""
    proc, t0 = job
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    secs = time.perf_counter() - t0
    rows = [ln.split(None, 2) for ln in out.splitlines()
            if ln and not ln.startswith("doctor:")]
    lines = {r[1]: (r[0], r[2] if len(r) > 2 else "") for r in rows
             if len(r) >= 2}
    check(list(lines) == list(DOCTOR_CHECKS),
          f"doctor {what}: rc {proc.returncode}, checks {list(lines)}: "
          f"{out[-2000:]} {err[-2000:]}")
    return proc.returncode, out, lines, secs


def _tools_doctor(torch, root):
    """Part 5: the ``compile`` check in this process (B7 counted), then
    ``doctor`` through the CLI on four configs, the four processes
    started together, with the exit codes they must give."""
    from ncf_tpu_torch.ops import _kernels
    from ncf_tpu_torch.ops.gather import gather_rows
    from ncf_tpu_torch.utils import doctor

    gather_rows.launches.reset()
    name, status, msg = doctor.check_compile_smoke("cuda")
    check(status == "ok" and "bit for bit" in msg, f"doctor compile: {msg}")
    b7 = gather_rows.launches.value
    check(b7 == 1, f"doctor compile: B7 launched {b7} times")
    ck = os.path.join(root, "doctor_ckpt")
    kind = torch.cuda.get_device_name(0)
    jobs = {"ml1m": _start_doctor(ML1M, [], ck),
            "bigvocab": _start_doctor(BIGVOCAB, DOCTOR_BIGVOCAB, ck),
            "ml25m_mesh_on": _start_doctor(
                ML25M, ["mesh.enable=on", "mesh.ici_axis=2"], ck),
            "negative_samples_0": _start_doctor(
                ML1M, ["model.negative_samples=0"], ck)}
    res = {what: _finish_doctor(job, what) for what, job in jobs.items()}
    runs = {what: {"rc": r[0], "s": r[3]} for what, r in res.items()}

    rc, out, lines, _ = res["ml1m"]
    check(rc == 0, f"doctor ml1m exited {rc}: {out}")
    check(lines["devices"][0] == "✓" and kind in lines["devices"][1],
          f"doctor ml1m devices: {lines['devices']}")
    check(lines["compile"][0] == "✓" and "bit for bit" in lines["compile"][1]
          and f"{len(_kernels.SOURCES)} sources built" in lines["compile"][1],
          f"doctor ml1m compile: {lines['compile']}")
    runs["ml1m"]["compile"] = lines["compile"][1]

    rc, out, lines, _ = res["bigvocab"]
    check(rc == 0, f"doctor bigvocab exited {rc}: {out}")
    hbm = lines["hbm"][1]
    check(lines["hbm"][0] == "✓" and f"({DOCTOR_BIGVOCAB_BYTES} B)" in hbm,
          f"doctor bigvocab hbm: {lines['hbm']}")
    runs["bigvocab"]["hbm"] = hbm
    log(f"tools: doctor bigvocab at 12M x 4M: {hbm}; phase 16's measured "
        f"peaks (H100 80GB HBM3, 700 W): {json.dumps(BIG_PEAKS_GB)} GB")

    rc, out, lines, _ = res["ml25m_mesh_on"]
    check(rc == 1 and lines["mesh"][0] == "✗"
          and "torch.distributed.run" in lines["mesh"][1],
          f"doctor ml25m mesh on: rc {rc}: {out}")
    runs["ml25m_mesh_on"]["mesh"] = lines["mesh"][1]

    rc, out, lines, _ = res["negative_samples_0"]
    check(rc == 1 and lines["config"][0] == "✗"
          and "negative_samples" in lines["config"][1],
          f"doctor negative_samples=0: rc {rc}: {out}")
    for what, r in runs.items():
        log(f"tools: doctor[{what}] rc {r['rc']} in {r['s']!r} s (four "
            f"processes at once, torch import and CUDA start included)")
    log(f"tools: doctor compile in this process: {msg}")
    return {"gather_rows": b7}, runs


def phase_tools(torch, card, phase11=None):
    """Phase 22: the host tools on the card — the warehouse, the
    ``Trainer`` on its log, ``profiling`` around bare steps,
    ``monitoring`` over the ``Trainer``'s and the API's records, and
    ``doctor`` through the CLI.  ``phase11``: phase 11's config A joint
    auto step summary, printed beside the bare steps' (None alone).
    Returns ({kernel: launches}, summary)."""
    import shutil

    t_phase = time.perf_counter()
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    os.makedirs(TOOLS_DIR)
    parts = {}
    t0 = time.perf_counter()
    inter, wh = _tools_warehouse(os.path.join(TOOLS_DIR, "warehouse"))
    parts["warehouse_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    t, cfg, best, launches, tr = _tools_trainer(torch, inter, TOOLS_DIR)
    parts["trainer_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    bare, prof = _tools_profiling(torch, t, cfg, TOOLS_DIR, phase11)
    parts["profiling_s"] = time.perf_counter() - t0
    for k, v in bare.items():
        launches[k] += v

    t0 = time.perf_counter()
    mon = _tools_monitoring(t, cfg, best, inter, card)
    parts["monitoring_s"] = time.perf_counter() - t0
    del t
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    b7, doc = _tools_doctor(torch, TOOLS_DIR)
    parts["doctor_s"] = time.perf_counter() - t0
    launches.update(b7)
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    parts["phase_s"] = time.perf_counter() - t_phase
    log(f"tools: parts {json.dumps(parts)}; launches {json.dumps(launches)}"
        f"; {card}")
    return launches, {"parts": parts, "warehouse": wh, "trainer": tr,
                      "profiling": prof, "monitoring": mon, "doctor": doc,
                      "launches": launches, "card": card}


# ------------------------------------------------- the mesh (phases 18-21)

ML25M = os.path.join(ROOT, "configs", "advanced_ncf_ml25m_sharded.yaml")
MESH_DIR = os.path.join(SMOKE_DIR, "mesh")
MESH_LABEL = ("ranks sharing one card over gloo: collectives staged "
              "through host memory; not a multi-card or NVLink figure")
# the kernels the mesh phases must launch, counted per rank
MESH_KERNELS = ("tree_sample_negatives", "onehot_scatter_add",
                "fused_lookup_sum", "fused_tower_fwd", "fused_tower_bwd",
                "topk_scores_streaming", "topk_scores_streaming_int8",
                "topk_scores_pallas")
# the dryrun's batches are tiny, and B3 takes 4,096 rows or more (the
# reference's routing): the other phases launch it
DRYRUN_KERNELS = tuple(k for k in MESH_KERNELS if k != "fused_lookup_sum")
DRYRUN_TOKENS = ("sharded_tables=2", "all_to_all=ok",
                 "sparse_sharded_seq(dcn=2,ici=2)=ok", "sharded_eval",
                 "sharded_topk=ok", "sharded_topk_prepared=ok",
                 "sharded_topk_int8=ok", "fused_tower_mesh=ok",
                 "sequence_mesh=ok")
MESH_STEP_REL = 5e-5      # tests/test_torch_train_step.py's step tolerance
MESH_SPARSE_TOL = 1e-6    # of each touched row's change (phase 16's measure)
MESH_RUN_STEPS = 8        # two runs of the mesh sparse step, equal bits
P21_MID_EVERY = 40        # dispatches between phase 21's mid-epoch saves
P21_EVAL_USERS = 20_000   # phase 21's eval users (of 162,542)


def _counts():
    from ncf_tpu_torch.ops import launch_counters

    return {k: c.value for k, c in launch_counters().items()}


# a rank's kernel launches on the main path of its phase: the mesh runs,
# not the one-rank runs they are held to
_TALLY: dict = {}


def _tally(fn, *args, **kw):
    """``fn(*args, **kw)``, its kernel launches added to ``_TALLY``."""
    before = _counts()
    out = fn(*args, **kw)
    for k, v in _counts().items():
        _TALLY[k] = _TALLY.get(k, 0) + v - before[k]
    return out


def _mesh_ranks(program, world, extra=(), timeout=600):
    """Run this script's rank ``program`` on ``world`` ranks sharing the
    card (fresh processes; the kernels are already built).  Returns
    (each rank's result, wall seconds); a rank that fails fails the run
    with every rank's output."""
    from ncf_tpu_torch.parallel.multihost import run_ranks

    os.makedirs(MESH_DIR, exist_ok=True)
    t0 = time.perf_counter()
    try:
        run_ranks("chip_smoke", world, ["--program", program, *extra],
                  timeout=timeout, capture=True)
    except RuntimeError as e:
        raise SmokeFailure(f"mesh {program}: {str(e)[-6000:]}")
    res = []
    for r in range(world):
        with open(os.path.join(MESH_DIR, f"{program}.{r}.json")) as f:
            res.append(json.load(f))
    return res, time.perf_counter() - t0


def _sum_launches(per_rank):
    out = {}
    for r in per_rank:
        for k, v in r.items():
            out[k] = out.get(k, 0) + v
    return out


def phase_mesh_dryrun(torch, card):
    """Phase 18: ``dryrun_multichip(4)`` on the card."""
    from ncf_tpu_torch.parallel.dryrun import dryrun_report

    t0 = time.perf_counter()
    try:
        line, per_rank = dryrun_report(4, device="cuda", timeout=600)
    except RuntimeError as e:
        raise SmokeFailure(f"mesh dryrun: {str(e)[-6000:]}")
    secs = time.perf_counter() - t0
    for tok in DRYRUN_TOKENS:
        check(tok in line, f"mesh dryrun: no {tok!r} in {line}")
    check(len(per_rank) == 4, "mesh dryrun: a rank reported no launches")
    for name in DRYRUN_KERNELS:
        check(all(r.get(name, 0) > 0 for r in per_rank),
              f"mesh dryrun: {name} not launched on every rank {per_rank}")
    log(line)
    return _sum_launches(per_rank), {"seconds": secs,
                                     "launches_per_rank": per_rank,
                                     "label": MESH_LABEL, "card": card}


# ------------------------------------------------------- rank programs

def _rank_main(argv):
    """Entry of a rank started by ``_mesh_ranks``."""
    import torch

    from ncf_tpu_torch.parallel import multihost
    from ncf_tpu_torch.parallel.mesh import make_mesh

    rank, world, store, rest = multihost.rank_args(argv)
    prog = rest[rest.index("--program") + 1]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    multihost.initialize_distributed(
        init_method=f"file://{store}", world_size=world, rank=rank,
        device="cuda", timeout_s=300)
    mesh = make_mesh(dcn=1, ici=-1)
    try:
        out = RANK_PROGRAMS[prog](torch, mesh)
    finally:
        multihost.destroy()
    out["launches"] = dict(_TALLY)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    with open(os.path.join(MESH_DIR, f"{prog}.{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _p19(torch, mesh):
    """Phase 19 on one rank: the bigvocab catalog (4M x 64) split over the
    ranks, B 1 and 64, through B5, B8, B5 prepared and B6."""
    import numpy as np

    from ncf_tpu_torch.ops import topk
    from ncf_tpu_torch.parallel import sharded_topk as st
    from ncf_tpu_torch.utils.config import Config

    cfg = Config.from_yaml(BIGVOCAB)
    I, D = cfg.data.synthetic_items, cfg.model.mf_dim
    gen = torch.Generator(device="cuda").manual_seed(19)
    table = torch.randn((I, D), generator=gen, device="cuda") * 0.1
    bias = torch.randn((I,), generator=gen, device="cuda") * 0.05
    qs = {B: torch.randn((B, D), generator=gen, device="cuda")
          for B in (1, 64)}
    # planted ties across the shard boundary: the best row of each
    # batch's first user copied into the second shard (and the first)
    for q in qs.values():
        best = int(topk.topk_scores_dense(q[:1], table, 1, bias)[1][0, 0])
        for j in (I // 2 + 5, I - 7, 11):
            table[j], bias[j] = table[best], bias[best]
    qsample = torch.cat(list(qs.values())).abs().amax(0, keepdim=True)
    t_loc, b_loc, n = st.shard_items(table, bias, mesh)
    prep = st.shard_prepare_items(table, bias, mesh)
    prep8 = st.shard_prepare_items_int8(table, bias, qsample, mesh)
    k = 10
    calls = {
        "streaming": lambda q: st.sharded_topk_scores(
            q, t_loc, b_loc, n, mesh, k, impl="streaming"),
        "pallas": lambda q: st.sharded_topk_scores(
            q, t_loc, b_loc, n, mesh, k, impl="pallas"),
        "prepared": lambda q: st.sharded_topk_scores_prepared(
            q, prep, mesh, k),
        "int8": lambda q: st.sharded_topk_scores_prepared(
            q, prep8, mesh, k, seg_top=1)}
    got = {(name, B): _tally(fn, q) for name, fn in calls.items()
           for B, q in qs.items()}
    torch.cuda.synchronize()
    out = {"equal": {}, "timing": {}}
    # each rank's local pass (device ms, CUDA events) and the merge (host
    # ms: the all_gather through host memory and the top-k of E * k)
    local = {
        "streaming": lambda q: topk.topk_scores(q, t_loc, k, b_loc,
                                                impl="streaming"),
        "pallas": lambda q: topk.topk_scores(q, t_loc, k, b_loc,
                                             impl="pallas"),
        "prepared": lambda q: topk.topk_scores_streaming(q, prep.local, k),
        "int8": lambda q: topk.topk_scores_streaming_int8(
            q, prep8.local, k, seg_top=1)}
    for name, fn in local.items():
        for B, q in qs.items():
            v, i = fn(q)
            merge = []
            for _ in range(7):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st._merge(mesh, v, i, prep.rows_loc if name == "prepared"
                          else prep8.rows_loc if name == "int8"
                          else t_loc.shape[0], n, k)
                torch.cuda.synchronize()
                merge.append((time.perf_counter() - t0) * 1e3)
            out["timing"][f"{name}/B{B}"] = {
                "local_device_ms": cuda_ms(lambda: fn(q), 5),
                "merge_host_ms": statistics.median(merge)}
    if mesh.rank == 0:
        ref = {"streaming": lambda q: topk.topk_scores(
                   q, table, k, bias, impl="streaming"),
               "pallas": lambda q: topk.topk_scores(q, table, k, bias,
                                                    impl="pallas"),
               "prepared": lambda q: topk.topk_scores(
                   q, topk.prepare_items(table, bias), k)}
        one8 = topk.prepare_items_int8(table, bias, qsample,
                                       block_items=prep8.block_items,
                                       seg_width=prep8.seg_width)
        ref["int8"] = lambda q: topk.topk_scores_streaming_int8(
            q, one8, k, seg_top=1)
        for (name, B), (v, i) in got.items():
            rv, ri = ref[name](qs[B])
            filled = rv > -1e38
            same_ids = bool(torch.equal(torch.where(filled, i, -1),
                                        torch.where(filled, ri, -1)))
            check(same_ids, f"mesh serving {name} B={B}: ids differ from "
                  "one device")
            err = float((v - rv).abs().max())
            check(err <= 1e-6 * max(1.0, float(rv.abs().max())),
                  f"mesh serving {name} B={B}: values differ by {err}")
            # the planted ties come in id order
            row = i[0].tolist()
            tie = [j for j in row if torch.equal(table[j], table[row[0]])]
            check(tie == sorted(tie), f"mesh serving {name}: tie order")
            out["equal"][f"{name}/B{B}"] = {"ids_equal": same_ids,
                                            "max_value_diff": err,
                                            "ties": len(tie)}
    return out


def _ml25m_cfg(E, f32):
    from ncf_tpu_torch.parallel.mesh import pad_rows
    from ncf_tpu_torch.utils.config import Config

    cfg = Config.from_yaml(ML25M)
    m = cfg.model
    # the shipped sizes are odd; pad_rows makes the tables divide ici
    m.num_users = pad_rows(cfg.data.synthetic_users, E)
    m.num_items = pad_rows(cfg.data.synthetic_items, E)
    m.num_departments, m.num_categories = 9, 30
    if f32:
        m.compute_dtype, m.dropout = "float32", 0.0
    cfg.train.embedding_scatter = "exact"
    return cfg


def _ml25m_data(torch, cfg, steps, seed):
    import numpy as np

    from ncf_tpu_torch.data import make_sampling_cdf

    m, B = cfg.model, cfg.train.batch_size
    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, m.num_items + 1) ** 0.8
    rng.shuffle(pop)
    pop /= pop.sum()
    pos_cdf = np.cumsum(pop)
    batches = [{
        "user_ids": np.sort(rng.integers(0, cfg.data.synthetic_users, B)),
        "item_ids": np.minimum(np.searchsorted(pos_cdf, rng.random(B)),
                               cfg.data.synthetic_items - 1),
        "hour": rng.integers(0, 24, B), "day": rng.integers(0, 7, B),
        "month": rng.integers(0, 12, B),
        "day_of_year": rng.integers(0, 365, B)} for _ in range(steps)]
    batches = [{k: torch.from_numpy(v.astype(np.int32)).cuda()
                for k, v in b.items()} for b in batches]
    consts = (make_sampling_cdf(1.0 / (pop * 1e6 + 1.0), device="cuda"),
              rng.integers(0, 9, m.num_items).astype(np.int32),
              rng.integers(0, 30, m.num_items).astype(np.int32))
    return batches, consts


def _host_ms(torch, fn, n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _p20a(torch, mesh, out):
    """Phase 20(a): the ML-25M sharded config over the mesh against one
    rank (f32): 3 dense steps with dropout off, params and Adam moments;
    one step with the config's dropout on the plain layers, its Adam
    moments (after one step from zero, ``(1 - b1) g`` and ``(1 - b2)
    g^2``: the gradients themselves).  The params after a step with
    dropout are reported, not held: Adam's first update is ``lr g / (|g|
    + eps)``, so a gradient at the level of the sums' rounding moves its
    param by up to ``lr`` either way.  Then the shipped bf16 config
    timed."""
    from ncf_tpu_torch.models import advanced_ncf
    from ncf_tpu_torch.ops import embedding as emb
    from ncf_tpu_torch.parallel.mesh import (SHARDED, gather_pytree,
                                             param_shardings, shard_pytree)
    from ncf_tpu_torch.train import make_optimizer, make_train_step
    from ncf_tpu_torch.train.checkpoint import _leaves_with_path

    E = mesh.shape["ici"]
    cfg = _ml25m_cfg(E, f32=True)
    batches, consts = _ml25m_data(torch, cfg, 3, seed=20)
    dropout = _ml25m_cfg(E, f32=False).model.dropout

    def init():
        return advanced_ncf.init(torch.Generator(device="cuda").manual_seed(
            0), cfg.model)

    def run(params, mesh_, specs, steps):
        opt = make_optimizer(cfg.train, 3)
        state = opt.init(params)
        step = make_train_step(advanced_ncf, cfg, opt, *consts,
                               device="cuda", mesh=mesh_, shardings=specs)
        gen = torch.Generator(device="cuda").manual_seed(1)
        losses = []
        for b in batches[:steps]:
            params, state, gen, mt = step(params, state, gen, b)
            losses.append(float(mt["loss"]))
        return [params, state["mu"], state["nu"]], losses

    emb.set_scatter_impl("auto", "split")
    full = init()
    specs = param_shardings(full, mesh)
    rows = {k: full[k].shape[0] for k, s in specs.items() if s == SHARDED}
    check(sorted(rows) == ["item_emb", "user_emb"],
          f"mesh step: tables not sharded {rows}")
    del full
    # the port reads mesh.embedding_exchange nowhere: under "pjit" and
    # "explicit" alike the Trainer registers every sharded table, so one
    # run stands for both settings
    cfg.mesh.embedding_exchange = "explicit"
    compared = {}
    for rate, steps, held in ((0.0, 3, ("params", "mu", "nu")),
                              (dropout, 1, ("mu", "nu"))):
        cfg.model.dropout = rate
        one = None
        if mesh.rank == 0:
            one, one_losses = run(init(), None, None, steps)
        emb.set_exchange(mesh, rows, cfg.mesh.exchange_capacity_factor)
        # fresh params: a step updates the replicated leaves in place
        got, losses = _tally(run, shard_pytree(init(), specs, mesh), mesh,
                             specs, steps)
        emb.clear_exchange()
        got = [gather_pytree(t, specs, mesh) for t in got]
        if mesh.rank == 0:
            worst = {}
            for name, g, w in zip(("params", "mu", "nu"), got, one):
                worst[name] = (0.0, "")
                for (path, y), (_, x) in zip(_leaves_with_path(w),
                                             _leaves_with_path(g)):
                    top = float(y.abs().max())
                    err = float((x - y).abs().max())
                    check(name not in held
                          or err <= max(MESH_STEP_REL * top, 1e-12),
                          f"mesh step (dropout {rate}): {name}.{path} "
                          f"differs by {err} > {MESH_STEP_REL * top} from "
                          f"one rank")
                    worst[name] = max(worst[name],
                                      (err / max(top, 1e-30), path))
            compared[f"dropout_{rate}"] = {
                "steps": steps, "held": held,
                "worst_rel_of_leaf_max": worst, "losses_mesh": losses,
                "losses_one": one_losses}
        del one, got
    if mesh.rank == 0:
        out["ml25m_vs_one_rank"] = compared

    # the shipped config (bf16, dropout, the fused tower), timed
    cfg = _ml25m_cfg(E, f32=False)
    full = advanced_ncf.init(torch.Generator(device="cuda").manual_seed(0),
                             cfg.model)
    emb.set_exchange(mesh, rows, 0.0)
    params = shard_pytree(full, specs, mesh)
    del full
    opt = make_optimizer(cfg.train, 10)
    state = opt.init(params)
    step = make_train_step(advanced_ncf, cfg, opt, *consts, device="cuda",
                           mesh=mesh, shardings=specs)
    gen = torch.Generator(device="cuda").manual_seed(1)
    box = [params, state, gen]

    def one_step(b=batches[0]):
        box[0], box[1], box[2], _ = step(box[0], box[1], box[2], b)

    _tally(one_step)
    host = _host_ms(torch, one_step, 5)
    prof = device_profile(one_step, 2, top=6)
    emb.clear_exchange()
    out["ml25m_bf16"] = {"host_ms_per_step": host,
                         "examples_per_s": cfg.train.batch_size / host * 1e3,
                         "device_ms_per_step": (prof or {}).get(
                             "device_ms_per_call"),
                         "busy_share": (prof or {}).get("busy_share"),
                         "top_device_ms": (prof or {}).get(
                             "kernels_ms_per_call")}


def _p20b(torch, mesh, out):
    """Phase 20(b, c): the bigvocab sparse step over the mesh at 12M x
    4M against one rank's from the same state, clip on and off; two runs
    of 8 mesh steps in equal bits; timed."""
    import copy
    import dataclasses

    from ncf_tpu_torch.models import get_model
    from ncf_tpu_torch.parallel.embedding_sharding import exchange_gather
    from ncf_tpu_torch.parallel.mesh import rows_of
    from ncf_tpu_torch.train import (init_sparse_opt_state, make_optimizer,
                                     make_schedule, make_sparse_train_step)

    cfg, params, consts, draw = _big_setup(torch)
    cfg.model.dropout = 0.0
    cfg.train.embedding_weight_decay = 0.0
    model = get_model(cfg.model.name)
    batch = {k: v[0] for k, v in draw(1, 20)[0].items()}    # one [B]
    tables = ("user_emb", "item_emb")
    # every rank keeps its rows; rank 0 also the whole tables, for the
    # one-rank step
    orig = {k: params[k][rows_of(mesh, params[k].shape[0])].clone()
            for k in tables}
    full_orig = ({k: params[k] for k in tables} if mesh.rank == 0
                 else None)
    dense_orig = {k: v for k, v in params.items() if k not in tables}
    del params
    torch.cuda.empty_cache()

    def fresh(sharded):
        p = copy.deepcopy(dense_orig)
        for k in tables:
            p[k] = orig[k].clone() if sharded else full_orig[k].clone()
        return p

    def step_fn(clip, mesh_):
        c = copy.deepcopy(cfg)
        c.train.gradient_clip_norm = clip
        dense_opt = make_optimizer(dataclasses.replace(
            c.train, gradient_clip_norm=0.0), 10)
        return dense_opt, make_sparse_train_step(
            model, c, dense_opt, make_schedule(c.train, 10), *consts,
            mesh=mesh_, device="cuda")

    def mesh_step(fn, p, s, b, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return fn(p, s, gen, b)

    ids_u, ids_i = batch["user_ids"], batch["item_ids"]
    results = {}
    for clip in (cfg.train.gradient_clip_norm, 0.0):
        if mesh.rank == 0:
            dense_opt, fn = step_fn(clip, None)
            p1 = fresh(False)
            p1, s1, _, _ = mesh_step(
                fn, p1, init_sparse_opt_state(dense_opt, p1), batch, 7)
        dense_opt, fn = step_fn(clip, mesh)
        pm = fresh(True)
        pm, sm, _, _ = _tally(mesh_step, fn, pm,
                              init_sparse_opt_state(dense_opt, pm), batch, 7)
        # the rows the batch touched (users and positives), gathered from
        # their owners through the exchange
        got = {"user_rows": exchange_gather(mesh, pm["user_emb"], ids_u),
               "item_rows": exchange_gather(mesh, pm["item_emb"], ids_i),
               "user_acc": exchange_gather(
                   mesh, sm["user_acc"][:, None], ids_u)[:, 0]}
        # rows no id touches keep their bits on every rank
        sl = rows_of(mesh, orig["user_emb"].shape[0] * mesh.shape["ici"])
        loc = ids_u.long() - sl.start
        touched = torch.zeros(orig["user_emb"].shape[0], dtype=torch.bool,
                              device="cuda")
        touched[loc[(loc >= 0) & (loc < touched.shape[0])]] = True
        same = (pm["user_emb"].view(torch.int32)
                == orig["user_emb"].view(torch.int32)).all(1)
        check(bool(same[~touched].all()),
              "mesh sparse: untouched user rows changed")
        if mesh.rank == 0:
            summ = {}
            for name, want, old in (
                    ("user_rows", p1["user_emb"][ids_u.long()],
                     full_orig["user_emb"][ids_u.long()]),
                    ("item_rows", p1["item_emb"][ids_i.long()],
                     full_orig["item_emb"][ids_i.long()]),
                    ("user_acc", s1["user_acc"][ids_u.long()], None)):
                g = got[name]
                change = float((want.float() - (
                    0 if old is None else old.float())).abs().max())
                err = float((g.float() - want.float()).abs().max())
                check(err <= MESH_SPARSE_TOL * max(change, 1e-30),
                      f"mesh sparse clip={clip}: {name} differ by {err} "
                      f"(change {change})")
                summ[name] = {"max_diff": err, "max_change": change,
                              "equal_bits": bool(torch.equal(g, want))}
            results[f"clip={clip}"] = summ
            del p1, s1
        del pm, sm
        torch.cuda.empty_cache()
    if mesh.rank == 0:
        out["bigvocab_vs_one_rank"] = results
    full_orig = None
    torch.cuda.empty_cache()

    # (c) two runs of 8 mesh steps from one state end in equal bits
    dense_opt, fn = step_fn(cfg.train.gradient_clip_norm, mesh)
    stack = draw(1, 21)[0]                                  # [K, B]
    batches = [{k: v[i] for k, v in stack.items()}
               for i in range(MESH_RUN_STEPS)]
    runs, host = [], []
    for _ in range(2):
        p = fresh(True)
        s = init_sparse_opt_state(dense_opt, p)
        gen = torch.Generator(device="cuda").manual_seed(9)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            p, s, gen, mt = _tally(fn, p, s, gen, b)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3 / MESH_RUN_STEPS)
        runs.append((p, s, float(mt["loss"])))
        del p, s
    (pa, sa, la), (pb, sb, lb) = runs
    for k in tables:
        check(torch.equal(pa[k], pb[k]),
              f"mesh sparse: two runs differ in {k}")
    check(torch.equal(sa["user_acc"], sb["user_acc"]) and la == lb,
          "mesh sparse: two runs differ")
    del runs, pa, sa
    box = [pb, sb, gen]

    def one_step(b=batches[0]):
        box[0], box[1], box[2], _ = fn(box[0], box[1], box[2], b)

    prof = device_profile(one_step, 2, top=6)
    shard_gb = sum(t.numel() * t.element_size() for t in orig.values()) / 1e9
    out["bigvocab_mesh"] = {
        "host_ms_per_step": host, "loss": la,
        "device_ms_per_step": (prof or {}).get("device_ms_per_call"),
        "busy_share": (prof or {}).get("busy_share"),
        "top_device_ms": (prof or {}).get("kernels_ms_per_call"),
        "table_shard_gb": shard_gb}


def _p20(torch, mesh):
    out = {}
    _p20a(torch, mesh, out)
    _p20b(torch, mesh, out)
    return out


def _p21_overrides(d):
    from ncf_tpu_torch.parallel.mesh import pad_rows
    from ncf_tpu_torch.utils.config import Config

    cfg = Config.from_yaml(ML25M)
    return ["train.num_epochs=1", "data.dataset=synthetic",
            # the shipped counts are odd; padded so the tables shard
            f"data.synthetic_users={pad_rows(cfg.data.synthetic_users, 2)}",
            f"data.synthetic_items={pad_rows(cfg.data.synthetic_items, 2)}",
            f"train.checkpoint_dir={d}",
            f"train.metrics_file={os.path.join(d, 'metrics.jsonl')}",
            f"train.checkpoint_every_dispatches={P21_MID_EVERY}",
            # a seeded sample of the eval users keeps the phase short
            f"data.eval_user_sample={P21_EVAL_USERS}"]


def _p21_ckpts(d):
    """(the epoch-end checkpoint, the mid-epoch ones) of phase 21's run."""
    from ncf_tpu_torch.train import checkpoint as ckpt_lib

    ends, mids = [], []
    for name in sorted(os.listdir(d)):
        path = os.path.join(d, name)
        if not os.path.exists(os.path.join(path, ckpt_lib.MANIFEST)):
            continue
        with open(os.path.join(path, ckpt_lib.MANIFEST)) as f:
            extra = json.load(f).get("extra") or {}
        (mids if extra.get("in_epoch") else ends).append(path)
    return ends[-1], mids


def _p21(torch, mesh):
    """Phase 21 on one rank: a ``Trainer`` over the mesh restores the
    CLI run's epoch checkpoint and ranks the eval users (ranks and
    scores), rank 0 also with the one-device evaluator on the whole
    params; then it resumes the first mid-epoch checkpoint and must end
    the epoch in the epoch checkpoint's bits, generator included."""
    import numpy as np

    from ncf_tpu_torch import cli
    from ncf_tpu_torch.convert import tree_leaves
    from ncf_tpu_torch.evals.evaluate import DeviceEvaluator
    from ncf_tpu_torch.evals.metrics import positive_ranks
    from ncf_tpu_torch.parallel.mesh import gather_pytree
    from ncf_tpu_torch.train import Trainer
    from ncf_tpu_torch.utils.config import Config

    d = os.path.join(SMOKE_DIR, "p21")
    end, mids = _p21_ckpts(d)
    check(bool(mids), "mesh loop: no mid-epoch checkpoint")
    cfg = Config.from_yaml(ML25M)
    cfg.apply_overrides(_p21_overrides(d))
    inter = cli._load_interactions(cfg)
    cfg.train.checkpoint_dir = os.path.join(MESH_DIR, "p21")
    cfg.train.metrics_file = ""
    cfg.train.checkpoint_every_dispatches = 0
    t = Trainer(cfg, inter, mesh=mesh, device="cuda")
    check(t.resume(end), "mesh loop: no epoch checkpoint")

    def evaluator(mesh_):
        # what ``Trainer.validate`` builds (``data.eval_protocol``
        # sampled); the ranks come from its scores by ``positive_ranks``
        return DeviceEvaluator(
            t.model, t.cfg.model, t.eval_set,
            batch_size=t.cfg.data.eval_batch_size, item_dept=t.item_dept,
            item_cat=t.item_cat, user_history=t.eval_history,
            device="cuda", mesh=mesh_)

    def ranks_of(scores):
        return positive_ranks(torch.from_numpy(scores)).numpy()

    scores = _tally(evaluator(mesh).scores, t.params)
    whole = gather_pytree(t.params, t.shardings, mesh)
    end_rng = t.rng.get_state()
    out = {}
    if mesh.rank == 0:
        one = evaluator(None).scores(whole)
        np.savez(os.path.join(MESH_DIR, "p21_ranks.npz"),
                 mesh_ranks=ranks_of(scores), mesh_scores=scores,
                 one_ranks=ranks_of(one), one_scores=one)
    t.resume(mids[0])
    _tally(t.train_epoch, t.start_epoch)
    resumed = gather_pytree(t.params, t.shardings, mesh)
    out["resume_equal"] = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(resumed), tree_leaves(whole)))
    out["resume_rng_equal"] = bool(torch.equal(t.rng.get_state(), end_rng))
    out["resumed_from"] = os.path.basename(mids[0])
    out["ended_at"] = os.path.basename(end)
    return out


def _p21nccl(torch, mesh):
    """One step over the ``(1, 1)`` mesh on NCCL (its world collectives
    run) against the step given no mesh (the process's own ``(1, 1)``
    mesh, where none runs), from one state: equal bits."""
    import copy

    from ncf_tpu_torch.convert import tree_leaves
    from ncf_tpu_torch.models import advanced_ncf
    from ncf_tpu_torch.train import make_optimizer, make_train_step

    check(mesh.backend == "nccl" and mesh.size == 1,
          f"mesh loop: the (1, 1) mesh is on {mesh.backend}")
    cfg = _ml25m_cfg(1, f32=False)
    cfg.train.batch_size = 8192
    batches, consts = _ml25m_data(torch, cfg, 1, seed=22)
    p0 = advanced_ncf.init(torch.Generator(device="cuda").manual_seed(0),
                           cfg.model)
    got = []
    for m in (mesh, None):
        p = copy.deepcopy(p0)
        opt = make_optimizer(cfg.train, 10)
        s = opt.init(p)
        step = make_train_step(advanced_ncf, cfg, opt, *consts,
                               device="cuda", mesh=m)
        gen = torch.Generator(device="cuda").manual_seed(3)
        p, s, _, mt = (_tally if m is not None else
                       (lambda f, *a: f(*a)))(step, p, s, gen, batches[0])
        got.append((tree_leaves(p) + tree_leaves(s), float(mt["loss"])))
    equal = all(torch.equal(a, b) for a, b in zip(got[0][0], got[1][0]))
    check(equal and got[0][1] == got[1][1],
          "mesh loop: the (1, 1) NCCL step differs from the step without "
          "a mesh")
    return {"backend": mesh.backend, "equal_bits": equal,
            "loss": got[0][1]}


RANK_PROGRAMS = {"p19": _p19, "p20": _p20, "p21": _p21}


def phase_mesh_serving(torch, card):
    """Phase 19: the bigvocab catalog split over 2 ranks."""
    res, secs = _mesh_ranks("p19", 2)
    per_rank = [r["launches"] for r in res]
    for name in ("topk_scores_streaming", "topk_scores_pallas",
                 "topk_scores_streaming_int8"):
        check(all(r.get(name, 0) > 0 for r in per_rank),
              f"mesh serving: {name} not launched on every rank")
    summary = {"seconds": secs, "equal": res[0]["equal"],
               "timing_per_rank": [r["timing"] for r in res],
               "launches_per_rank": per_rank,
               "peak_gb_per_rank": [r["peak_gb"] for r in res],
               "label": MESH_LABEL, "card": card}
    return _sum_launches(per_rank), summary


def phase_mesh_training(torch, card):
    """Phase 20: ML-25M sharded and bigvocab sparse over 2 ranks."""
    res, secs = _mesh_ranks("p20", 2, timeout=900)
    per_rank = [r["launches"] for r in res]
    for name in ("tree_sample_negatives", "onehot_scatter_add",
                 "fused_lookup_sum", "fused_tower_fwd", "fused_tower_bwd"):
        check(all(r.get(name, 0) > 0 for r in per_rank),
              f"mesh training: {name} not launched on every rank")
    r0 = res[0]
    shard = r0["bigvocab_mesh"]["table_shard_gb"]
    reckon = (f"bigvocab tables {2 * shard:.2f} GB f32: a rank holds its "
              f"half ({shard:.2f} GB) and, in this phase, a saved copy of "
              f"it and rank 0 the whole tables for the one-rank step; "
              f"peaks {[round(r['peak_gb'], 2) for r in res]} GB of 80")
    log("mesh training memory: " + reckon)
    summary = {"seconds": secs, "ml25m_vs_one_rank": r0[
                   "ml25m_vs_one_rank"],
               "bigvocab_vs_one_rank": r0["bigvocab_vs_one_rank"],
               "ml25m_bf16_per_rank": [r["ml25m_bf16"] for r in res],
               "bigvocab_mesh_per_rank": [r["bigvocab_mesh"] for r in res],
               "launches_per_rank": per_rank,
               "peak_gb_per_rank": [r["peak_gb"] for r in res],
               "memory": reckon, "label": MESH_LABEL, "card": card}
    return _sum_launches(per_rank), summary


def phase_mesh_loop(torch, card):
    """Phase 21: ``torch.distributed.run`` of the CLI over 2 ranks, its
    validate against the one-device evaluator, its sharded checkpoint
    consolidated and restored, a mid-epoch resume over the mesh, and a
    ``(1, 1)`` step over NCCL."""
    import shutil

    import numpy as np

    from ncf_tpu_torch.evals.evaluate import metrics_from_ranks
    from ncf_tpu_torch.models import advanced_ncf
    from ncf_tpu_torch.train import checkpoint as ckpt_lib
    from ncf_tpu_torch.train.checkpoint import _leaves_with_path, _load_leaf
    from ncf_tpu_torch.utils.config import Config

    d = os.path.join(SMOKE_DIR, "p21")
    shutil.rmtree(d, ignore_errors=True)
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR, exist_ok=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "ncf_tpu_torch.cli", "train",
           "--config", ML25M, "--device", "cuda", "--log-level", "WARNING",
           *_p21_overrides(d)]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    t0 = time.perf_counter()
    run = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=900, cwd=ROOT)
    cli_s = time.perf_counter() - t0
    check(run.returncode == 0, f"mesh loop: torch.distributed.run of the "
          f"CLI exited {run.returncode}\n{run.stdout[-3000:]}\n"
          f"{run.stderr[-6000:]}")
    rules = [ln for ln in (run.stdout + run.stderr).splitlines()
             if "backend" in ln and "rank" in ln]
    check(len(rules) >= 2, "mesh loop: the ranks printed no backend rule")
    with open(os.path.join(d, "metrics.jsonl")) as f:
        recs = [json.loads(x) for x in f]
    val = [r for r in recs if r.get("kind") == "val"][-1]
    steps = max(r["step"] for r in recs if r.get("kind") == "train")
    end, mids = _p21_ckpts(d)
    man = json.load(open(os.path.join(end, ckpt_lib.MANIFEST)))
    check(man["leaves"]["params.user_emb"]["kind"] == "sharded",
          "mesh loop: the checkpoint's tables are not sharded")

    # consolidated bit for bit, and restored on one process
    cons = ckpt_lib.consolidate(end, os.path.join(MESH_DIR,
                                                  "p21_consolidated"))
    cman = json.load(open(os.path.join(cons, ckpt_lib.MANIFEST)))
    for path_s, meta in man["leaves"].items():
        if meta["kind"] == "scalar":
            continue
        a = _load_leaf(end, meta)
        b = _load_leaf(cons, cman["leaves"][path_s])
        check(a.dtype == b.dtype and a.shape == b.shape
              and a.tobytes() == b.tobytes(),
              f"mesh loop: consolidated {path_s} differs")
    cfg = Config.from_yaml(ML25M)
    cfg.model.num_users, cfg.model.num_items = (
        man["leaves"][f"params.{k}"]["global_shape"][0]
        for k in ("user_emb", "item_emb"))
    tmpl = advanced_ncf.init(torch.Generator(device="cuda").manual_seed(0),
                             cfg.model, device="meta")
    state, _ = ckpt_lib.restore(end, {"params": _materialize(torch, tmpl)},
                                device="cuda")
    for p, v in _leaves_with_path(state["params"]):
        check(np.array_equal(v.float().cpu().numpy(), _load_leaf(
            cons, cman["leaves"][f"params.{p}"]).astype(np.float32)),
            f"mesh loop: restored params.{p} differs")
    del state
    torch.cuda.empty_cache()

    res, p21_s = _mesh_ranks("p21", 2, timeout=900)
    check(all(r["resume_equal"] and r["resume_rng_equal"] for r in res),
          "mesh loop: the mid-epoch resume ended in other bits")
    rk = np.load(os.path.join(MESH_DIR, "p21_ranks.npz"))
    got, want = rk["mesh_ranks"], rk["one_ranks"]
    gap = float(np.abs(rk["mesh_scores"] - rk["one_scores"]).max())
    near = _near_ties(rk["one_scores"], np.zeros(len(want), np.int64), gap)
    held = _hold_ranks(got, want, near, gap, "mesh loop")
    mine = metrics_from_ranks(got)
    for k in ("hr@10", "ndcg@10", "mrr@10", "hr@1", "hr@5"):
        check(mine[k] == val[k],
              f"mesh loop: {k} {val[k]} (CLI) vs {mine[k]} (ranks)")
    one = metrics_from_ranks(want)

    nccl, nccl_s = _nccl_one_rank(torch)
    summary = {"cli_seconds": cli_s, "steps": steps,
               "validate_cli": {k: val[k] for k in ("val_loss", "hr@10",
                                                     "ndcg@10")},
               "validate_one_device": {k: one[k] for k in ("hr@10",
                                                           "ndcg@10")},
               "ranks": held, "resumed_from": res[0]["resumed_from"],
               "checkpoint_leaves_sharded": sum(
                   v["kind"] == "sharded" for v in man["leaves"].values()),
               "p21_seconds": p21_s, "nccl": nccl, "nccl_seconds": nccl_s,
               "backend_rule": rules[:2], "label": MESH_LABEL, "card": card}
    launches = _sum_launches([r["launches"] for r in res]
                             + [nccl["launches"]])
    return launches, summary


def _nccl_one_rank(torch):
    """``_p21nccl`` in this process, as the one rank of an NCCL group
    (joined through a ``file://`` store, left after)."""
    from ncf_tpu_torch.parallel import multihost
    from ncf_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    multihost.initialize_distributed(
        init_method=f"file://{os.path.join(MESH_DIR, 'nccl_store')}",
        world_size=1, rank=0, device="cuda", timeout_s=120)
    _TALLY.clear()
    try:
        out = _p21nccl(torch, make_mesh())
    finally:
        multihost.destroy()
    out["launches"] = dict(_TALLY)
    return out, time.perf_counter() - t0


def _materialize(torch, tree):
    from ncf_tpu_torch.convert import tree_map

    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="cuda"), tree)


def run_mesh_phases(torch, card):
    """Phases 18-21 (the parallel layer); returns their kernel launches,
    summed over the ranks of each mesh."""
    launches = {}
    for name, fn in (("mesh_dryrun", phase_mesh_dryrun),
                     ("mesh_serving", phase_mesh_serving),
                     ("mesh_training", phase_mesh_training),
                     ("mesh_loop", phase_mesh_loop)):
        t0 = time.perf_counter()
        got, summary = fn(torch, card)
        log(f"phase {name} {time.perf_counter() - t0:.1f} s, kernel "
            f"launches {json.dumps(got)}")
        log(f"{name}_json: " + json.dumps(summary))
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    for name in MESH_KERNELS:
        check(launches.get(name, 0) > 0,
              f"{name}: never launched under the mesh")
    return launches


def _kernel_entry(name, launches, max_abs_err, r):
    """A kernel's entry of the ``kernels`` line (``r``: its timing row)."""
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err, "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}


def main() -> int:
    import torch

    why = None
    if not torch.cuda.is_available():
        why = "CUDA is not available"
    elif not os.path.isdir(os.path.join(ROOT, "ncf_tpu_torch")):
        why = f"the ncf_tpu_torch package is not beside this script in {ROOT}"
    if why is not None:
        # on both streams, with what the environment says, so that a run
        # that stops here shows which check stopped it
        msg = (f"chip_smoke: {why} (torch {torch.__version__}, CUDA "
               f"{torch.version.cuda}, CUDA_VISIBLE_DEVICES="
               f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r})")
        print(msg, flush=True)
        print(msg, file=sys.stderr, flush=True)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    from ncf_tpu_torch.models import advanced_ncf
    from ncf_tpu_torch.ops import _kernels, topk
    from ncf_tpu_torch.serving import ModelServer
    from ncf_tpu_torch.utils.config import Config

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    check(card, f"nvidia-smi failed: {smi.stderr.strip()}")
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    secs = _kernels.build_all()
    log(f"build: nvcc {' '.join(_kernels.NVCC_FLAGS)} "
        f"{', '.join(s + '.cu' for s in _kernels.SOURCES)} in {secs:.1f} s")
    gate = [a for a in sys.argv[1:] if a.startswith("--gate")]
    if gate:
        if gate[0] != "--gate=bigvocab":
            gate_s, _ = phase_gate(torch, card, full_gate=True)
            log(f"phase gate {gate_s:.1f} s (every recipe at its N seeds)")
        gate_s, _ = phase_gate_bigvocab(torch, card)
        log(f"phase gate[bigvocab] {gate_s:.1f} s")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--gather-only" in sys.argv[1:]:
        # B7 alone: its registers and spills, its cases against the plain
        # version, NCF/NeuMF serving through it, its times
        from ncf_tpu_torch.ops import gather

        log("build: gather " + _ptxas_report(_kernels, "gather"))
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(4321)
        t0 = time.perf_counter()
        n7 = _gather_cases(torch, gather, gen, dev)
        log(f"kernel_vs_plain: gather_rows {n7} cases equal bit for bit "
            f"({time.perf_counter() - t0:.1f} s)")
        b7, ncf_summary = phase_serving_ncf(torch, ModelServer, Config)
        log(f"serving_ncf: B7 launches {b7}; " + json.dumps(ncf_summary))
        log("gather_timing_json: " + json.dumps(_time_gather(
            torch, gather, torch.Generator(device=dev).manual_seed(77),
            dev)))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--scatter-only" in sys.argv[1:] or "--scatter-ab" in sys.argv[1:]:
        # B2 alone: its cases against the plain version and its times at
        # the step's seven launches; with --scatter-ab PARENT, beside the
        # tree unpacked at PARENT, in turns
        from ncf_tpu_torch.ops import scatter

        log("build: scatter_add " + _ptxas_report(_kernels, "scatter_add"))
        dev = torch.device("cuda")
        t0 = time.perf_counter()
        n2 = _scatter_cases(torch, scatter,
                            torch.Generator(device=dev).manual_seed(99), dev)
        log(f"kernel_vs_plain: onehot_scatter_add {n2} cases equal bit for "
            f"bit ({time.perf_counter() - t0:.1f} s)")
        rows = _time_scatter(torch, _scatter_step_inputs(torch))
        _check_no_sort(rows)
        _log_scatter_rows(rows, "timing")
        log("scatter_timing_json: " + json.dumps(rows))
        if "--scatter-ab" in sys.argv[1:]:
            phase_scatter_ab(torch, os.path.abspath(
                sys.argv[sys.argv.index("--scatter-ab") + 1]))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--tower-only" in sys.argv[1:]:
        # B4f and B4b alone: registers and spills, tensor-core
        # instructions, the cases against the plain version, two runs in
        # equal bits, the times at the five tower shapes
        log("build: fused_tower " + _ptxas_report(_kernels, "fused_tower"))
        tower_sass, _ = phase_sass(_kernels)
        log("build: fused_tower SASS " + json.dumps(tower_sass))
        phase_tower_kernels_vs_plain(torch)
        phase_tower_repeats(torch)
        rows = _time_tower(torch)
        for r in rows:
            log(f"timing: {r['kernel']} {r['shape']} kernel {r['ms']!r} ms "
                f"(device {r['device_ms']!r} ms), bound {r['bound_ms']!r} ms"
                f" ({r['bound_by']})" + (
                    f", before the redesign {r['earlier_ms']!r} ms"
                    if "earlier_ms" in r else ""))
        log("tower_timing_json: " + json.dumps(rows))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--hstu-only" in sys.argv[1:]:
        # H1 alone: phase H, and the kernels line of its two rows
        log("build: hstu_attention " + _ptxas_report(_kernels,
                                                     "hstu_attention"))
        t0 = time.perf_counter()
        h_launches, h_rows, h_err, h_summary = phase_hstu(torch)
        log(f"phase hstu {time.perf_counter() - t0:.1f} s")
        log("hstu_json: " + json.dumps(h_summary))
        print(json.dumps({"kernels": [
            _kernel_entry(r["kernel"], h_launches[r["kernel"]], h_err, r)
            for r in h_rows]}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--tools-only" in sys.argv[1:]:
        # phase 22 alone, with its contract lines
        tools_launches, tools_summary = phase_tools(torch, card)
        log("tools_json: " + json.dumps(tools_summary))
        log("tools_launches_json: " + json.dumps(tools_launches))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if "--mesh-only" in sys.argv[1:]:
        # the parallel layer's phases alone (18-21), with their contract
        # lines; the default run drives every phase
        launches = run_mesh_phases(torch, card)
        log("mesh_launches_json: " + json.dumps(launches))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    tower_sass, segmax_sass = phase_sass(_kernels)
    log("build: fused_tower SASS " + json.dumps(tower_sass))
    log("build: topk_segmax SASS " + json.dumps(segmax_sass))

    t0 = time.perf_counter()
    max_err = {"topk_scores_streaming": phase_kernel_vs_plain(torch, topk)}
    max_err.update(phase_training_kernels_vs_plain(torch))
    max_err.update(phase_tower_kernels_vs_plain(torch))
    phase_tower_repeats(torch)
    max_err.update(phase_slice4_kernels_vs_plain(torch, topk))
    log(f"phase kernel_vs_plain {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    big = bigvocab(torch, Config, advanced_ncf)
    main_launches, latency = phase_serving(torch, topk, big, ModelServer)
    log(f"phase serving {time.perf_counter() - t0:.1f} s, kernel launches "
        f"on the main path {main_launches}")
    log("latency_json: " + json.dumps(latency))

    t0 = time.perf_counter()
    slice4_launches, int8_summary, served_err = phase_serving_int8(
        torch, topk, big, ModelServer)
    for name, e in served_err.items():
        max_err[name] = max(max_err[name], e)
    log(f"phase serving_int8 {time.perf_counter() - t0:.1f} s")
    log("serving_int8_json: " + json.dumps(int8_summary))

    t0 = time.perf_counter()
    api_launches, api_summary, api_err = phase_api(torch, topk, big,
                                                   ModelServer, card)
    for name, e in api_err.items():
        max_err[name] = max(max_err[name], e)
    log(f"phase api {time.perf_counter() - t0:.1f} s, kernel launches "
        f"{json.dumps(api_launches)}")
    log("api_json: " + json.dumps(api_summary))
    del big
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    b7_launches, ncf_summary = phase_serving_ncf(torch, ModelServer, Config)
    slice4_launches["gather_rows"] = b7_launches
    log(f"phase serving_ncf {time.perf_counter() - t0:.1f} s")
    log("serving_ncf_json: " + json.dumps(ncf_summary))

    t0 = time.perf_counter()
    rows = phase_timing(torch, topk)
    slice4_rows = phase_timing_slice4(torch, topk)
    log(f"phase timing {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase_demo(torch, Config, ModelServer)
    log(f"phase demo {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    launches, summary, trained_a = phase_training(torch)
    log(f"phase training {time.perf_counter() - t0:.1f} s")
    log("training_summary_json: " + json.dumps(summary))

    t0 = time.perf_counter()
    seq_launches, seq_summary, trained_b = phase_training_sequence(torch)
    log(f"phase training_sequence {time.perf_counter() - t0:.1f} s")
    log("training_sequence_json: " + json.dumps(seq_summary))
    for k, v in seq_launches.items():
        launches[k] += v

    t0 = time.perf_counter()
    log("determinism_json: " + json.dumps(phase_determinism(torch)))
    log(f"phase determinism {time.perf_counter() - t0:.1f} s")
    launches["topk_scores_streaming"] = main_launches
    for k, v in slice4_launches.items():
        launches[k] = launches.get(k, 0) + v

    for tower_mode in ("off", "on"):
        t0 = time.perf_counter()
        log("card_vs_cpu_json: " + json.dumps(
            phase_card_vs_cpu(torch, advanced_ncf, tower_mode)))
        log(f"phase card_vs_cpu[{tower_mode}] "
            f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    seq_serving = phase_serving_sequence(torch, advanced_ncf, ModelServer)
    launches["fused_tower_fwd"] += seq_serving["b4f_launches"]
    log(f"phase serving_sequence {time.perf_counter() - t0:.1f} s")
    log("serving_sequence_json: " + json.dumps(seq_serving))

    t0 = time.perf_counter()
    eval_launches, eval_summary = phase_eval(
        torch, advanced_ncf, card, {ML1M: trained_a, QUALITY: trained_b})
    del trained_a, trained_b
    launches["fused_tower_fwd"] += eval_launches
    log(f"phase eval {time.perf_counter() - t0:.1f} s")
    log("eval_json: " + json.dumps(eval_summary))

    t0 = time.perf_counter()
    train_rows, train_steps = phase_training_timing(torch)
    log(f"phase training_timing {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    trainer_launches, trainer_summary = phase_trainer(torch, card)
    for k, v in trainer_launches.items():
        launches[k] += v
    log(f"phase trainer {time.perf_counter() - t0:.1f} s")
    log("trainer_json: " + json.dumps(trainer_summary))

    gate_s, gate_run = phase_gate(torch, card, full_gate=False)
    log(f"phase gate {gate_s:.1f} s (indep40, seed 0, through the CLI)")

    t0 = time.perf_counter()
    ml_launches, ml_summary = phase_api_ml1m(torch, card, gate_run)
    log(f"phase api_ml1m {time.perf_counter() - t0:.1f} s, kernel launches "
        f"{json.dumps(ml_launches)}")
    log("api_ml1m_json: " + json.dumps(ml_summary))
    for k, v in list(api_launches.items()) + list(ml_launches.items()):
        launches[k] = launches.get(k, 0) + v

    t0 = time.perf_counter()
    big_launches, big_summary = phase_bigvocab_step(
        torch, card, next((r for r in train_rows
                           if r["kernel"] == "tree_sample_negatives"
                           and r["shape"] == "iid"), None))
    log(f"phase bigvocab_step {time.perf_counter() - t0:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB since the last "
        f"reset")
    log("bigvocab_step_json: " + json.dumps(big_summary))

    t0 = time.perf_counter()
    cli_launches, cli_summary = phase_bigvocab_trainer(torch, card)
    log(f"phase bigvocab_trainer {time.perf_counter() - t0:.1f} s")
    log("bigvocab_trainer_json: " + json.dumps(cli_summary))
    for k, v in list(big_launches.items()) + list(cli_launches.items()):
        launches[k] = launches.get(k, 0) + v
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    h_launches, h_rows, max_err["hstu_attn_fwd"], h_summary = phase_hstu(
        torch)
    max_err["hstu_attn_bwd"] = max_err["hstu_attn_fwd"]
    launches.update(h_launches)
    log(f"phase hstu {time.perf_counter() - t0:.1f} s")
    log("hstu_json: " + json.dumps(h_summary))

    t0 = time.perf_counter()
    tools_launches, tools_summary = phase_tools(
        torch, card, next((s for s in train_steps
                           if s["what"] == "A joint auto"), None))
    log(f"phase tools {time.perf_counter() - t0:.1f} s, kernel launches "
        f"{json.dumps(tools_launches)}")
    log("tools_json: " + json.dumps(tools_summary))
    for k, v in tools_launches.items():
        launches[k] = launches.get(k, 0) + v
    torch.cuda.empty_cache()
    for k, v in run_mesh_phases(torch, card).items():
        launches[k] = launches.get(k, 0) + v

    # one timed shape per kernel: the serving bucket for B5, the pooled
    # stratified draw for B1, the item table for B2, the step for B3, the
    # joint tower of config A for B4f and B4b
    main_rows = {"topk_scores_streaming": rows[0]}
    for r in slice4_rows:                 # the first row of each: B=64
        main_rows.setdefault(r["kernel"], r)
    for r in h_rows:                      # the HSTU cell's batch
        main_rows[r["kernel"]] = r
    for r in train_rows:
        if (r["kernel"], r["shape"]) in (
                ("tree_sample_negatives", "stratified"),
                ("onehot_scatter_add", "item"),
                ("fused_lookup_sum", "step"),
                ("fused_tower_fwd", "[16384, 96]"),
                ("fused_tower_bwd", "[16384, 96]")):
            main_rows[r["kernel"]] = r
    entries = []
    for name in KERNELS:
        check(launches[name] > 0, f"{name}: never launched on its path")
        entries.append(_kernel_entry(name, launches[name], max_err[name],
                                     main_rows[name]))
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        if "--rank" in sys.argv[1:]:            # a rank of a mesh phase
            sys.path.insert(0, ROOT)
            sys.exit(_rank_main(sys.argv[1:]))
        if "--scatter-time" in sys.argv[1:]:    # a run of --scatter-ab
            sys.exit(_scatter_time_main(sys.argv[1:]))
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
