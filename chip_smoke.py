#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``ncf_tpu_torch``) on one card.

    python3 chip_smoke.py          # from the repo root, on a machine with a GPU

Phases (each asserts; any failure exits non-zero and prints no result):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. ``nvcc`` build of every kernel source of the package (one ``nvcc`` per
   source, all started together), with its wall time;
3. every kernel against its plain PyTorch version on the card, on the same
   inputs: the streaming top-k (B5) at the serving shapes, with tied
   scores and empty slots, and B5's and B8's answers for a user alone
   equal bit for bit to the same user's inside batches of 17 and 64; the
   sampler (B1) and temporal sum (B3) at the training step's shapes and
   at edge shapes; the scatter-add (B2) bit for bit against its plain
   version run on the CPU and against a second call, in every mode and
   gradient dtype, at the step's shapes and at edge shapes (no ids, every
   id out of range, one id 81,920 times, a Zipf skew);
   the fused tower's forward (B4f) and backward (B4b) at the three tower
   shapes of the training steps, with dropout 0 and 0.2, and at edge
   shapes (identical dropout zeros); the int8 streaming top-k (B6) bit for
   bit at the serving catalog (4M items) and one that does not divide the
   block, D 64 and 61, B 1, 64 and 1024, seg_top 1 and 2, k 1, 10 and 64,
   with ties, padded-row floors and fill slots; the row gather (B7) bit
   for bit (f32 and bf16, duplicate ids); the exact (B8) and segmented
   (B9) top-k through ``compare_topk``;
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
   B8, B9 at 4M items, B7 at NeuMF's scan; B5 and B8 against their
   tensor-core route and against the f32 FMA rate of their old one; B6's
   device time per pass beside its ``__dp4a`` version's);
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
10. step time and examples/s (the median of five windows) and a profiler
   window over 20 steps (device time and operations per step, the host
   operations that take the most time) for config A under ``auto`` and
   ``off`` in both candidate modes and for config B; each training
   kernel's time (CUDA events, and device time from the profiler) beside
   its plain version, its library call (or, for B4, the plain layers of
   ``off``) and its bound (B2 with its sort's device time and, for the
   item table, its atomic version's time).

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
# B5's and B8's times as CUDA-core kernels, before the tensor-core tile
# replaced them (CUDA events, ms; NVIDIA H100 80GB HBM3, 700 W), printed
# beside this run's
CUDA_CORE_MS = {("topk_scores_streaming", 64, 4_000_000, "float32"): 2.470,
          ("topk_scores_streaming", 1, 4_000_000, "float32"): 0.730,
          ("topk_scores_streaming", 1024, 1_000_000, "bfloat16"): 9.451,
          ("topk_scores_pallas", 64, 4_000_000, "float32"): 9.002}
# B6 (__dp4a on the CUDA cores) and B2 (f32 atomics) before their
# redesigns: (CUDA-event ms, profiler device ms), NVIDIA H100 80GB HBM3,
# 700 W; printed beside this run's
EARLIER_MS = {("topk_scores_streaming_int8", 64): (2.365, 1.820),
              ("topk_scores_streaming_int8", 1): (0.778, 0.553),
              ("onehot_scatter_add", "item"): (0.0671, 0.0163)}
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
}
ML1M = os.path.join(ROOT, "configs", "advanced_ncf_ml1m.yaml")
QUALITY = os.path.join(ROOT, "configs", "advanced_ncf_quality.yaml")
SEQUENCE = os.path.join(ROOT, "configs", "advanced_ncf_sequence.yaml")
TRAIN_STEPS = 30          # per sampler x candidate mode, and per config B
CAUSAL_STEPS = 5
# the tower's input at the training steps: (rows, width) for config A
# joint, A independent and B independent
TOWER_SHAPES = ((16384, 96), (81920, 96), (81920, 160))
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


def device_profile(fn, iters):
    """Device kernels during ``iters`` calls of ``fn`` (torch.profiler):
    {kernel name: ms per call}, the device time and the number of device
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
        per, n_ops = {}, 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us()
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
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    return {"busy_share": busy / wall_us,
            "device_ms_per_call": busy / 1e3 / iters,
            "device_ops_per_call": n_ops / iters,
            "kernels_ms_per_call": {n[:60]: us / 1e3 / iters for n, us in top},
            "host_self_ms_per_call": {
                a.key[:60]: [a.self_cpu_time_total / 1e3 / iters,
                             a.count / iters] for a in host}}


def device_split(fn, iters=20, tries=3):
    """(device ms per call, {device op: ms per call}) of ``fn`` from the
    profiler (kernels and memsets, without the host's launch gaps), or
    (None, None) where not measured.  A short window's trace sometimes
    comes back without its device records, so it is taken again."""
    for _ in range(tries):
        prof = device_profile(fn, iters)
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

def _cdf(torch, n, gen):
    w = torch.rand(n, generator=gen, device="cuda") + 1e-3
    c = torch.cumsum(w, 0)
    return c / c[-1]


def _scatter_cases(torch, scatter, gen, dev):
    """B2 in every mode and gradient dtype at the step's shapes (user and
    item tables, the vocabulary-level department and category tables, the
    temporal tables) and at edge shapes (no ids, every id out of range,
    one id 81,920 times, a Zipf skew over the item table): equal bit for
    bit to the plain version run on the CPU, and to a second call."""
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
    n = 0
    for rows, ids, d in cases:
        g32 = torch.randn(tuple(ids.shape) + (d,), generator=gen, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
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
    n = 0
    for I in (100, 3706, 100_003):               # shared and global CDF
        cdf = _cdf(torch, I, gen)
        for R, B, NEG, no_pos in ((2, 16384, 4, False), (1, 65536, 1, True),
                                  (1, 16384, 4, False), (3, 999, 2, False)):
            u = torch.rand((R, B * NEG), generator=gen, device=dev)
            if no_pos:                           # the stratified pooled draw
                u = torch.sort(u, dim=1).values
            pos = (torch.full((B,), -1, dtype=torch.int32, device=dev)
                   if no_pos else torch.randint(0, I, (B,), generator=gen,
                                                device=dev, dtype=torch.int32))
            got = sampler.tree_sample_negatives(u, pos, cdf, I)
            torch.cuda.synchronize()
            want = sampler.tree_sample_ref(
                u, pos[:, None].expand(B, NEG).reshape(-1), cdf, I)
            check(torch.equal(got.reshape(-1), want),
                  f"B1 I={I} R={R} B={B}: kernel != plain version")
            n += 1
    t0 = time.perf_counter()
    n2 = _scatter_cases(torch, scatter, gen, dev)
    n += n2
    log(f"kernel_vs_plain: onehot_scatter_add {n2} cases equal bit for bit "
        f"to the plain version on the CPU and from call to call "
        f"({time.perf_counter() - t0:.1f} s)")
    tables = [torch.randn((r, 32), generator=gen, device=dev)
              for r in (24, 7, 12)] + [sinusoidal_table(32, device=dev)]
    for B, bad in ((16384, False), (16384, True), (5, True)):
        ids = torch.stack([torch.randint(0, t.shape[0], (B,), generator=gen,
                                         device=dev) for t in tables])
        if bad:                                  # contributes 0
            ids[:, 0] = -1
            ids[:, 1] = 400
        got = temporal_sum.fused_lookup_sum(ids, tables)
        torch.cuda.synchronize()
        check(torch.equal(got, temporal_sum.lookup_sum_ref(ids, tables)),
              f"B3 B={B}: kernel != plain version")
        n += 1
    log(f"kernel_vs_plain: training kernels {n} cases ok, max_abs_err "
        f"{json.dumps(errs)}")
    return errs


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


def _tower_compare(torch, tower, layers, x, rate, what):
    """B4f and B4b against ``fused_tower_ref`` on the same inputs and the
    same generator state.  Tolerances: identical dropout zeros; outputs
    within 1e-4 (relative, plus 1e-4) for at least 95% of the elements
    and within 5e-2 of the largest magnitude for all (f32 sums in another
    order; where two straddle a bf16 rounding boundary between layers,
    the rest of that row moves by up to ~1e-2, in a few percent of the
    rows at width 512).  The backwards are held on the rows whose outputs
    agree to 1e-5 (at least 90%; dy is zero elsewhere):
    each parameter gradient within 1e-4 of its largest magnitude, dx
    within one bf16 ulp plus 1e-4 of its largest magnitude.  Returns
    (max |out diff|, max |grad diff| over dx and the leaves)."""
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
    dy = torch.randn(ko.shape, device=x.device, generator=torch.Generator(
        device=x.device).manual_seed(5))
    dy = dy * same.reshape(ko.shape[:-1] + (1,))
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
    cases = [((rows, d0), TOWER_HIDDEN) for rows, d0 in TOWER_SHAPES]
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
    launches; returns the per-step losses on the host."""
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
    return losses, float(m["accuracy"])


def _loss_fell(losses, what):
    first, last = float(losses[:5].mean()), float(losses[-5:].mean())
    check(last < first, f"training[{what}]: loss did not fall ({first!r} "
          f"-> {last!r})")
    return first, last


def phase_training(torch):
    """Config A as shipped: every sampler x candidate mode, 30 steps each,
    B4f and B4b once a step under ``fused_tower: auto``.  Returns
    (launches per kernel over the phase, summary)."""
    from ncf_tpu_torch.models import get_model, layers
    from ncf_tpu_torch.ops import embedding, tower

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
            losses, acc = _train_steps(torch, model, cfg, consts, batches,
                                       TRAIN_STEPS, PER_STEP, what)
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
    return launches, summary


def phase_training_sequence(torch):
    """Config B: the quality config (sequence, independent) and its joint
    twin, 30 steps each with the train split's per-user history, then a
    few steps with causal per-example histories in the batch.  Returns
    (launches per kernel over the phase, summary)."""
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
        losses, acc = _train_steps(torch, model, cfg, consts, batches,
                                   TRAIN_STEPS, PER_STEP_SEQ, what, hist)
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
    losses, acc = _train_steps(torch, model, cfg, consts, batches,
                               CAUSAL_STEPS, PER_STEP_SEQ, "causal")
    summary["causal"] = {"losses": losses.tolist(), "acc": acc}
    log(f"training[causal]: {CAUSAL_STEPS} steps with [N, "
        f"{cfg.model.history_len}] per-example histories, losses "
        f"{losses.tolist()} ({time.perf_counter() - t0:.1f} s)")
    del ctx, it, batches
    launches = {k: c.value for k, c in counters.items()}
    log(f"training_sequence: launches {json.dumps(launches)}")
    return launches, summary


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


def _time_training_kernels(torch, batch, negs, params, cfg, consts):
    """Each training kernel at the step's shapes: kernel, plain version,
    library call and bound.  Returns rows keyed by kernel and shape."""
    import torch.nn.functional as F

    from ncf_tpu_torch.models.temporal import sinusoidal_table
    from ncf_tpu_torch.ops import embedding, sampler, scatter, temporal_sum
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

    pos = torch.as_tensor(batch["item_ids"], device=dev)
    for what, u, p in (
            ("stratified", stratified_uniforms(gen, B * NEG, dev)[None],
             torch.full((B * NEG,), -1, dtype=torch.int32, device=dev)),
            ("iid", torch.rand((2, B * NEG), generator=gen, device=dev),
             pos)):
        NN = u.shape[1] // p.shape[0]
        pos_bn = p[:, None].expand(-1, NN).reshape(-1)
        nbytes = u.numel() * 4 + p.numel() * 4 + I * 4 + u.shape[1] * 4
        ops = u.numel() * (I.bit_length() + 1)      # binary-search probes
        bound, by = _bound(nbytes, ops, f32)
        call = functools.partial(sampler.tree_sample_negatives, u, p, cdf, I)
        lib = functools.partial(lib_b1, u, pos_bn)
        rows.append({"kernel": "tree_sample_negatives", "shape": what,
                     "ms": cuda_ms(call, 50), **_device_fields(call, lib),
                     "plain_ms": cuda_ms(lambda: sampler.tree_sample_ref(
                         u, pos_bn, cdf, I), 5, warmup=1),
                     "library_ms": cuda_ms(lib, 50),
                     "bound_ms": bound, "bound_by": by})

    # B2 at each of the step's seven launches (``fast``: bf16 rounding
    # where the reference runs its kernel, split for the temporal tables),
    # with the device time of its sort (``scatter._runs``) on its own
    users = torch.as_tensor(batch["user_ids"], device=dev)
    items = torch.cat([pos[:, None], torch.as_tensor(negs, device=dev)], 1)
    dept = torch.as_tensor(consts[1], device=dev)
    cat = torch.as_tensor(consts[2], device=dev)
    hour = torch.as_tensor(batch["hour"], device=dev)
    cases = [("user", users, cfg.model.num_users, 128, torch.bfloat16),
             ("item", items, I, 128, torch.bfloat16),
             ("dept", dept, cfg.model.num_departments, 64, torch.float32),
             ("cat", cat, cfg.model.num_categories, 64, torch.float32),
             ("hour", hour, 24, 32, torch.float32),
             ("day", torch.as_tensor(batch["day"], device=dev), 7, 32,
              torch.float32)]
    for what, ids, nrows, d, dtype in cases:
        g = torch.randn(tuple(ids.shape) + (d,), generator=gen,
                        device=dev).to(dtype)
        mode = (embedding.backward_mode(nrows, d, ids.numel())
                if what not in ("hour", "day") else "split")
        flat_ids, flat_g = scatter._flat(ids, g)
        rounded = scatter.round_mode(flat_g, mode)
        lids = flat_ids.long()
        n = ids.numel()
        nbytes = n * 4 + g.numel() * g.element_size() + nrows * d * 4
        bound, by = _bound(nbytes, n * d * {"f32": 1, "bf16": 2,
                                            "split": 5}[mode], f32)
        call = functools.partial(scatter.onehot_scatter_add, ids, g, nrows,
                                 mode=mode)

        def lib(nrows=nrows, d=d, lids=lids, rounded=rounded):
            return torch.zeros((nrows, d), device=dev).index_add_(
                0, lids, rounded)

        runs = functools.partial(scatter._runs, ids)
        rows.append({"kernel": "onehot_scatter_add", "shape": what,
                     "mode": mode, "ids": list(ids.shape),
                     "ms": cuda_ms(call, 50), **_device_fields(call, lib),
                     "sort_device_ms": device_split(runs)[0],
                     "atomic_ms": EARLIER_MS.get(("onehot_scatter_add",
                                                  what)),
                     "plain_ms": cuda_ms(lambda: scatter.scatter_add_ref(
                         ids, g, nrows, mode), 3, warmup=1),
                     "library_ms": cuda_ms(lib, 50),
                     "bound_ms": bound, "bound_by": by})

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
                 "plain_ms": cuda_ms(lambda: temporal_sum.lookup_sum_ref(
                     ids, tables), 50),
                 "library_ms": cuda_ms(lib, 50),
                 "bound_ms": bound, "bound_by": by})
    return rows


def _time_tower(torch):
    """B4f and B4b at the three tower shapes of the training steps (dropout
    0.2): the kernel call (CUDA events and profiler device time), its plain
    version, the plain layers that ``off`` runs instead (eager
    ``mlp_tower``, forward and forward + backward through autograd) and
    the bound.  No single PyTorch call computes the fused tower, so there
    is no library time."""
    from ncf_tpu_torch.models.layers import mlp_tower
    from ncf_tpu_torch.ops import tower

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(41)
    rate = 0.2
    rows_out = []
    for rows, d0 in TOWER_SHAPES:
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
        b_b, by_b = _bound(rows * d0 * 4 + rows * dims[-1] * 4
                           + n_params * 8, 4 * macs, PEAK_FLOP_S["float32"])
        off_f, off_fb = cuda_ms(off_fwd, 20), cuda_ms(off_both, 10)
        rows_out.append({
            "kernel": "fused_tower_fwd", "shape": shape, "ms": cuda_ms(fwd, 20),
            **_device_fields(fwd),
            "plain_ms": cuda_ms(lambda: tower._fwd_ref(x2, seed, flat, rate),
                                3, warmup=1),
            "library_ms": None, "off_path_ms": off_f,
            "bound_ms": b_f, "bound_by": by_f})
        rows_out.append({
            "kernel": "fused_tower_bwd", "shape": shape, "ms": cuda_ms(bwd, 10),
            **_device_fields(bwd),
            "plain_ms": cuda_ms(lambda: tower._bwd_ref(x2, dy, seed, flat,
                                                       rate), 3, warmup=1),
            "library_ms": None, "off_path_ms": off_fb,
            "fused_fwd_bwd_ms": cuda_ms(fused_both, 10),
            "bound_ms": b_b, "bound_by": by_b})
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
    rows += _time_tower(torch)
    for r in rows:
        log(f"timing: {r['kernel']} [{r['shape']}] kernel {r['ms']!r} ms "
            f"(device {r['device_ms']!r} ms), plain {r['plain_ms']!r} ms, "
            f"library {r['library_ms']!r} ms (device "
            f"{r.get('library_device_ms')!r} ms), off path "
            f"{r.get('off_path_ms')!r} ms, bound {r['bound_ms']!r} ms "
            f"({r['bound_by']})" + (
                f"; sort {r['sort_device_ms']!r} ms of device time, "
                f"atomic version {r['atomic_ms']!r} ms"
                if "sort_device_ms" in r else ""))
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

    n7 = 0
    for rows, d, dtype in ((3706, 64, torch.float32), (6040, 64, torch.float32),
                           (3706, 64, torch.bfloat16),
                           (1682, 32, torch.bfloat16),
                           (1000, 34, torch.bfloat16), (500, 3, torch.float32)):
        table = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
        ids = torch.randint(0, rows, (64, 3706), generator=gen, device=dev)
        for i in (ids, ids.to(torch.int32), ids[:, :1]):
            got = gather.gather_rows(table, i)
            torch.cuda.synchronize()
            check(torch.equal(got, gather.gather_rows_ref(table, i)),
                  f"B7 [{rows}, {d}] {dtype} ids {tuple(i.shape)} "
                  f"{i.dtype}: kernel != plain version")
            n7 += 1
    log(f"kernel_vs_plain: gather_rows {n7} cases equal bit for bit")

    t0 = time.perf_counter()
    n8 = n9 = swaps = 0
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
        del t32, b
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
    bound, by = _bound(nbytes + 64 * (I // 128) * 4, 2.0 * 64 * I * D, f32)
    call = functools.partial(topk._segmax_cuda, q, items, bias, 2048, 128)
    rows.append({"kernel": "topk_scores_segmented",
                 "shape": f"B=64 I={I} D={D} f32 seg 128",
                 "ms": cuda_ms(call, 10), **_device_fields(call),
                 "plain_ms": cuda_ms(lambda: topk.segmax_keys_ref(
                     q, items, bias, 2048, 128), 3, warmup=1),
                 "library_ms": None,
                 "with_topk_and_rescore_ms": cuda_ms(
                     lambda: topk.topk_scores_segmented(q, items, k, bias), 10),
                 "bound_ms": bound, "bound_by": by})
    del items, bias, qs, q
    torch.cuda.empty_cache()
    table = torch.randn((3706, 64), generator=gen, device=dev)
    ids = torch.randint(0, 3706, (64, 3706), generator=gen, device=dev,
                        dtype=torch.int32)
    n = ids.numel()
    bound, by = _bound(n * 4 + n * 64 * 4 + table.numel() * 4, 0, f32)
    call = functools.partial(gather.gather_rows, table, ids)
    flat = ids.reshape(-1)
    lib = functools.partial(torch.index_select, table, 0, flat)
    rows.append({"kernel": "gather_rows", "shape": f"[3706, 64] f32 x {n} ids",
                 "ms": cuda_ms(call, 50), **_device_fields(call, lib),
                 "plain_ms": cuda_ms(lambda: gather.gather_rows_ref(table, ids),
                                     50),
                 "library_ms": cuda_ms(lib, 50),
                 "bound_ms": bound, "bound_by": by})
    for r in rows:
        was = (f" (CUDA-core version: {r['cuda_core_ms']!r} ms; device "
               f"by pass "
               f"{json.dumps(r['device_passes_ms'])}, f32 FMA bound "
               f"{r['bound_f32_fma_ms']!r} ms)" if "cuda_core_ms" in r
               else f" (__dp4a version: {r['dp4a_ms']!r} ms [device]; "
               f"device by pass {json.dumps(r['device_passes_ms'])})"
               if "dp4a_ms" in r else "")
        log(f"timing: {r['kernel']} [{r['shape']}] kernel {r['ms']!r} ms "
            f"(device {r['device_ms']!r} ms){was}, plain {r['plain_ms']!r} "
            f"ms, library {r['library_ms']!r} ms (device "
            f"{r.get('library_device_ms')!r} ms), bound {r['bound_ms']!r} ms "
            f"({r['bound_by']})")
    log("slice4_timing_json: " + json.dumps(rows))
    return rows


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

    t0 = time.perf_counter()
    max_err = {"topk_scores_streaming": phase_kernel_vs_plain(torch, topk)}
    max_err.update(phase_training_kernels_vs_plain(torch))
    max_err.update(phase_tower_kernels_vs_plain(torch))
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
    del big
    torch.cuda.empty_cache()
    log(f"phase serving_int8 {time.perf_counter() - t0:.1f} s")
    log("serving_int8_json: " + json.dumps(int8_summary))

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
    launches, summary = phase_training(torch)
    log(f"phase training {time.perf_counter() - t0:.1f} s")
    log("training_summary_json: " + json.dumps(summary))

    t0 = time.perf_counter()
    seq_launches, seq_summary = phase_training_sequence(torch)
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
    train_rows, _ = phase_training_timing(torch)
    log(f"phase training_timing {time.perf_counter() - t0:.1f} s")

    # one timed shape per kernel: the serving bucket for B5, the pooled
    # stratified draw for B1, the item table for B2, the step for B3, the
    # joint tower of config A for B4f and B4b
    main_rows = {"topk_scores_streaming": rows[0]}
    for r in slice4_rows:                 # the first row of each: B=64
        main_rows.setdefault(r["kernel"], r)
    for r in train_rows:
        if (r["kernel"], r["shape"]) in (
                ("tree_sample_negatives", "stratified"),
                ("onehot_scatter_add", "item"),
                ("fused_lookup_sum", "step"),
                ("fused_tower_fwd", "[16384, 96]"),
                ("fused_tower_bwd", "[16384, 96]")):
            main_rows[r["kernel"]] = r
    entries = []
    for name, (source, replaces) in KERNELS.items():
        r = main_rows[name]
        check(launches[name] > 0, f"{name}: never launched on its path")
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
