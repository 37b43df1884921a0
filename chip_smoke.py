#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``ncf_tpu_torch``) on one card.

    python3 chip_smoke.py          # from the repo root, on a machine with a GPU

Phases (each asserts; any failure exits non-zero and prints no result):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. ``nvcc`` build of every kernel source of the package (one ``nvcc`` per
   source, all started together), with its wall time;
3. every kernel against its plain PyTorch version on the card, on the same
   inputs: the streaming top-k (B5) at the serving shapes, with tied
   scores and empty slots; the sampler (B1), scatter-add (B2) and
   temporal sum (B3) at the training step's shapes and at edge shapes;
4. serving at full width: ``configs/advanced_ncf_bigvocab.yaml`` (12M users
   x 4M items, random weights from a seeded generator) through
   ``ModelServer`` with ``retrieval="exact"`` and ``"fast"``: direct,
   temporal, exclusion, hourly, batched and 64 concurrent coalesced
   requests, held against the exact top-k computed on the card;
5. kernel, plain-version and library-call times (CUDA events) at the
   serving shapes, beside the least time the card could take;
6. the demo checkpoint served on the card against the port's CPU answers;
7. training at full width: ``configs/advanced_ncf_ml1m.yaml`` (6040 users
   x 3706 items, batch 16384, bf16 compute, dropout 0.2) on batches of
   ``BatchIterator`` over ``generate_interactions`` at that size, ~30
   ``make_train_step`` steps for each sampler x candidate mode; every step
   must launch B1 once, B2 seven times and B3 once, and the loss must fall;
8. three full-width steps in f32 with dropout 0 on the card and through
   the port on the CPU, from the same params and negatives;
9. step time and examples/s (the median of five windows), a profiler
   window over 20 steps (device time and operations per step, the host
   operations that take the most time), and each training kernel's time
   (CUDA events, and device time from the profiler) beside its plain
   version, its library call and its bound.

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
               "bfloat16": 989e12}      # dense bf16 tensor cores
# kernel -> (its source, the TPU kernel it replaces)
KERNELS = {
    "topk_scores_streaming": ("ncf_tpu_torch/ops/csrc/topk_streaming.cu",
                              "ncf_tpu/ops/topk.py:447"),
    "tree_sample_negatives": ("ncf_tpu_torch/ops/csrc/tree_sampler.cu",
                              "ncf_tpu/ops/pallas_sampler.py:164"),
    "onehot_scatter_add": ("ncf_tpu_torch/ops/csrc/scatter_add.cu",
                           "ncf_tpu/ops/pallas_scatter.py:185"),
    "fused_lookup_sum": ("ncf_tpu_torch/ops/csrc/temporal_sum.cu",
                         "ncf_tpu/ops/pallas_temporal.py:94"),
}
ML1M = os.path.join(ROOT, "configs", "advanced_ncf_ml1m.yaml")
TRAIN_STEPS = 30          # per sampler x candidate mode


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


def exact_scores(q, table, bias, ids):
    """f64 scores and the magnitude sum sum_d |q_d v_d| of ``ids`` [B, k]
    (q is cast to the table's type first, as the kernel does)."""
    import torch

    qd = q.to(table.dtype).double()
    rows = table[ids.long()].double()                       # [B, k, D]
    prod = qd[:, None, :] * rows
    s = prod.sum(-1)
    if bias is not None:
        s = s + bias.double()[ids.long()]
    return s, prod.abs().sum(-1)


def compare_topk(kv, ki, rv, ri, q, table, bias, what):
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
    sk, mk = exact_scores(q, table, bias, ki)
    sr, mr = exact_scores(q, table, bias, ri)
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
    return worst


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


def phase_serving(torch, topk, Config, ModelServer, advanced_ncf):
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
    del params
    torch.cuda.empty_cache()
    return main_launches, latency


def _time_shape(torch, topk, B, I, dtype, iters):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(B + I)
    table = torch.randn((I, 64), generator=gen, device=dev).to(dtype)
    bias = torch.randn((I,), generator=gen, device=dev)
    q = torch.randn((B, 64), generator=gen, device=dev).to(dtype)
    prep = topk.prepare_items(table, bias, seg_width=128)
    k = 10
    kernel = cuda_ms(lambda: topk.topk_scores_streaming(q, prep, k=k), iters)
    plain = cuda_ms(lambda: topk.topk_scores_streaming_ref(q, prep, k=k), 3,
                    warmup=1)
    library = cuda_ms(lambda: torch.topk(q @ table.T + bias, k), 5)
    prof = device_profile(lambda: topk.topk_scores_streaming(q, prep, k=k), 10)
    if prof is not None:
        log("profile_json: " + json.dumps(
            {"what": f"kernel B={B} I={I} {dtype}", **prof}))
    nbytes = (q.numel() * q.element_size() + table.numel()
              * table.element_size() + bias.numel() * 4 + B * k * 8)
    flops = 2.0 * B * I * 64
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOP_S[str(dtype).replace("torch.", "")] * 1e3
    row = {"B": B, "I": I, "D": 64, "dtype": str(dtype).replace("torch.", ""),
           "k": k, "seg": "128/2", "ms": kernel, "plain_ms": plain,
           "library_ms": library, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    del table, bias, q, prep
    torch.cuda.empty_cache()
    return row


def phase_timing(torch, topk):
    rows = [_time_shape(torch, topk, 64, 4_000_000, torch.float32, 20),
            _time_shape(torch, topk, 1, 4_000_000, torch.float32, 20),
            _time_shape(torch, topk, 1024, 1_000_000, torch.bfloat16, 10)]
    for r in rows:
        log(f"timing: B={r['B']} I={r['I']} {r['dtype']} kernel "
            f"{r['ms']!r} ms, plain {r['plain_ms']!r} ms, library "
            f"{r['library_ms']!r} ms, bound {r['bound_ms']!r} ms "
            f"({r['bound_by']})")
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


def phase_training_kernels_vs_plain(torch):
    """B1, B2 and B3 against their plain versions at the step's shapes and
    at edge shapes.  B1 and B3 must be equal; B2 within 1e-6 of the
    per-element magnitude sum (f32 atomics add in a varying order).
    Returns {kernel: max |kernel - plain|}."""
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
    for rows, shape, d, dtype in ((6040, (16384,), 128, torch.bfloat16),
                                  (3706, (16384, 5), 128, torch.bfloat16),
                                  (9, (3706,), 64, torch.float32),
                                  (30, (3706,), 64, torch.float32),
                                  (24, (16384,), 32, torch.float32),
                                  (3706, (16384, 5), 128, torch.float32),
                                  (77, (1001, 3), 40, torch.bfloat16)):
        ids = torch.randint(-3, rows + 3, shape, generator=gen, device=dev,
                            dtype=torch.int32)       # out-of-range ids too
        g = torch.randn(shape + (d,), generator=gen, device=dev).to(dtype)
        flat_ids, flat_g = scatter._flat(ids, g)
        keep = (flat_ids >= 0) & (flat_ids < rows)
        mag = torch.zeros((rows, d), device=dev).index_add_(
            0, flat_ids[keep].long(), flat_g[keep].float().abs())
        for mode in scatter.MODES:
            got = scatter.onehot_scatter_add(ids, g, rows, mode=mode)
            torch.cuda.synchronize()
            want = scatter.scatter_add_ref(ids, g, rows, mode)
            err = (got - want).abs()
            check(bool((err <= 1e-6 * mag + 1e-30).all()),
                  f"B2 rows={rows} {tuple(shape)} {dtype} {mode}: "
                  f"kernel differs beyond 1e-6 * sum|g|")
            errs["onehot_scatter_add"] = max(errs["onehot_scatter_add"],
                                             float(err.max()))
            n += 1
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


# -------------------------------------------------------------- training

def _training_setup(torch, cfg_overrides=None):
    """The ML-1M config at full width, its synthetic log and the step's
    device constants."""
    import numpy as np

    from ncf_tpu_torch.data import (BatchIterator, generate_interactions,
                                    make_sampling_cdf)
    from ncf_tpu_torch.utils.config import Config

    cfg = Config.from_yaml(ML1M)
    d = cfg.data
    inter = generate_interactions(
        num_users=d.synthetic_users, num_items=d.synthetic_items,
        num_days=d.synthetic_days,
        avg_txns_per_user=d.synthetic_avg_txns_per_user,
        seed=d.synthetic_seed)
    cfg.model.num_users, cfg.model.num_items = inter.num_users, inter.num_items
    cfg.model.num_departments = inter.num_departments
    cfg.model.num_categories = inter.num_categories
    cfg.model.fused_tower = "off"
    cfg.train.negative_sampling = "stratified"
    train_inter, _ = inter.time_split(d.validation_days)
    it = BatchIterator(train_inter, cfg.train.batch_size, seed=cfg.train.seed)
    neg_cdf = make_sampling_cdf(train_inter.inverse_popularity_weights(),
                                device="cuda")
    consts = (neg_cdf, np.asarray(inter.item_dept), np.asarray(inter.item_cat))
    return cfg, it, consts, len(inter)


def _launch_counters():
    from ncf_tpu_torch.ops import sampler, scatter, temporal_sum

    return {"tree_sample_negatives": sampler.tree_sample_negatives.launches,
            "onehot_scatter_add": scatter.onehot_scatter_add.launches,
            "fused_lookup_sum": temporal_sum.fused_lookup_sum.launches}


PER_STEP = {"tree_sample_negatives": 1, "onehot_scatter_add": 7,
            "fused_lookup_sum": 1}


def phase_training(torch, advanced_ncf):
    """The main training path: every sampler x candidate mode, ~30 steps
    each.  Returns (launches per kernel over the phase, summary)."""
    from ncf_tpu_torch.models import get_model, layers
    from ncf_tpu_torch.ops import embedding
    from ncf_tpu_torch.train import make_optimizer, make_train_step

    t0 = time.perf_counter()
    cfg, it, consts, n_inter = _training_setup(torch)
    log(f"training: {cfg.model.num_users}x{cfg.model.num_items}, "
        f"{n_inter} interactions, {len(it)} batches of "
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
            gen = torch.Generator(device="cuda").manual_seed(0)
            params = advanced_ncf.init(gen, cfg.model)
            opt = make_optimizer(cfg.train, steps_per_epoch=len(batches))
            state = opt.init(params)
            step = make_train_step(model, cfg, opt, *consts)
            losses = []
            for i in range(TRAIN_STEPS):
                before = {k: c.value for k, c in counters.items()}
                params, state, gen, m = step(params, state, gen,
                                             batches[i % len(batches)])
                for k, c in counters.items():
                    check(c.value - before[k] == PER_STEP[k],
                          f"training[{sampling}/{mode}] step {i}: {k} "
                          f"launched {c.value - before[k]} times, "
                          f"want {PER_STEP[k]}")
                losses.append(m["loss"])
            losses = torch.stack(losses).float().cpu()
            check(bool(torch.isfinite(losses).all()),
                  f"training[{sampling}/{mode}]: non-finite loss")
            first, last = float(losses[:5].mean()), float(losses[-5:].mean())
            check(last < first, f"training[{sampling}/{mode}]: loss did not "
                  f"fall ({first!r} -> {last!r})")
            summary[f"{sampling}/{mode}"] = {"first5": first, "last5": last,
                                             "acc": float(m["accuracy"])}
            log(f"training[{sampling}/{mode}]: {TRAIN_STEPS} steps, loss "
                f"{first!r} -> {last!r}, accuracy {float(m['accuracy'])!r}")
            del params, state
    launches = {k: c.value for k, c in counters.items()}
    gen = torch.Generator(device="cuda").manual_seed(1)
    keep = layers.dropout_mask(gen, (16384, 256), cfg.model.dropout)
    zeroed = 1.0 - float(keep.float().mean())
    check(abs(zeroed - cfg.model.dropout) <= 0.01,
          f"dropout zeroes {zeroed!r}, want {cfg.model.dropout} +- 0.01")
    summary["dropout_zero_share"] = zeroed
    log(f"training: launches {json.dumps(launches)}; dropout zeroes "
        f"{zeroed!r} of a [16384, 256] mask")
    return launches, summary


def _tree_check(torch, a_tree, b_tree, lr, steps):
    """Card params against CPU params: at least 99.99% of all elements
    within 1e-4 of their leaf's largest magnitude, and every element
    within 3 * steps * lr.  Adam's first step moves every element with a
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
    check(outside <= total // 10_000,
          f"card vs CPU: {outside} of {total} elements differ ({where})")
    return worst, outside, total, where


def phase_card_vs_cpu(torch, advanced_ncf):
    """Three full-width steps in f32 with dropout 0, from the same params
    and negatives, on the card and through the port on the CPU."""
    from ncf_tpu_torch.convert import tree_map
    from ncf_tpu_torch.data import sample_negatives_stratified
    from ncf_tpu_torch.models import get_model
    from ncf_tpu_torch.ops import embedding
    from ncf_tpu_torch.train import make_optimizer, make_train_step

    cfg, it, consts, _ = _training_setup(torch)
    cfg.model.compute_dtype = "float32"
    cfg.model.dropout = 0.0
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
        losses[where] = []
        for b, n in zip(batches, negs):
            p, state, g, m = step(p, state, g, b, n)
            losses[where].append(float(m["loss"]))
        out[where] = (p, state)
        log(f"card_vs_cpu: 3 steps on {dev} in "
            f"{time.perf_counter() - t0:.1f} s, losses {losses[where]}")
    for a, b in zip(losses["card"], losses["cpu"]):
        check(abs(a - b) <= 1e-4 * abs(b), f"card vs CPU loss {a} vs {b}")
    worst, outside, total, where = _tree_check(
        torch, out["card"][0], out["cpu"][0], cfg.train.learning_rate, 3)
    check(int(out["card"][1]["count"]) == 3, "card: Adam count != 3")
    log(f"card_vs_cpu: params agree (max |diff| {worst!r}, {outside} of "
        f"{total} elements beyond 1e-4 of their leaf's scale, in leaves "
        f"{where})")
    del out, params, host
    torch.cuda.empty_cache()
    return {"max_abs_param_diff": worst, "elements_outside": outside,
            "elements": total, "leaves_outside": where, "losses": losses}


def _bound(nbytes, ops, peak_ops):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _device_fields(call):
    ms, ops = device_split(call)
    return {"device_ms": ms, "device_ops": ops}


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
        rows.append({"kernel": "tree_sample_negatives", "shape": what,
                     "ms": cuda_ms(call, 50), **_device_fields(call),
                     "plain_ms": cuda_ms(lambda: sampler.tree_sample_ref(
                         u, pos_bn, cdf, I), 5, warmup=1),
                     "library_ms": cuda_ms(lambda: lib_b1(u, pos_bn), 50),
                     "bound_ms": bound, "bound_by": by})

    # B2 at each of the step's seven launches (``fast``: bf16 rounding
    # where the reference runs its kernel, split for the temporal tables)
    users = torch.as_tensor(batch["user_ids"], device=dev)
    items = torch.cat([pos[:, None], torch.as_tensor(negs, device=dev)], 1)
    dept = torch.as_tensor(consts[1], device=dev)
    cat = torch.as_tensor(consts[2], device=dev)
    hour = torch.as_tensor(batch["hour"], device=dev)
    cases = [("user", users, cfg.model.num_users, 128, torch.bfloat16),
             ("item", items, I, 128, torch.bfloat16),
             ("dept", dept, cfg.model.num_departments, 64, torch.float32),
             ("cat", cat, cfg.model.num_categories, 64, torch.float32),
             ("hour", hour, 24, 32, torch.float32)]
    for what, ids, nrows, d, dtype in cases:
        g = torch.randn(tuple(ids.shape) + (d,), generator=gen,
                        device=dev).to(dtype)
        mode = (embedding.backward_mode(nrows, d, ids.numel())
                if what != "hour" else "split")
        flat_ids, flat_g = scatter._flat(ids, g)
        rounded = scatter.round_mode(flat_g, mode)
        lids = flat_ids.long()
        n = ids.numel()
        nbytes = n * 4 + g.numel() * g.element_size() + nrows * d * 4
        bound, by = _bound(nbytes, n * d * {"f32": 1, "bf16": 2,
                                            "split": 5}[mode], f32)
        call = functools.partial(scatter.onehot_scatter_add, ids, g, nrows,
                                 mode=mode)
        rows.append({"kernel": "onehot_scatter_add", "shape": what,
                     "mode": mode, "ids": list(ids.shape),
                     "ms": cuda_ms(call, 50), **_device_fields(call),
                     "plain_ms": cuda_ms(lambda: scatter.scatter_add_ref(
                         ids, g, nrows, mode), 20),
                     "library_ms": cuda_ms(lambda: torch.zeros(
                         (nrows, d), device=dev).index_add_(0, lids, rounded),
                         50),
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
    rows.append({"kernel": "fused_lookup_sum", "shape": "step",
                 "ms": cuda_ms(call, 50), **_device_fields(call),
                 "plain_ms": cuda_ms(lambda: temporal_sum.lookup_sum_ref(
                     ids, tables), 50),
                 "library_ms": cuda_ms(lambda: F.embedding_bag(
                     bag_ids, bag, mode="sum"), 50),
                 "bound_ms": bound, "bound_by": by})
    return rows


def phase_training_timing(torch, advanced_ncf):
    """Step time and examples/s on the main config (stratified, joint,
    bf16, dropout 0.2), a profiler window of 20 steps, and the training
    kernels' times."""
    from ncf_tpu_torch.data import sample_negatives_stratified
    from ncf_tpu_torch.models import get_model
    from ncf_tpu_torch.ops import embedding
    from ncf_tpu_torch.train import make_optimizer, make_train_step

    cfg, it, consts, _ = _training_setup(torch)
    embedding.set_scatter_impl("fast")
    batches = list(it.epoch(1))
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = advanced_ncf.init(gen, cfg.model)
    opt = make_optimizer(cfg.train, steps_per_epoch=len(batches))
    state = opt.init(params)
    step = make_train_step(get_model("advanced_ncf"), cfg, opt, *consts)
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
    summary = {"step_ms_host_clock": host_ms, "step_ms_windows": windows,
               "step_ms_cuda_events": dev_ms,
               "examples_per_s": B / (host_ms / 1e3), "batch": B}
    log(f"training timing: step {host_ms!r} ms (host clock, synchronised, "
        f"median of 5 windows of 20: {windows}), {dev_ms!r} ms (CUDA "
        f"events), {summary['examples_per_s']!r} examples/s at batch {B}")
    prof = device_profile(one, 20)
    if prof is not None:
        summary["profile"] = prof
        log("profile_json: " + json.dumps({"what": "training step", **prof}))
    b = batches[0]
    negs = sample_negatives_stratified(
        gen, torch.as_tensor(b["item_ids"], device="cuda"),
        cfg.model.num_items, cfg.model.negative_samples, cdf=consts[0])
    rows = _time_training_kernels(torch, b, negs, box["p"], cfg, consts)
    for r in rows:
        log(f"timing: {r['kernel']} [{r['shape']}] kernel {r['ms']!r} ms "
            f"(device {r['device_ms']!r} ms), plain {r['plain_ms']!r} ms, "
            f"library {r['library_ms']!r} ms, bound {r['bound_ms']!r} ms "
            f"({r['bound_by']})")
    log("training_timing_json: " + json.dumps(rows))
    log("training_json: " + json.dumps(summary))
    del box, params, state
    torch.cuda.empty_cache()
    return rows, summary


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "ncf_tpu_torch")):
        print("chip_smoke: the ncf_tpu_torch package is not beside this "
              "script", file=sys.stderr)
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
    log(f"phase kernel_vs_plain {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    main_launches, latency = phase_serving(torch, topk, Config, ModelServer,
                                           advanced_ncf)
    log(f"phase serving {time.perf_counter() - t0:.1f} s, kernel launches "
        f"on the main path {main_launches}")
    log("latency_json: " + json.dumps(latency))

    t0 = time.perf_counter()
    rows = phase_timing(torch, topk)
    log(f"phase timing {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    phase_demo(torch, Config, ModelServer)
    log(f"phase demo {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    launches, summary = phase_training(torch, advanced_ncf)
    launches["topk_scores_streaming"] = main_launches
    log(f"phase training {time.perf_counter() - t0:.1f} s")
    log("training_summary_json: " + json.dumps(summary))

    t0 = time.perf_counter()
    log("card_vs_cpu_json: " + json.dumps(phase_card_vs_cpu(torch,
                                                            advanced_ncf)))
    log(f"phase card_vs_cpu {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    train_rows, _ = phase_training_timing(torch, advanced_ncf)
    log(f"phase training_timing {time.perf_counter() - t0:.1f} s")

    # one timed shape per kernel: the serving bucket for B5, the pooled
    # stratified draw for B1, the item table for B2, the step for B3
    main_rows = {"topk_scores_streaming": rows[0]}
    for r in train_rows:
        if (r["kernel"], r["shape"]) in (
                ("tree_sample_negatives", "stratified"),
                ("onehot_scatter_add", "item"),
                ("fused_lookup_sum", "step")):
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
