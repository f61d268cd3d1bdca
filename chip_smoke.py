#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit, no result line):

1. card: print the card's name and power limit (nvidia-smi);
2. build: compile every CUDA kernel of the serving path from the sources in
   this checkout (nvcc, sm_90a) into build/kernels/;
3. kernels: hold each kernel against its plain PyTorch version on the card
   at the serving path's shapes (65,536-point bucket, full width), and time
   kernel, plain version, one library call for the same function, and the
   bound (bytes over 3.35 TB/s, or f32 flops over 67 TFLOP/s);
4. whole path: one 2,048-point request through the full-width model
   (``GNNConfig()``) on the card and on the CPU (plain versions), same
   params; edges must be equal and fields agree to 1e-4;
5. serve: ``GNNServer(GNNConfig(), (16384, 65536), max_batch=2)``, warmup
   plus 4 demo requests, latency reported per bucket; the launch counters
   must show 15 segment-sum and 3 kNN launches per request run, warmup
   included;
6. breakdown: where one 65,536-point request's time goes, and one row's
   time through each bucket's pipeline.

It then prints a ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line. It needs one card and imports
nothing of JAX.
"""
from __future__ import annotations

import copy
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
BUCKETS = (16384, 65536)
WHOLE_PATH_POINTS = 2048
# Fields of one full-width request, card against CPU: the graphs are
# identical (asserted), but cuBLAS and the CPU BLAS sum the f32 products of
# 15 residual layers of width 512 in different orders, and the sin/cos of the
# features come from different libraries. Measured on an H100: 1.7e-6 max
# abs error on O(1) outputs, in three runs; 1e-4 leaves room for other BLAS
# builds and still fails on any real divergence.
WHOLE_PATH_ATOL = 1e-4
SEG_ATOL, SEG_RTOL = 1e-4, 1e-5
KNN_D2_ATOL = 1e-6


def log(msg: str):
    print(msg, flush=True)


def time_cuda(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` launches, each timed by
    CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.base import GNNConfig
    from repro_torch.core.graph_build import sample_surface
    from repro_torch.data import geometry as geo
    from repro_torch.graphx import hashgrid
    from repro_torch.graphx.multiscale import (MultiscaleSpec,
                                               multiscale_edges)
    from repro_torch.graphx.pipeline import make_graph_forward, make_infer_fn
    from repro_torch.kernels import _build
    from repro_torch.kernels.knn import ops as knn_ops
    from repro_torch.kernels.knn import ref as knn_ref
    from repro_torch.kernels.segment_agg import ops as seg_ops
    from repro_torch.kernels.segment_agg import ref as seg_ref
    from repro_torch.launch.serve_gnn import (GNNServer, Request,
                                              _level_sizes)
    from repro_torch.models import meshgraphnet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    counters = {"segment_sum": seg_ops.segment_sum_prepared,
                "knn_topk": knn_ops.topk_neighbors}
    by_phase = {name: {} for name in counters}

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts(phase):
        for name, fn in counters.items():
            by_phase[name][phase] = fn.launches

    # 1. card --------------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()} | "
        "allow_tf32: matmul False, cudnn False")

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[build] {len(_build.SOURCES)} kernels ({len(logs)} compiled now) "
        f"in {time.perf_counter() - t0:.2f} s -> {_build.BUILD_DIR}")
    for name, out in logs.items():
        regs = sorted({int(m) for m in re.findall(r"Used (\d+) registers",
                                                  out)}) or ["?"]
        spills = re.search(r"[1-9]\d* bytes spill", out) is not None
        log(f"[build] {name}: {regs[0]}-{regs[-1]} registers per thread "
            f"over its instantiations, spills: {spills}")

    # the 65,536-point bucket's graph, as the server calibrates and builds it
    n_big = BUCKETS[-1]
    ref_verts, ref_faces = geo.car_surface(geo.sample_params(0))
    ref_pts, _ = sample_surface(ref_verts, ref_faces, n_big,
                                np.random.default_rng(0))
    levels = _level_sizes(n_big, 3)
    grids = tuple(hashgrid.calibrate_spec(ref_pts[:m], 6, n_points=m)
                  for m in levels)
    ms = MultiscaleSpec(levels, 6, grids)
    pts = torch.from_numpy(ref_pts).to(dev)

    # 3. kernels -----------------------------------------------------------
    reset_counts()
    kernels = []
    gspec = grids[-1]
    cand, cvalid, _ = hashgrid.csr_candidate_lists(pts, n_big, gspec)
    cpos = pts[cand.long()]
    k = gspec.k
    ki, kd, km = knn_ops.topk_neighbors(pts, cpos, cand, cvalid, k)
    torch.cuda.synchronize()
    pi, pd, pm = knn_ref.topk_neighbors(pts, cpos, cand, cvalid, k)
    if not (torch.equal(ki, pi) and torch.equal(km, pm)):
        raise RuntimeError("knn_topk: indices differ from the plain version")
    knn_err = float((kd - pd).abs().max())
    if knn_err > KNN_D2_ATOL:
        raise RuntimeError(f"knn_topk: d2 error {knn_err} > {KNN_D2_ATOL}")
    d2_masked = torch.where(
        cvalid, ((cpos - pts[:, None, :]) ** 2).sum(-1), knn_ref.BIG)
    n_c = cand.shape[1]
    n_valid_cand = int(cvalid.sum())
    knn_bytes = (n_big * 12 + n_big * n_c * 1 + n_valid_cand * 12
                 + n_big * k * 4 + n_big * k * 8)
    knn_bound = bound_ms(knn_bytes, 8.0 * n_valid_cand)
    kernels.append(dict(
        name="knn_topk", route="cuda",
        source="src/repro_torch/kernels/knn/csrc/knn_topk.cu",
        replaces="src/repro/kernels/knn/kernel.py:27",
        max_abs_err=knn_err,
        ms=time_cuda(lambda: knn_ops.topk_neighbors(pts, cpos, cand, cvalid,
                                                    k), 50),
        plain_ms=time_cuda(lambda: knn_ref.topk_neighbors(pts, cpos, cand,
                                                          cvalid, k), 10),
        bound_ms=knn_bound[0], bound_by=knn_bound[1],
        library_ms=time_cuda(lambda: torch.topk(d2_masked, k, dim=1,
                                                largest=False), 50),
        shape=f"N={n_big} C={n_c} k={k}, valid candidates "
              f"{n_valid_cand / (n_big * n_c):.3f}"))

    senders, receivers, emask = multiscale_edges(pts, n_big, ms)
    n_e, d = receivers.numel(), GNNConfig().hidden
    g = torch.Generator().manual_seed(0)
    msg = torch.randn((n_e, d), generator=g).to(dev) * emask[:, None]
    prep = seg_ops.prepare(receivers, n_big, emask)
    so = seg_ops.segment_sum_prepared(prep, msg)
    torch.cuda.synchronize()
    sp = seg_ref.segment_sum_csr(msg, prep.perm, prep.row_ptr)
    torch.testing.assert_close(so, sp, atol=SEG_ATOL, rtol=SEG_RTOL)
    seg_err = float((so - sp).abs().max())
    recv_long = receivers.long()
    lib_err = float((so - torch.zeros_like(so).index_add_(
        0, recv_long, msg)).abs().max())
    e_valid = int(emask.sum())
    seg_bytes = e_valid * d * 4 + n_big * d * 4 + e_valid * 4 + \
        (n_big + 1) * 4
    seg_bound = bound_ms(seg_bytes, float(e_valid) * d)
    kernels.append(dict(
        name="segment_sum", route="cuda",
        source="src/repro_torch/kernels/segment_agg/csrc/segment_sum.cu",
        replaces="src/repro/kernels/segment_agg/kernel.py:28",
        max_abs_err=seg_err,
        ms=time_cuda(lambda: seg_ops.segment_sum_prepared(prep, msg), 50),
        plain_ms=time_cuda(lambda: seg_ref.segment_sum_csr(
            msg, prep.perm, prep.row_ptr), 5),
        bound_ms=seg_bound[0], bound_by=seg_bound[1],
        library_ms=time_cuda(lambda: torch.zeros_like(so).index_add_(
            0, recv_long, msg), 50),
        shape=f"E={n_e} N={n_big} D={d}, masked "
              f"{1 - e_valid / n_e:.3f}, max abs diff vs index_add_ "
              f"{lib_err:.3g}"))
    torch.cuda.synchronize()
    read_counts("kernel_check")
    for kr in kernels:
        log(f"[kernels] {kr['name']}: {kr['ms']:.4f} ms (bound "
            f"{kr['bound_ms']:.4f} ms by {kr['bound_by']}, plain "
            f"{kr['plain_ms']:.3f} ms, library {kr['library_ms']:.4f} ms) "
            f"max abs err {kr['max_abs_err']:.3g} | {kr['shape']}")
    del msg, so, sp, cpos, d2_masked

    # 4. whole path: card against CPU, one full-width request ---------------
    reset_counts()
    cfg = GNNConfig()
    n_w = WHOLE_PATH_POINTS
    w_levels = _level_sizes(n_w, 3)
    w_ref, _ = sample_surface(ref_verts, ref_faces, n_w,
                              np.random.default_rng(0))
    w_ms = MultiscaleSpec(w_levels, cfg.k_neighbors, tuple(
        hashgrid.calibrate_spec(w_ref[:m], cfg.k_neighbors, n_points=m)
        for m in w_levels))
    verts, faces = geo.car_surface(geo.sample_params(1))
    w_pts, w_nrm = sample_surface(verts, faces, n_w,
                                  np.random.default_rng((0, 2)))
    model_cpu = meshgraphnet.init(torch.Generator().manual_seed(0), cfg,
                                  device="cpu")
    model_gpu = copy.deepcopy(model_cpu).to(dev)
    e_gpu = multiscale_edges(torch.from_numpy(w_pts).to(dev), n_w, w_ms)
    e_cpu = multiscale_edges(torch.from_numpy(w_pts), n_w, w_ms)
    for a, b in zip(e_gpu, e_cpu):
        if not torch.equal(a.cpu(), b):
            raise RuntimeError("whole path: card and CPU built different "
                               "edge sets")
    infer = make_infer_fn(cfg, w_ms)
    t0 = time.perf_counter()
    out_gpu = infer(model_gpu, torch.from_numpy(w_pts).to(dev),
                    torch.from_numpy(w_nrm).to(dev), n_w).cpu()
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_cpu = infer(model_cpu, torch.from_numpy(w_pts),
                    torch.from_numpy(w_nrm), n_w)
    t_cpu = time.perf_counter() - t0
    if out_gpu.shape != (n_w, cfg.node_out) or \
            not torch.isfinite(out_gpu).all():
        raise RuntimeError("whole path: bad output on the card")
    whole_err = float((out_gpu - out_cpu).abs().max())
    if whole_err > WHOLE_PATH_ATOL:
        raise RuntimeError(f"whole path: card vs CPU max abs error "
                           f"{whole_err} > {WHOLE_PATH_ATOL}")
    read_counts("whole_path")
    log(f"[whole_path] {n_w} points, hidden {cfg.hidden}, {cfg.n_mp_layers} "
        f"layers, E={w_ms.n_edges}: edges equal, fields max abs err "
        f"{whole_err:.3g} (atol {WHOLE_PATH_ATOL}); card {t_gpu:.3f} s "
        f"(first call), CPU {t_cpu:.2f} s")
    del model_cpu, model_gpu

    # 5. serve: the main path, counted --------------------------------------
    server = GNNServer(cfg, BUCKETS, max_batch=2, seed=0)
    reqs = []
    for i, n_req in enumerate((16384, 65536, 16384, 65536)):
        v, f = geo.car_surface(geo.sample_params(i + 1))
        reqs.append((v, f, n_req))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    server.warmup()
    t_warm = time.perf_counter() - t0
    results = server.serve(reqs)
    torch.cuda.synchronize()
    read_counts("serve")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rows = len(BUCKETS) * server.max_batch + len(reqs)
    want = {"segment_sum": cfg.n_mp_layers * rows,
            "knn_topk": len(ms.level_sizes) * rows}
    for name, n in want.items():
        got = by_phase[name]["serve"]
        if got != n:
            raise RuntimeError(f"serve: {name} launched {got} times, "
                               f"expected {n} ({rows} requests run)")
    if len(results) != len(reqs):
        raise RuntimeError(f"serve: {len(results)} results for "
                           f"{len(reqs)} requests")
    for r, (_, _, n_req) in zip(sorted(results, key=lambda r: r.request_id),
                                reqs):
        if r.bucket != n_req or r.fields.shape != (n_req, cfg.node_out) \
                or not np.isfinite(r.fields).all():
            raise RuntimeError(f"serve: bad result for request "
                               f"{r.request_id}")
    rep = server.stats.report()
    log(f"[serve] warmup {t_warm:.2f} s; served {rep['requests']} requests "
        f"in one flush | {rep['throughput_rps']:.3f} req/s | peak memory "
        f"{peak_gb:.2f} GB | launches segment_sum "
        f"{by_phase['segment_sum']['serve']}, knn_topk "
        f"{by_phase['knn_topk']['serve']} for {rows} requests run | {card}")
    # 2 requests per bucket: p50 and p95 are the mean and near the larger of
    # the two, not a spread. submit->result includes the wait behind the
    # flush's earlier (smaller-bucket) batch; batch run does not.
    for n, bb in rep["by_bucket"].items():
        log(f"[serve] bucket {n}: {bb['requests']} requests | "
            f"submit->result p50 {bb['p50_ms']:.1f} ms p95 "
            f"{bb['p95_ms']:.1f} ms | batch run p50 {bb['run_p50_ms']:.1f} "
            f"ms p95 {bb['run_p95_ms']:.1f} ms")

    # 6. breakdown of one 65,536-point request ------------------------------
    b = server._buckets[n_big]
    stage = {}
    t0 = time.perf_counter()
    req = Request(reqs[1][0], reqs[1][1], 1, n_big)
    p_np, n_np = server._sample(req, n_big)
    stage["sample_host"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    server._check_cloud(b, p_np, 1)
    stage["check_cloud_host"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_d = torch.from_numpy(p_np).to(dev)
    n_d = torch.from_numpy(n_np).to(dev)
    torch.cuda.synchronize()
    stage["h2d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_d, r_d, m_d = multiscale_edges(p_d, n_big, b.ms)
    torch.cuda.synchronize()
    stage["graph_build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fwd = make_graph_forward(cfg)
    out = fwd(server.params, p_d, n_d, s_d, r_d, m_d)
    torch.cuda.synchronize()
    stage["features_and_model"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out.cpu()
    stage["d2h"] = time.perf_counter() - t0
    seg_share = cfg.n_mp_layers * kernels[1]["ms"] / 1e3
    log("[breakdown] 65536-point request, seconds: " + ", ".join(
        f"{k} {v:.4f}" for k, v in stage.items())
        + f"; of the model, segment_sum ~{seg_share:.4f} "
        f"({cfg.n_mp_layers} x kernel median)")
    row_s = {}
    for n in BUCKETS:
        p_np, n_np = server._sample_reference(n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server._buckets[n].infer(server.params,
                                 torch.from_numpy(p_np[None]).to(dev),
                                 torch.from_numpy(n_np[None]).to(dev), [n])
        torch.cuda.synchronize()
        row_s[n] = time.perf_counter() - t0
    log("[breakdown] one row through a bucket's pipeline, seconds: "
        + ", ".join(f"{n} points {t:.4f}" for n, t in row_s.items()))

    for kr in kernels:
        kr["launches"] = by_phase[kr["name"]]["serve"]
        kr["launches_by_phase"] = by_phase[kr["name"]]
        kr["phases"] = [p for p, n in by_phase[kr["name"]].items() if n]
        kr["card"] = card
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
