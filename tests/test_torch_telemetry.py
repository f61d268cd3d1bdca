"""``repro_torch.telemetry``: the span tracer, metrics registry and
``torch.profiler`` hooks, ported from ``tests/test_telemetry.py`` (the
tracer, metrics and bundle cases); the spans under a running profiler, on
its clock and from every thread, the serving worker's among them; plus the
port against the JAX package:
one sequence of calls gives the same Prometheus text in both registries,
and the trainer records the same metrics, with the same observation
counts, as the JAX trainer for the same run.
"""
import json
import logging
import math
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

from repro.configs.base import GNNConfig as JaxGNNConfig
from repro.launch import train as jtrain
from repro.telemetry import MetricsRegistry as JaxMetricsRegistry
from repro.telemetry import Telemetry as JaxTelemetry
from repro_torch.configs.base import GNNConfig
from repro_torch.launch import train as ptrain
from repro_torch.launch.serve_gnn import GNNServer
from repro_torch.telemetry import (NULL_TRACER, Counter, Gauge, Histogram,
                                   MetricsRegistry, NullTracer, Telemetry,
                                   Tracer, check_well_nested, clock_ns,
                                   default_latency_buckets,
                                   default_size_buckets, make_tracer,
                                   profiled_spans, span, trace_capture,
                                   warn_once)
from repro_torch.telemetry.trace import _NULL_SPAN


# ------------------------------------------------------------------ tracer

def test_span_nesting_and_attrs():
    tr = Tracer()
    with tr.span("outer", trace_id="req-1", bucket=256) as outer:
        with tr.span("inner") as inner:
            inner.set(n=3)
    recs = tr.records()
    assert [r.name for r in recs] == ["inner", "outer"]
    inner_r, outer_r = recs
    assert inner_r.parent_id == outer_r.span_id
    assert outer_r.parent_id is None
    # trace_id inherited from the enclosing span
    assert inner_r.trace_id == "req-1" and outer_r.trace_id == "req-1"
    assert outer_r.attrs == {"bucket": 256}
    assert inner_r.attrs == {"n": 3}
    assert inner_r.start_ns >= outer_r.start_ns
    assert inner_r.end_ns <= outer_r.end_ns
    assert check_well_nested(recs) == []


def test_trace_context_binds_default_trace_id():
    tr = Tracer()
    with tr.trace("step-7"):
        with tr.span("a"):
            pass
    with tr.span("b"):
        pass
    a, b = tr.records()
    assert a.trace_id == "step-7"
    assert b.trace_id is None


def test_span_thread_hammer_well_nested():
    """Many threads, deep nesting, no cross-thread leakage."""
    tr = Tracer(max_spans=100_000)
    n_threads, n_iter = 8, 40

    def work(tid):
        for i in range(n_iter):
            with tr.trace(f"t{tid}-{i}"):
                with tr.span("outer", tid=tid):
                    with tr.span("mid"):
                        with tr.span("leaf"):
                            pass

    threads = [threading.Thread(target=work, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    recs = tr.records()
    assert len(recs) == n_threads * n_iter * 3
    assert tr.dropped() == 0
    assert check_well_nested(recs) == []
    # every span picked up the thread's bound trace_id
    assert all(r.trace_id and r.trace_id.startswith("t") for r in recs)


def test_bounded_span_buffer_drops_oldest():
    tr = Tracer(max_spans=10)
    for i in range(25):
        with tr.span(f"s{i}"):
            pass
    recs = tr.records()
    assert len(recs) == 10
    assert tr.dropped() == 15
    assert recs[-1].name == "s24"          # newest survive


def test_record_span_external_interval():
    tr = Tracer()
    t0 = clock_ns()
    t1 = t0 + 500_000_000
    tr.record_span("queue_wait", t0, t1, trace_id="req-9", bucket=128)
    [r] = tr.records()
    assert r.duration_s == pytest.approx(0.5)
    assert r.trace_id == "req-9" and r.attrs == {"bucket": 128}
    assert r.parent_id is None


def test_exporters_jsonl_and_chrome(tmp_path):
    tr = Tracer()
    with tr.span("flush", items=2):
        with tr.span("prepare"):
            pass
    jl = str(tmp_path / "trace.jsonl")
    ch = str(tmp_path / "trace_chrome.json")
    assert tr.export_jsonl(jl) == 2
    assert tr.export_chrome_trace(ch) == 2
    lines = [json.loads(l) for l in open(jl)]
    assert {l["name"] for l in lines} == {"flush", "prepare"}
    for l in lines:
        assert l["end_ns"] >= l["start_ns"]
        assert l["start_ns"] > 1e18        # the Unix epoch, in ns
    chrome = json.load(open(ch))
    evs = chrome["traceEvents"]
    xs = [e for e in evs if e["ph"] == "X"]
    ms = [e for e in evs if e["ph"] == "M"]
    assert len(xs) == 2 and len(ms) >= 1   # spans + thread-name metadata
    for e in xs:
        assert e["ts"] >= 0 and e["dur"] >= 0


def test_null_tracer_is_shared_noop(tmp_path):
    assert make_tracer(False) is NULL_TRACER
    assert isinstance(NULL_TRACER, NullTracer)
    # no allocation: every span is the same shared object
    assert NULL_TRACER.span("a", bucket=1) is _NULL_SPAN
    assert NULL_TRACER.span("b") is NULL_TRACER.span("c")
    with NULL_TRACER.span("x") as s:
        s.set(y=1)
    NULL_TRACER.record_span("z", 0.0, 1.0)
    assert NULL_TRACER.records() == []
    p = str(tmp_path / "empty.jsonl")
    assert NULL_TRACER.export_jsonl(p) == 0
    assert open(p).read() == ""


def test_disabled_span_overhead():
    """The disabled tracer must be decisively cheaper than a real span —
    the zero-cost-when-off contract for the serving hot path."""
    n = 20_000

    def loop(tracer):
        t0 = time.perf_counter()
        for _ in range(n):
            with tracer.span("hot", bucket=256):
                pass
        return time.perf_counter() - t0

    enabled = Tracer(max_spans=n)
    loop(NULL_TRACER), loop(enabled)       # warm both paths
    dt_off = min(loop(NULL_TRACER) for _ in range(3))
    dt_on = min(loop(enabled) for _ in range(3))
    assert dt_off < dt_on / 2, (dt_off, dt_on)


# ----------------------------------------------------------------- metrics

def test_counter_gauge_basics():
    c = Counter("n")
    c.inc()
    c.inc(4)
    assert c.value == 5
    g = Gauge("g")
    g.set(2.5)
    g.inc(0.5)
    assert g.value == 3.0


def test_histogram_stats_and_percentiles():
    h = Histogram("lat", buckets=default_latency_buckets())
    assert h.percentile(50) == 0.0         # empty: explicit zero, no fakery
    assert h.snapshot()["p50"] is None
    for v in (0.001, 0.002, 0.004, 0.008, 0.1):
        h.observe(v)
    assert h.count == 5
    assert h.sum == pytest.approx(0.115)
    assert h.mean == pytest.approx(0.023)
    p50, p95 = h.percentile(50), h.percentile(95)
    assert 0.001 <= p50 <= p95 <= 0.1      # clamped to observed [min, max]
    snap = h.snapshot()
    assert snap["min"] == pytest.approx(0.001)
    assert snap["max"] == pytest.approx(0.1)


def test_histogram_single_observation_reports_itself():
    h = Histogram("x", buckets=(1.0, 2.0, 4.0))
    h.observe(3.3)
    for q in (0, 50, 95, 100):
        assert h.percentile(q) == pytest.approx(3.3)


def test_histogram_cumulative_buckets_monotone():
    h = Histogram("x", buckets=default_size_buckets(1, 64))
    for v in (1, 3, 3, 17, 1000):          # 1000 -> the +Inf bucket
        h.observe(v)
    cum = h.cumulative_buckets()
    counts = [c for _, c in cum]
    assert counts == sorted(counts)
    assert math.isinf(cum[-1][0]) and cum[-1][1] == 5


def test_registry_get_or_create_and_kind_mismatch():
    reg = MetricsRegistry()
    c1 = reg.counter("reqs")
    assert reg.counter("reqs") is c1
    with pytest.raises(TypeError):
        reg.gauge("reqs")
    h = reg.histogram("lat")
    assert reg.histogram("lat") is h


def test_prometheus_text_format():
    reg = MetricsRegistry()
    reg.counter("serve_requests_total", help="total requests").inc(3)
    reg.gauge("train_loss").set(0.25)
    h = reg.histogram("serve_latency_seconds", buckets=(0.1, 1.0),
                      help="latency")
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)
    text = reg.prometheus_text()
    lines = text.strip().split("\n")
    # every line is a comment or `name{labels} value`
    sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{le="[^"]+"\})? \S+$')
    for ln in lines:
        assert ln.startswith("# ") or sample.match(ln), ln
    assert "# TYPE serve_requests_total counter" in lines
    assert "# HELP serve_requests_total total requests" in lines
    assert "# TYPE serve_latency_seconds histogram" in lines
    assert 'serve_latency_seconds_bucket{le="0.1"} 1' in lines
    assert 'serve_latency_seconds_bucket{le="1.0"} 2' in lines
    assert 'serve_latency_seconds_bucket{le="+Inf"} 3' in lines
    assert "serve_latency_seconds_count 3" in lines
    assert any(l.startswith("serve_latency_seconds_sum ") for l in lines)
    assert "serve_requests_total 3.0" in lines


def test_warn_once_dedups_per_key(caplog):
    log = logging.getLogger("test_warn_once")
    wo = warn_once(log)
    with caplog.at_level(logging.WARNING, logger="test_warn_once"):
        assert wo(("oversize", 512), "oversize 512") is True
        assert wo(("oversize", 512), "oversize 512") is False
        assert wo(("oversize", 1024), "oversize 1024") is True
    warned = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warned) == 2
    assert wo.count(("oversize", 512)) == 2


# ---------------------------------------------------------------- bundle

def test_telemetry_bundle_disabled_is_null():
    tel = Telemetry.disabled()
    assert not tel.enabled
    assert tel.tracer is NULL_TRACER
    assert tel.span("x") is _NULL_SPAN
    with tel.capture():                    # no trace_dir: no-op
        pass


def test_telemetry_bundle_export(tmp_path):
    tel = Telemetry(enabled=True, trace_dir=str(tmp_path))
    with tel.span("step", trace_id="step-0"):
        pass
    tel.metrics.counter("steps").inc()
    paths = tel.export()
    assert sorted(paths) == ["metrics_json", "metrics_prom", "trace_chrome",
                             "trace_jsonl"]
    [line] = [json.loads(l) for l in open(paths["trace_jsonl"])]
    assert line["name"] == "step" and line["trace_id"] == "step-0"
    assert json.load(open(paths["trace_chrome"]))["traceEvents"]
    assert "steps 1.0" in open(paths["metrics_prom"]).read()
    snap = json.load(open(paths["metrics_json"]))
    assert snap["metrics"]["steps"] == 1
    assert isinstance(snap["device_memory"], list)
    assert all("device" in d for d in snap["device_memory"])


def test_telemetry_from_config():
    tel = Telemetry.from_config(GNNConfig())
    assert not tel.enabled
    tel = Telemetry.from_config(
        GNNConfig().replace(telemetry=True, trace_dir="/tmp/x"))
    assert tel.enabled and tel.trace_dir == "/tmp/x"

    class Legacy:                          # config predating the knobs
        pass
    assert not Telemetry.from_config(Legacy()).enabled


# ------------------------------------------------------ torch.profiler hooks

def test_capture_writes_a_torch_profile(tmp_path):
    tel = Telemetry(enabled=True, trace_dir=str(tmp_path), profile=True)
    with tel.capture() as log_dir:
        with tel.span("region"):
            torch.ones(64).sum()
    assert log_dir == os.path.join(str(tmp_path), "torch_profile")
    trace = json.load(open(os.path.join(log_dir, "trace.json")))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "region" in names
    # profile without telemetry (or without a trace_dir) is a no-op
    assert not Telemetry(enabled=False, trace_dir=str(tmp_path),
                         profile=True).profile
    with Telemetry(enabled=True, profile=True).capture() as none:
        assert none is None


def test_span_without_a_profiler_is_the_shared_noop():
    """Telemetry off and no profiler: every span is the one shared no-op,
    and nothing lands in the profiled buffer."""
    t0 = clock_ns()
    tel = Telemetry.disabled()
    assert tel.span("prepare", bucket=256) is _NULL_SPAN
    assert span("knn", level=0) is _NULL_SPAN
    with span("features"), tel.span("prepare"):
        NULL_TRACER.record_span("queue_wait", t0, clock_ns())
    assert profiled_spans(t0, clock_ns()) == []


def test_span_under_a_profiler_is_a_range_and_a_profiled_span():
    """Under ``torch.profiler`` (on the CPU) a main-thread span is both a
    ``record_function`` event of the profile and a profiled span, their
    starts on one clock within 1 ms; spans nest, a retroactive span lands
    too, and an enabled tracer records its own copy."""
    from torch.profiler import profile
    tel = Telemetry(enabled=True)
    t0 = clock_ns()
    with profile() as prof:
        with tel.span("outer", trace_id="req-3"):
            with span("inner", level=2):
                torch.ones(64).sum()
        tel.tracer.record_span("queue_wait", t0, clock_ns(), bucket=8)
    got = {r.name: r for r in profiled_spans(t0, clock_ns())}
    assert set(got) == {"outer", "inner", "queue_wait"}
    assert got["inner"].parent_id == got["outer"].span_id
    assert got["inner"].attrs == {"level": 2}
    assert got["inner"].trace_id == "req-3"
    assert got["outer"].thread_name == threading.current_thread().name
    assert check_well_nested(list(got.values())) == []
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in ("outer", "inner")}
    assert set(events) == {"outer", "inner"}
    for name, ev in events.items():
        assert abs(got[name].start_ns - ev.start_ns()) < 1_000_000, name
    assert sorted(r.name for r in tel.tracer.records()) == [
        "outer", "queue_wait"]


def test_trace_capture_writes_a_worker_threads_span(tmp_path):
    """``trace_capture`` profiles every thread: a span opened on a worker
    thread that started before the capture is in ``trace.json``."""
    go, done = threading.Event(), threading.Event()

    def worker():
        go.wait(30)
        with span("worker_region"):
            torch.ones(64).sum()
        done.set()

    th = threading.Thread(target=worker, name="capture-worker")
    th.start()
    try:
        with trace_capture(str(tmp_path)):
            go.set()
            assert done.wait(30)
    finally:
        go.set()
        th.join(30)
    trace = json.load(open(tmp_path / "trace.json"))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "worker_region" in names


def test_serving_worker_spans_under_a_profiler():
    """A CPU ``GNNServer`` with its background worker, two requests served
    inside ``torch.profiler.profile``: the worker's stage spans are in the
    profiled buffer from thread ``gnn-serve-worker``, a ``sample`` per
    request id, well nested per thread."""
    from repro_torch.data import geometry as geo
    from torch.profiler import profile
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = GNNConfig().reduced().replace(levels=(64, 128, 256))
    server = GNNServer(cfg, (128,), max_batch=2, seed=0, device="cpu")
    verts, faces = geo.car_surface(geo.sample_params(0))
    server.start(deadline_s=0.01)
    try:
        t0 = clock_ns()
        with profile():
            rids = [server.submit(verts, faces, 128) for _ in range(2)]
            results = [server.result(rid, timeout=60) for rid in rids]
            rids.append(server.submit(verts, faces, 128))
            results.append(server.result(rids[-1], timeout=60))
            time.sleep(0.05)             # the worker waits for work again
        t1 = clock_ns()
    finally:
        server.stop()
        torch.set_num_threads(n)
    assert all(r.error is None for r in results)
    recs = profiled_spans(t0, t1)
    worker = [r for r in recs if r.thread_name == "gnn-serve-worker"]
    assert {"prepare", "sample", "dispatch", "h2d", "enqueue",
            "device_wait", "harvest", "publish", "await_work",
            "flush", "knn", "features", "encoder", "processor",
            "decoder"} <= {r.name for r in worker}
    assert sorted(r.attrs["rid"] for r in worker
                  if r.name == "sample") == sorted(rids)
    assert {"submit", "queue_wait", "request", "result"} <= {
        r.name for r in recs}
    assert check_well_nested(recs) == []
    assert all(t0 <= r.start_ns <= r.end_ns <= t1 for r in worker
               if r.name != "await_work")


def test_device_memory_snapshot():
    """Empty unless this process has used CUDA; then one numeric record
    per card."""
    from repro_torch.telemetry import device_memory_snapshot
    snap = device_memory_snapshot()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        assert [d["device"] for d in snap] == [
            f"cuda:{i}" for i in range(torch.cuda.device_count())]
        assert all(isinstance(v, (int, float))
                   for d in snap for v in d["stats"].values())
    else:
        assert snap == []


# ------------------------------------------------------------ against JAX

def _drive(reg):
    """One sequence of calls, the same on either registry."""
    reg.counter("serve_requests_total", help="total requests").inc(3)
    reg.counter("serve_requests_total").inc()
    reg.gauge("train_loss", help="loss").set(0.25)
    reg.gauge("queue depth").inc(2)                  # sanitized name
    reg.gauge("zero")
    h = reg.histogram("lat_seconds", buckets=(0.001, 0.01, 0.1),
                      help="latency")
    for v in (0.0005, 0.002, 0.002, 0.05, 7.0):
        h.observe(v)
    d = reg.histogram("train_stage_step_seconds",
                      buckets=default_latency_buckets())
    for v in (0.3, 15.2, 15.4):
        d.observe(v)
    reg.histogram("batch", buckets=default_size_buckets(1, 64)).observe(3)


def test_prometheus_text_and_snapshot_equal_jax():
    ours, theirs = MetricsRegistry(), JaxMetricsRegistry()
    _drive(ours)
    _drive(theirs)
    assert ours.prometheus_text() == theirs.prometheus_text()
    assert ours.snapshot() == theirs.snapshot()


SIZE = dict(levels=(32, 64), n_partitions=2, hidden=16, n_mp_layers=2,
            halo=2)


def _metric_counts(reg):
    """{name: observation count (histograms) or value (others)}."""
    out = {}
    for name, m in reg.metrics().items():
        out[name] = m.count if m.kind == "histogram" else m.value
    return out


def test_trainer_metrics_match_jax(tmp_path):
    """The same run (4 steps, a checkpoint every step, 2 retained, one
    poisoned batch) in both trainers: the same metric names, the same
    histogram observation counts, the same step and skip counters, and the
    same span names."""
    from repro.resilience import FAULTS as JAX_FAULTS
    from repro_torch.resilience import FAULTS
    jcfg = JaxGNNConfig().reduced().replace(**SIZE)
    cfg = GNNConfig().reduced().replace(**SIZE)
    tels = {}
    try:
        for name, mod, c, inj, kw in (
                ("jax", jtrain, jcfg, JAX_FAULTS, {}),
                ("port", ptrain, cfg, FAULTS, {"device": "cpu"})):
            tel = (JaxTelemetry if name == "jax" else Telemetry)(
                enabled=True)
            inj.arm("train.batch", mode="corrupt", nth=3, times=1)
            mod.train_gnn(c, 4, 2, str(tmp_path / f"{name}.msgpack"),
                          log_every=100, telemetry=tel, ckpt_every=1,
                          keep_ckpts=2, **kw)
            inj.reset()
            tels[name] = tel
    finally:
        JAX_FAULTS.reset()
        FAULTS.reset()
    want, got = (_metric_counts(tels[k].metrics) for k in ("jax", "port"))
    assert sorted(got) == sorted(want)
    # the last loss: each trainer draws its own initial weights
    assert np.isfinite(got["train_loss"]) and np.isfinite(want["train_loss"])
    del got["train_loss"], want["train_loss"]
    assert got == want
    assert got["train_steps_total"] == 4
    assert got["train_nonfinite_steps_total"] == 1
    assert got["train_stage_checkpoint_seconds"] == 4
    assert got["train_stage_eval_seconds"] == 0
    spans = [sorted({r.name for r in tels[k].tracer.records()})
             for k in ("jax", "port")]
    assert spans[0] == spans[1]
    recs = tels["port"].tracer.records()
    assert check_well_nested(recs) == []
    steps = [r for r in recs if r.name == "step"]
    assert [r.trace_id for r in steps] == [f"step-{i}" for i in range(4)]
    assert all(r.trace_id is not None for r in recs if r.name == "prepare")


def test_train_cli_exports_telemetry(tmp_path, capsys):
    """``--telemetry --trace-dir`` writes the four artifacts; the eval
    stage is observed once, in an ``eval`` span."""
    trace_dir = str(tmp_path / "tr")
    ptrain.main(["--arch", "xmgn-drivaer", "--reduced", "--steps", "2",
                 "--samples", "3", "--device", "cpu", "--trace-dir",
                 trace_dir])
    out = capsys.readouterr().out
    assert "telemetry artifacts" in out
    snap = json.load(open(os.path.join(trace_dir, "metrics.json")))
    assert snap["metrics"]["train_stage_eval_seconds"]["count"] == 1
    assert snap["metrics"]["train_steps_total"] == 2
    names = {json.loads(line)["name"]
             for line in open(os.path.join(trace_dir, "trace.jsonl"))}
    assert {"data", "partition", "step", "prepare", "eval"} <= names
