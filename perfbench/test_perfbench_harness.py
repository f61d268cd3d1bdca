"""The benchmark's harness on the CPU: the manifest against the benchmark's
rules, finding cells, configurations and metrics by name (a new cell is
new files alone), the counting functions against hand counts, the import
isolation, the result line and the traced run's profile guard."""
import json
import re
import shutil

import pytest

from perfbench import counts, harness, isolation, tracing

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def test_manifest_keys_names_and_units(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= manifest["run_seconds"] <= 51
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
        assert c["file"].startswith("perfbench/")
    names = [w["name"] for w in manifest["workloads"]]
    assert len(set(names)) == len(names)
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if m["unit"] == "%":
            assert m["name"].split(".")[0].endswith("_roofline") \
                or "mfu" in m["name"]


@pytest.mark.parametrize("cell", ["xmgn-serve-65k", "xunet3d-pass",
                                  "xmgn-train-8part", "xmgn-serve-8k"])
def test_every_cell_finds_its_files(manifest, cell):
    entry, spec, config = harness.cell_files(cell, manifest)
    assert harness.load_driver(spec["driver"]).Driver
    assert set(config["reduced"]) == set(
        next(c for c in manifest["configs"]
             if c["name"] == entry["config"])["reduced"])
    e2e = {m["name"] for m in harness.cell_metrics(manifest, cell,
                                                    "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.cell_metrics(manifest, cell, "per_layer")
    assert layer
    for m in layer:
        assert callable(harness.load_metric(m["name"]).read)
    assert spec["check"]["limits"]


def test_a_new_cell_is_new_files_and_entries_alone(manifest, small, tmp_path,
                                                   monkeypatch):
    """A cell with a traffic, an end-to-end name and a per-layer metric of
    its own, added as files and manifest entries: the harness runs it
    unedited, and the metric counts work that no reader counted before
    from the context's records."""
    root = tmp_path / "perfbench"
    for d in ("traffic", "metrics", "configs"):
        shutil.copytree(harness.HERE / d, root / d)
    traffic = json.loads((root / "traffic" / "serve-8k.json").read_text())
    traffic["traffic"]["clients"] = 3
    traffic["end_to_end"] = {"serve_points_per_s.3c": "serve_points_per_s"}
    (root / "traffic" / "serve-3c.json").write_text(json.dumps(traffic))
    (root / "metrics" / "encoder_ops.serve3c.py").write_text(
        "from perfbench import counts\n\n\ndef read(ctx):\n"
        "    cfg = ctx['cfg']\n"
        "    return sum(counts.dense_flops(r['points'], [cfg.node_in, "
        "cfg.hidden]) for r in ctx['requests'])\n")
    m = json.loads(json.dumps(manifest))
    m["workloads"].append({"name": "xmgn-serve-3c", "config": "xmgn-drivaer",
                           "traffic": "serve-3c", "chips": 1, "why": "test"})
    m["end_to_end"].append({"name": "serve_points_per_s.3c",
                            "unit": "points/s", "better": "higher",
                            "bound": 0.2, "source": "host_clock",
                            "workloads": ["xmgn-serve-3c"]})
    m["per_layer"].append({"name": "encoder_ops.serve3c", "unit": "flop",
                           "better": "higher", "source": "device_trace",
                           "layer": "MeshGraphNet forward",
                           "moves": "serve_points_per_s.3c",
                           "workloads": ["xmgn-serve-3c"]})
    monkeypatch.setattr(harness, "HERE", root)
    monkeypatch.setattr(harness, "REPO", tmp_path)
    over = small["xmgn-serve-8k"]
    out = harness.run_cell("xmgn-serve-3c", 3, 0.3, False, manifest=m,
                           device="cpu", overrides=over)
    assert out["correct"]
    assert set(out["metrics"]) == {"serve_points_per_s.3c", "setup_s"}
    out = harness.run_cell("xmgn-serve-3c", 3, 0.3, True, manifest=m,
                           device="cpu", overrides=over)
    assert out["correct"] and list(out["metrics"]) == ["encoder_ops.serve3c"]
    cfg = harness.program_config(harness.cell_files(
        "xmgn-serve-3c", m)[2], over["config"])
    points = over["traffic"]["points"]
    assert out["metrics"]["encoder_ops.serve3c"]["value"] == \
        out["attempted"] * 2 * points * cfg.node_in * cfg.hidden


def test_counts_against_hand_counts():
    from repro_torch.configs.base import GNNConfig, UNetConfig
    cfg = GNNConfig(hidden=4, n_mp_layers=1, mlp_layers=1, node_in=2,
                    edge_in=1, node_out=3)
    # encoders 2*N*(2*4 + 4*4) and 2*E*(1*4 + 4*4); the layer's edge MLP
    # 2*E*(12*4 + 4*4), node MLP 2*N*(8*4 + 4*4); decoder 2*N*(4*4 + 4*3)
    n, e = 5, 7
    hand = 2 * n * 24 + 2 * e * 20 + 2 * e * 64 + 2 * n * 48 + 2 * n * 28
    assert counts.mgn_forward_flops(cfg, n, e) == hand
    assert counts.segment_sum_bytes(7, 5, 4) == 7 * 16 + 28 + 24 + 5 * 16
    assert counts.segment_sum_backward_bytes(7, 5, 4) == \
        5 * 16 + 28 + 24 + 7 * 16
    # 2 query positions, each one neighbour's position, one id and d2 out
    assert counts.knn_bytes(2, 1) == 24 + 24 + 2 * 8
    assert counts.mgn_aggregation_bytes(cfg, 5, 7) == \
        counts.segment_sum_bytes(7, 5, 4)
    assert counts.mgn_train_segment_sum_bytes(cfg, 5, 7) == \
        3 * counts.segment_sum_bytes(7, 5, 4)
    assert counts.mgn_train_segment_sum_backward_bytes(cfg, 5, 7) == \
        counts.segment_sum_backward_bytes(7, 5, 4)
    u = UNetConfig(in_channels=1, out_channels=1, base_channels=2, depth=1,
                   blocks_per_level=1, attention_gates=False)
    # one 3x3x3 conv 1 -> 2 and the 1x1 head 2 -> 1 over 8 voxels
    assert counts.unet_flops(u, (2, 2, 2)) == 2 * 27 * 1 * 2 * 8 + 2 * 2 * 8
    assert counts.roofline_pct(3.35e12, 0, 2.0) == pytest.approx(50.0)
    assert counts.mfu_pct(counts.PEAK_TF32_FLOPS, 4.0) == pytest.approx(25.0)


def test_isolation_compares_whole_top_level_names():
    assert isolation.loaded_forbidden(["jax", "jax.numpy", "repro.core",
                                       "repro_torch.core", "msgpack",
                                       "reprox", "numpy"]) == \
        ["jax", "jax.numpy", "msgpack", "repro.core"]
    assert isolation.reference_imports_program() == []


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line(small, trace):
    out = harness.run_cell("xmgn-serve-65k", 2 ** 31 + 17, 0.3, trace,
                           device="cpu", overrides=small["xmgn-serve-65k"])
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks" and out["correct"] is True
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "host_prepare_ms.serve65k" in out["metrics"]
    else:
        assert set(out["metrics"]) == {"serve_points_per_s", "setup_s"}
        assert all(v["value"] > 0 for v in out["metrics"].values())


def test_an_empty_profile_is_taken_again_then_refused():
    tries = []
    with pytest.raises(tracing.EmptyTrace):
        tracing.capture(lambda: sum(range(10)), on_retry=tries.append,
                        expect_device=True)
    assert tries == list(range(1, tracing.TRIES))


def test_a_timeline_reads_busy_time_kernels_and_gaps():
    tl = tracing.Timeline(
        window=(0, 10_000),
        device=[("k_a", 1_000, 3_000), ("k_b", 2_000, 4_000),
                ("k_a", 8_000, 9_000)],
        host=[("aten::copy_", 4_500, 7_500), ("outer", 0, 10_000)])
    assert tl.busy_s == pytest.approx(4e-6)
    assert tl.seconds("k_a") == pytest.approx(3e-6)
    assert tl.launches("k_a") == 2
    assert tl.top_ops(1) == [["k_a", pytest.approx(3e-6)]]
    gaps = tl.idle_gaps(2)
    assert gaps[0] == ["aten::copy_", pytest.approx(4e-6)]


def _context(manifest, metric: str, kernels: bool) -> dict:
    """A context as the metric's cell's driver gives it, at the cell's own
    sizes, over a 1-s window in which the named kernels ran 1 ms each."""
    cell = metric_cell(manifest, metric)
    _, spec, config = harness.cell_files(cell, manifest)
    cfg = harness.program_config(config)
    device = [("k", 0, 10 ** 9 // 2)]
    if kernels:
        device += [(k, 0, 10 ** 6) for k in (
            "knn_topk_kernel", "segment_sum_kernel",
            "segment_sum_backward_kernel")]
    ctx = {"timeline": tracing.Timeline(window=(0, 10 ** 9), device=device),
           "cfg": cfg, "spec": spec}
    if spec["driver"] == "serve_closed_loop":
        n = spec["traffic"]["points"]
        ctx.update(prepare_s=0.5, requests=[
            {"car": 0, "rid": i, "points": n,
             "levels": (n // 4, n // 2, n), "edges": 10 * n, "cloud": None}
            for i in range(2)])
    elif spec["driver"] == "train_steps":
        n = max(cfg.levels)
        ctx.update(steps=[{"sample": 0, "nodes": n, "edges": 10 * n,
                           "partitions": [(n, 10 * n)]}])
    else:
        ctx.update(passes=2)
    return ctx


def metric_cell(manifest, metric: str) -> str:
    return next(m for m in manifest["per_layer"]
                if m["name"] == metric)["workloads"][0]


PER_LAYER = [m["name"] for m in harness.load_manifest()["per_layer"]]


@pytest.mark.parametrize("metric", PER_LAYER)
def test_each_metric_counts_its_own_work(manifest, metric):
    """Every reader computes a positive number from its cell's context
    alone, and a kernel's roofline reads nothing where its kernel did not
    run (never a 0)."""
    read = harness.load_metric(metric).read
    v = read(_context(manifest, metric, kernels=True))
    assert v is not None and v > 0
    if "_roofline" in metric:
        assert read(_context(manifest, metric, kernels=False)) is None
