"""One run of one cell: set-up, the measured window, the check of the
outputs against the plain reference, the per-layer readers in a traced
run, and the result line.

Everything is found by name. ``BENCHMARK.json`` names a cell, its
configuration (``configs/<config>.json``) and its traffic
(``traffic/<traffic>.json``: the driver, ``drivers/<driver>.py``, the
program's settings, the traffic's parameters and the limits of the check);
a per-layer metric is read by ``metrics/<metric>.py``. A new cell,
configuration, traffic or metric is new files and new manifest entries,
never an edit here.

A driver module defines ``Driver(run)`` with ``setup()``, ``window(seconds)
-> Window``, ``release()``, ``checks() -> [(name, value, limit)]`` and
``layer_context(timeline) -> dict``. The context holds the traced
``timeline``, the program's configuration ``cfg``, the cell's ``spec`` and
the records of the work the window did (each driver's docstring lists
them), so that a metric counts its own operations or bytes from shapes
with ``counts``. A metric module defines ``read(ctx) -> float or None``;
``None`` leaves the metric out of the line.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
MANIFEST = REPO / "BENCHMARK.json"
CACHE = HERE / ".cache"


@dataclass
class Window:
    """What a driver's measured window gives: its end-to-end metrics by
    name, and the requests, steps or passes attempted and failed."""
    metrics: Dict[str, float]
    attempted: int
    failed: int


@dataclass
class Run:
    """One run's inputs, handed to the driver."""
    cell: str
    spec: dict                  # traffic/<traffic>.json
    config: dict                # configs/<config>.json
    seed: int
    device: str = "cuda"
    chips: int = 1
    overrides: dict = field(default_factory=dict)   # tests: smaller sizes
    t0: float = 0.0             # process start, wall clock

    def say(self, msg: str):
        print(f"[perfbench {self.cell} {time.time() - self.t0:8.3f} s] "
              f"{msg}", file=sys.stderr, flush=True)


def cache_env() -> Dict[str, str]:
    """The program's build and kernel caches, at fixed paths inside the
    checkout, so that only a cell's first run in a checkout builds."""
    return {"TORCH_EXTENSIONS_DIR": str(CACHE / "torch_extensions"),
            "TRITON_CACHE_DIR": str(CACHE / "triton"),
            "USE_FLAX": "0"}


def kernel_cache_dir() -> str:
    return str(CACHE / "kernels")


# ------------------------------------------------------------ discovery

def load_manifest(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(name: str, manifest: dict) -> Tuple[dict, dict, dict]:
    """``(manifest entry, spec, configuration)`` of a cell: the spec is the
    traffic's file, ``traffic/<traffic>.json``."""
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {', '.join(sorted(entries))})")
    entry = entries[name]
    spec = _json(HERE / "traffic" / f"{entry['traffic']}.json")
    configs = {c["name"]: c for c in manifest["configs"]}
    config = _json(REPO / configs[entry["config"]]["file"])
    return entry, spec, config


def program_config(config: dict, overrides: Optional[dict] = None):
    """The program's configuration object: the class that the
    configuration's ``program`` key names, built from its ``fields`` (lists
    as tuples) and then ``overrides``."""
    mod, _, cls = config["program"].rpartition(".")
    fields = dict(config["fields"], **(overrides or {}))
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in fields.items()}
    return getattr(importlib.import_module(mod), cls)(**fields)


def load_driver(kind: str):
    return importlib.import_module(f"perfbench.drivers.{kind}")


def load_metric(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(manifest: dict, cell: str, section: str) -> List[dict]:
    """The metrics of ``section`` this cell reports: those that list it,
    and those without a ``workloads`` key that move (per-layer) or are
    (end-to-end) a metric this cell reports."""
    e2e = [m for m in manifest["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if section == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


# ----------------------------------------------------------------- run

def process_start_s() -> Optional[float]:
    """The wall-clock time this process started, from ``/proc``."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return None


def device_info(run: Run) -> dict:
    import torch
    if run.device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": run.chips,
                "memory_peak_bytes": max(
                    torch.cuda.max_memory_allocated(i)
                    for i in range(run.chips))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def judge(checks: List[Tuple[str, float, float]]) -> bool:
    return bool(checks) and all(
        v is not None and not math.isnan(v) and v <= lim
        for _, v, lim in checks)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             manifest: Optional[dict] = None, device: str = "cuda",
             overrides: Optional[dict] = None,
             t_start: Optional[float] = None) -> dict:
    """One run of a cell; returns the result line as a dict."""
    import torch
    manifest = manifest if manifest is not None else load_manifest()
    entry, spec, config = cell_files(name, manifest)
    t_start = t_start if t_start is not None else time.time()
    run = Run(cell=name, spec=spec, config=config, seed=int(seed),
              device=device, chips=int(entry["chips"]),
              overrides=dict(overrides or {}), t0=t_start)
    torch.manual_seed(run.seed % (2 ** 63))
    if device == "cuda":
        torch.cuda.init()
    run.say("torch imported, device ready")
    driver = load_driver(spec["driver"]).Driver(run)
    driver.setup()
    setup_s = time.time() - t_start
    run.say(f"set-up done; window of {seconds} s "
            f"{'traced' if trace else 'untraced'}")
    timeline = None
    if trace:
        from perfbench import tracing
        win, timeline = tracing.capture(
            lambda: driver.window(seconds),
            on_retry=lambda k: run.say(f"profile {k} held no device "
                                       "operation; running the window "
                                       "again"))
    else:
        win = driver.window(seconds)
    dev = device_info(run)
    driver.release()
    ctx = driver.layer_context(timeline) if trace else None
    checks = driver.checks()
    correct = judge(checks) and win.failed == 0
    if trace:
        metrics = {}
        for m in cell_metrics(manifest, name, "per_layer"):
            v = load_metric(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = timeline.busy_s
        dev["window_s"] = timeline.window_s
    else:
        vals = dict(win.metrics, setup_s=setup_s)
        # a cell may report a driver's quantity under a name of its own
        vals.update({alias: vals[q] for alias, q in
                     spec.get("end_to_end", {}).items() if q in vals})
        metrics = {}
        for m in cell_metrics(manifest, name, "end_to_end"):
            if m["name"] not in vals:
                raise KeyError(f"driver {spec['driver']} gives no "
                               f"{m['name']!r} for cell {name}")
            metrics[m["name"]] = {"value": vals[m["name"]],
                                  "unit": m["unit"]}
    out = {"correct": correct, "attempted": win.attempted,
           "failed": win.failed, "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = {"device_ops": timeline.top_ops(10),
                            "idle_gaps": timeline.idle_gaps(10)}
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return out


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from perfbench import isolation
    problems = isolation.check()
    if problems:
        print("\n".join(problems), file=sys.stderr)
        return 3
    manifest = load_manifest()
    entry, _, _ = cell_files(args.workload, manifest)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(entry["chips"]):
        print(f"cell {args.workload} needs {entry['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds,
                   bool(args.trace), manifest=manifest, t_start=t_start)
    problems = isolation.check()
    if problems:
        print("\n".join(problems), file=sys.stderr)
        return 3
    for n, c in out["checks"].items():
        print(f"check {n}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
