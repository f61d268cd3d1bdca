"""The readings that the limits of ``correct`` are set from.

  python perfbench/controls.py --workload <cell> --seeds 11,12,13 \
      --seconds 8 [--controls tf32,half_batch] [--out <file>]

For each seed, in one process: the cell's set-up, a window of ``--seconds``
at the cell's own load and size, and its check, once as the benchmark runs
it (the program's reading) and once for each control, the reference put in
the program's place (``tf32``: computed in TF32, the precision below the
configuration's f32; ``half_batch``: training on half the nodes, the mean
taken over them). One JSON line per seed and reading. The benchmark's own
runs never run a control.
"""
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
for p in (str(HERE.parent / "src"), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import harness  # noqa: E402


def readings(cell: str, seeds, seconds: float, controls, *,
             device: str = "cuda", overrides=None, manifest=None):
    """Yield ``{"seed", "reading", "checks"}`` for each seed: the program's
    reading first, then each control's."""
    import torch
    manifest = manifest if manifest is not None else harness.load_manifest()
    entry, spec, config = harness.cell_files(cell, manifest)
    for seed in seeds:
        run = harness.Run(cell=cell, spec=spec, config=config,
                          seed=int(seed), device=device,
                          chips=int(entry["chips"]),
                          overrides=dict(overrides or {}))
        torch.manual_seed(run.seed % (2 ** 63))
        driver = harness.load_driver(spec["driver"]).Driver(run)
        t0 = time.time()
        driver.setup()
        win = driver.window(seconds)
        driver.release()
        for c in [None] + list(controls):
            t1 = time.time()
            yield {"cell": cell, "seed": int(seed),
                   "reading": c or "program", "attempted": win.attempted,
                   "failed": win.failed,
                   "checks": {n: v for n, v, _ in driver.checks(c)},
                   "detail": getattr(driver, "detail", None),
                   "seconds": time.time() - (t0 if c is None else t1)}
        del driver
        if device == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    import argparse
    import os
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--controls", default="tf32")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    os.environ.update(harness.cache_env())
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = [c for c in args.controls.split(",") if c]
    out = open(args.out, "a") if args.out else None
    try:
        for line in readings(args.workload, seeds, args.seconds, controls):
            text = json.dumps(line)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
