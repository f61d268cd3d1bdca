"""Render the dry run's markdown tables from its records.

Port of ``repro.launch.report``, reading the port's records
(``launch.dryrun``; per device: memory in bytes, roofline terms in seconds
at the card's constants, collective bytes):

  PYTHONPATH=src python -m repro_torch.launch.report \\
      [--dirs results/dryrun_torch_sp ...]
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def fmt_bytes(b):
    return f"{b / 2**30:.2f}GiB" if b >= 2**30 else f"{b / 2**20:.1f}MiB"


def rows_of(d):
    out = []
    for f in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(f) as fh:
            out.append(json.load(fh))
    return out


def render(dirs):
    for d in dirs:
        rows = rows_of(d)
        if not rows:
            continue
        print(f"\n### {d}\n")
        print("| arch | shape | mesh | fits (arg+tmp/dev) | t_compute | "
              "t_memory | t_collective | dominant | useful | coll GB/dev |")
        print("|---|---|---|---|---|---|---|---|---|---|")
        for r in rows:
            if "skipped" in r:
                print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — |"
                      f" — | — | SKIP (full attention, documented) | — | — |")
                continue
            if "error" in r:
                print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | ERROR: "
                      f"{r['error'][:60]} | | | | | | |")
                continue
            m = r["memory"]
            rl = r["roofline"]
            fits = m["argument_bytes"] + m["temp_bytes"]
            print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                  f"{fmt_bytes(fits)} | {rl['t_compute_s']:.2e} | "
                  f"{rl['t_memory_s']:.2e} | {rl['t_collective_s']:.2e} | "
                  f"{rl['dominant']} | {r['useful_flops_ratio']:.3f} | "
                  f"{r['per_device']['collective_bytes'] / 2**30:.2f} |")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dirs", nargs="*",
                    default=["results/dryrun_torch_sp",
                             "results/dryrun_torch_mp"])
    args = ap.parse_args(argv)
    render(args.dirs)


if __name__ == "__main__":
    main()
