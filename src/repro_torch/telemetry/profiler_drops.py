"""Does ``torch.profiler`` hold every launch it profiled, profile after
profile, in one process? On the card only.

    python -m repro_torch.telemetry.profiler_drops [--profiles 300] [--n 10]

Each variant runs in a child process of its own and profiles ``--n``
back-to-back launches ``--profiles`` times: the first half of each call's
launches an add kernel, the second half a multiply kernel, so that a
profile that lost launches says whether it lost the first ones or the last
ones. The variants:

- ``plain``: the launches right after the profile starts;
- ``settle``: one launch of a third kernel and a synchronize first, inside
  the profile, then the launches (``chip_smoke.profiled_rows`` does this);
- ``teardown0``: ``plain`` with ``TEARDOWN_CUPTI=0`` (CUPTI stays
  initialised between traces).

Prints one JSON line per variant: the profiles, those that held fewer
launches than were made, those that held none, and the launches lost from
the first and from the second half.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

VARIANTS = ("plain", "settle", "teardown0")


def probe(variant: str, profiles: int, n: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn((256, 256), device="cuda")
    first, second = n // 2, n - n // 2
    for _ in range(2):
        torch.add(x, 1.0), torch.mul(x, 2.0), torch.exp(x)
    torch.cuda.synchronize()
    short = empty = lost_first = lost_second = 0
    keys = None
    for _ in range(profiles):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if variant == "settle":
                torch.exp(x)
                torch.cuda.synchronize()
            for _ in range(first):
                torch.add(x, 1.0)
            for _ in range(second):
                torch.mul(x, 2.0)
            torch.cuda.synchronize()
        held = {"add": 0, "mul": 0}
        rows = [(e.key, e.count) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        for key, count in rows:
            for op in held:
                if op in key.lower():
                    held[op] += count
        got = held["add"] + held["mul"]
        if keys is None and got < n:
            keys = [(k[:90], c) for k, c in rows]
        short += got < n
        empty += got == 0
        lost_first += first - min(held["add"], first)
        lost_second += second - min(held["mul"], second)
    return dict(variant=variant, profiles=profiles, launches=n,
                short=short, empty=empty, lost_first_half=lost_first,
                lost_second_half=lost_second, first_short_rows=keys)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profiles", type=int, default=300)
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--variant", choices=VARIANTS,
                    help="run this variant in this process")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profiler_drops: needs a CUDA card", file=sys.stderr)
        return 1
    if args.variant:
        print(json.dumps(probe(args.variant, args.profiles, args.n)))
        return 0
    for variant in VARIANTS:
        env = {k: v for k, v in os.environ.items() if k != "TEARDOWN_CUPTI"}
        if variant == "teardown0":
            env["TEARDOWN_CUPTI"] = "0"
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.telemetry.profiler_drops",
             "--variant", variant, "--profiles", str(args.profiles), "--n",
             str(args.n)], env=env, capture_output=True, text=True,
            timeout=900)
        if out.returncode:
            print(out.stderr[-3000:], file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
