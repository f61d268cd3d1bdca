"""Real-time mesh-free inference: STL-like geometry -> surface pressure.

The port's twin of ``examples/realtime_inference.py``: a raw tessellated
geometry (a triangle soup, what an STL file holds) goes in, a predicted
surface-pressure / wall-shear field comes out. After the one-time bucket
calibration, every request is surface sampling (numpy) and one pass on the
device that builds the multi-scale graph (the kNN kernel, once a level)
and runs the GNN (the segment-sum kernel, once a message-passing layer).

With ``--shard-devices P`` each request is split into P shards (RCB
partitions and halo rings), run one after another on the one device:
equal to the unsharded output on every owned point.

Run:
  PYTHONPATH=src python -m repro_torch.examples.realtime_inference
  PYTHONPATH=src python -m repro_torch.examples.realtime_inference \\
      --shard-devices 4 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.base import GNNConfig
from repro_torch.data import geometry as geo
from repro_torch.launch.serve_gnn import GNNServer

N_POINTS = 1024      # bucket resolution (the paper serves 2M on 8xH100)


def main(argv=None, params=None) -> dict:
    """Serve ``--requests`` cars, then one through the background worker.
    ``params`` (a ``MeshGraphNet``) replaces the weights drawn from the
    seed. Returns ``{"results": [Result, ...], "background": Result}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shard-devices", type=int, default=1,
                    help="split each request into this many shards")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: the card")
    args = ap.parse_args(argv)

    cfg = GNNConfig().reduced()
    server = GNNServer(cfg, (N_POINTS,), max_batch=2, params=params,
                       shard_devices=args.shard_devices, device=args.device)
    mode = (f"sharded x{args.shard_devices}" if args.shard_devices > 1
            else "single-device")

    t0 = time.perf_counter()
    server.warmup()     # one calibration and build per bucket
    print(f"compile+calibrate [{mode}]: "
          f"{time.perf_counter() - t0:.1f}s (one-time)")

    results = []
    for i in range(args.requests):
        verts, faces = geo.car_surface(geo.sample_params(i))  # "read an STL"
        t0 = time.perf_counter()
        [result] = server.serve([(verts, faces, N_POINTS)])
        dt = time.perf_counter() - t0
        cp, tau = result.fields[:, 0], result.fields[:, 1:]
        stag = result.points[np.argmax(cp)]
        print(f"geometry {i}: {len(verts)} verts -> {N_POINTS} pts in "
              f"{dt * 1e3:.0f} ms | cp [{cp.min():+.2f}, {cp.max():+.2f}] "
              f"| stagnation at x={stag[0]:+.2f} "
              f"| mean |tau|={np.linalg.norm(tau, axis=1).mean():.3f}")
        results.append(result)

    rep = server.stats.report()
    print(f"steady state: p50 {rep['p50_ms']:.0f} ms, "
          f"p95 {rep['p95_ms']:.0f} ms, {rep['throughput_rps']:.1f} req/s")

    # background front-end: submit from anywhere, flush on deadline or
    # full batch, collect by request id
    server.start(deadline_s=0.02)
    try:
        verts, faces = geo.car_surface(geo.sample_params(9))
        rid = server.submit(verts, faces, N_POINTS)
        background = server.result(rid, timeout=60.0)
        cp = background.fields[:, 0]
        print(f"background req {rid}: served in "
              f"{background.latency_s * 1e3:.0f} ms (deadline flush) | "
              f"cp [{cp.min():+.2f}, {cp.max():+.2f}]")
    finally:
        server.stop()
    return {"results": results, "background": background}


if __name__ == "__main__":
    main()
