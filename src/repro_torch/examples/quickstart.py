"""Quickstart: train X-MeshGraphNet on synthetic car aerodynamics.

The port's twin of ``examples/quickstart.py``: builds multi-scale k-NN
graphs from parametric car geometries (no simulation mesh), partitions
them with halo regions, trains with gradient aggregation, and reports the
paper's Table-I-style relative errors on held-out cars.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config
from repro_torch.launch.train import eval_gnn, train_gnn


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--samples", type=int, default=8,
                    help="synthetic cars, split into training and test")
    ap.add_argument("--ckpt", default="build/xmgn_quickstart.msgpack",
                    help="checkpoint written after the last step ('' for "
                    "none)")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: the card")
    args = ap.parse_args(argv)

    cfg = get_config("xmgn-drivaer").reduced()
    print(f"config: {cfg.levels} points/level, k={cfg.k_neighbors}, "
          f"{cfg.n_mp_layers} MP layers, {cfg.n_partitions} partitions, "
          f"halo={cfg.halo}")
    model, losses, (train, test, ni, no) = train_gnn(
        cfg, steps=args.steps, n_samples=args.samples,
        ckpt_path=args.ckpt or None, device=args.device)
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f}")
    metrics = eval_gnn(cfg, model, test, ni, no)
    print(json.dumps(metrics, indent=2))
    return {"losses": losses, "metrics": metrics}


if __name__ == "__main__":
    main()
