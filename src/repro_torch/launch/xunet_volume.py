"""X-UNet3D (paper SVI) on PyTorch: halo-partitioned volumetric prediction.

The port's twin of the JAX package's ``examples/xunet_volume.py``: trains
the reduced 3D UNet with attention gates for 30 Adam steps on the analytic
volume-flow proxy (MSE plus the continuity term, weight 0.05), then runs
inference both on the full domain and partitioned into halo-extended slabs,
and prints how far the two outputs are apart while each slab touches only
a fraction of the domain. Runs on the card unless ``--device cpu``.

Run:  PYTHONPATH=src python -m repro_torch.launch.xunet_volume [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import UNetConfig
from repro_torch.core import unet_halo
from repro_torch.data import geometry as geo
from repro_torch.device import resolve
from repro_torch.models import xunet3d
from repro_torch.optim.adam import AdamConfig, adam_init, adam_update

CONTINUITY_WEIGHT = 0.05
STEPS = 30
OPT = AdamConfig(lr_max=1.5e-4, lr_min=5e-7, total_steps=STEPS)


def make_features(cfg: UNetConfig, sample_id: int):
    """The voxel grid of ``cfg.grid`` around car ``sample_id`` (numpy, as
    the JAX example builds it): ``(points (n, 3) f64, features (n,
    in_channels) f32)``, n = X * Y * Z in C order (X slowest)."""
    params = geo.sample_params(sample_id)
    xs = [np.linspace(-3.5, 8.5, cfg.grid[0]),
          np.linspace(-2.25, 2.25, cfg.grid[1]),
          np.linspace(-0.32, 3.04, cfg.grid[2])]
    pts = np.stack(np.meshgrid(*xs, indexing="ij"), -1).reshape(-1, 3)
    sdf = geo.signed_distance_box(pts, params)
    feats = np.concatenate([pts, np.sin(np.pi * pts), np.cos(np.pi * pts),
                            np.sin(2 * np.pi * pts), sdf[:, None],
                            np.zeros((len(pts), 3))], 1).astype(np.float32)
    return pts, feats


def make_batch(cfg: UNetConfig, sample_id: int, device=None) -> dict:
    """``{"inputs": (1, X, Y, Z, in_channels), "targets": (1, X, Y, Z,
    out_channels)}`` on ``device`` (default: the card): the example's
    features and the ``volume_fields`` proxy as targets."""
    pts, feats = make_features(cfg, sample_id)
    targets = geo.volume_fields(pts, geo.sample_params(sample_id))
    shape = (1, *cfg.grid)
    dev = resolve(device)
    return {"inputs": torch.from_numpy(feats.reshape(
                *shape, cfg.in_channels)).to(dev),
            "targets": torch.from_numpy(targets.reshape(
                *shape, cfg.out_channels)).to(dev)}


def make_step_fn():
    """``step(model, opt, batch) -> (opt, loss)``: the loss with the
    continuity term (``CONTINUITY_WEIGHT``) and its gradients, then one
    Adam step (``OPT``, the JAX example's: clip at global norm 32, cosine
    LR); the parameters are updated in place."""
    def step(model: xunet3d.XUNet3D, opt, batch):
        params = [p for _, p in model.leaves()]
        for p in params:
            p.grad = None
        loss = xunet3d.train_loss(model, batch, CONTINUITY_WEIGHT)
        loss.backward()
        new_params, opt, _ = adam_update(OPT, [p.grad for p in params], opt,
                                         params)
        with torch.no_grad():
            for p, new in zip(params, new_params):
                p.copy_(new)
        return opt, loss.detach()
    return step


def train(model: xunet3d.XUNet3D, batches: Sequence[dict], steps: int = STEPS,
          log_every: int = 10) -> List[float]:
    """The example's loop: step ``it`` trains on ``batches[it % len]``.
    Returns the losses."""
    step = make_step_fn()
    opt = adam_init([p for _, p in model.leaves()])
    losses = []
    for it in range(steps):
        opt, loss = step(model, opt, batches[it % len(batches)])
        losses.append(float(loss))
        if log_every and it % log_every == 0:
            print(f"step {it}: loss {losses[-1]:.5f}")
    return losses


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = get_config("xunet3d-drivaer").reduced()
    dev = resolve(args.device)
    model = xunet3d.init(torch.Generator().manual_seed(0), cfg, device=dev)
    batches = [make_batch(cfg, i, dev) for i in range(3)]
    t0 = time.perf_counter()
    train(model, batches)
    print(f"{STEPS} steps on {dev} in {time.perf_counter() - t0:.2f}s")

    x = batches[0]["inputs"]
    with torch.no_grad():
        full = model.apply(x)
        align = 2 ** (cfg.depth - 1)
        rf = xunet3d.receptive_field(cfg)
        halo = -(-rf // align) * align
        part = unet_halo.apply_partitioned(model.apply, x, cfg.n_partitions,
                                           halo, axis=1, align=align)
    print(f"receptive field={rf} voxels -> halo={halo}; "
          f"partitioned-vs-full max diff: "
          f"{float(torch.max(torch.abs(part - full))):.2e}")


if __name__ == "__main__":
    main()
