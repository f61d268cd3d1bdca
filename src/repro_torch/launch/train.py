"""Training driver for X-MeshGraphNet on PyTorch, on one device.

Port of the GNN path of ``repro.launch.train`` with ``mesh=None``:
partitioned training with halo regions and gradient aggregation on
synthetic DrivAerML-proxy data (paper SIII-A). Each step stages one sample's
stacked (P, ...) partition batch on the device and runs forward and backward
partition by partition, each partition's loss divided by the sample's
global denominator, so that autograd's summed gradients are the full-graph
gradients. Then the gradients are clipped to global norm 32 and Adam takes
one step with a cosine learning rate; a step whose loss or any gradient is
not finite is skipped, parameters and Adam state untouched.

On the card the processor's aggregation runs the segment-sum kernel forward
and its hand-written backward kernel; with ``cfg.remat`` each
message-passing layer runs forward twice (once more in the backward pass).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch xmgn-drivaer \
      --reduced --steps 3 --samples 3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch xmgn-drivaer \
      --reduced --steps 100 --samples 8
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import GNNConfig
from repro_torch.core.gradient_aggregation import aggregate_gradients
from repro_torch.data import pipeline as pipe
from repro_torch.device import resolve
from repro_torch.models import meshgraphnet
from repro_torch.models.meshgraphnet import MeshGraphNet, loss_fn
from repro_torch.optim.adam import AdamConfig, adam_init, adam_update


def make_gnn_step_fn(cfg: GNNConfig, opt_cfg: AdamConfig):
    """One optimizer step over a stacked (P, ...) partition batch.

    Returns ``step(model, opt, stacked, denom) -> (opt, loss, grad_norm,
    skipped)``: the model's parameters are updated in place and the new Adam
    state returned. ``stacked`` and ``denom`` come from
    :func:`prepare_gnn_batch`, on the model's device.

    Nonfinite guard (``cfg.nonfinite_guard``, default on): when the loss
    or any gradient is NaN/Inf the update is SKIPPED: the parameters and
    the Adam state stay as they were, bit for bit, and ``skipped`` is True.
    """
    guard = bool(cfg.nonfinite_guard)

    def step_fn(model: MeshGraphNet, opt, stacked: dict, denom):
        n_parts = stacked["senders"].shape[0]
        batches = ({k: v[p] for k, v in stacked.items()}
                   for p in range(n_parts))
        loss = aggregate_gradients(lambda m, b: loss_fn(m, b, denom), model,
                                   batches)
        params = [p for _, p in model.leaves()]
        grads = [p.grad for p in params]
        new_params, new_opt, metrics = adam_update(opt_cfg, grads, opt,
                                                   params)
        skipped = False
        if guard:
            finite = torch.isfinite(loss) & torch.stack(
                [torch.isfinite(g).all() for g in grads]).all()
            skipped = not bool(finite)
        if not skipped:
            with torch.no_grad():
                for p, new in zip(params, new_params):
                    p.copy_(new)
            opt = new_opt
        return opt, loss, metrics["grad_norm"], skipped
    return step_fn


def prepare_gnn_batch(ps: pipe.PartitionedSample, device):
    """One partitioned sample on ``device``: ``(stacked, denom)``, the
    stacked (P, ...) arrays as tensors and the loss denominator as an f32
    scalar."""
    dev = torch.device(device)
    stacked = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
               for k, v in ps.stacked.items()}
    return stacked, torch.tensor(ps.denom, dtype=torch.float32, device=dev)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_gnn(cfg: GNNConfig, steps: int, n_samples: int,
              log_every: int = 10, opt_total_steps: Optional[int] = None,
              noise_std: Optional[float] = None, device=None,
              stage_seconds: Optional[dict] = None):
    """Train X-MeshGraphNet on partitioned synthetic DrivAerML-proxy data,
    on ``device`` (default: the card).

    ``opt_total_steps`` is the cosine-schedule horizon (default ``steps``).
    ``noise_std`` (default ``cfg.noise_std``; 0 = off) adds MGN-style
    training noise to the node features each step, drawn on the host from
    ``np.random.default_rng((0xF10A7, it))`` for global step ``it``, as the
    JAX trainer draws it. Weights come from ``torch.Generator`` seed 0.

    ``stage_seconds``, when given a dict, receives the wall seconds of the
    stages: ``data`` and ``partition`` (host), and per step ``prepare``
    (staging on the device) and ``step`` (to the end of the update).

    Returns ``(model, losses, (train, test, norm_in, norm_out))``.
    """
    dev = resolve(device)
    times = stage_seconds if stage_seconds is not None else {}
    times.update(prepare=[], step=[])
    t0 = time.perf_counter()
    train, test, norm_in, norm_out = pipe.build_dataset(cfg, n_samples)
    times["data"] = time.perf_counter() - t0
    # one partitioning pass per sample + common padding: one shape for all
    t0 = time.perf_counter()
    psamples = pipe.partition_samples(cfg, train, norm_in, norm_out)
    times["partition"] = time.perf_counter() - t0

    model = meshgraphnet.init(torch.Generator().manual_seed(0), cfg,
                              device=dev)
    opt_cfg = AdamConfig(total_steps=int(opt_total_steps or steps))
    opt = adam_init([p for _, p in model.leaves()])
    step_fn = make_gnn_step_fn(cfg, opt_cfg)
    if noise_std is None:
        noise_std = float(cfg.noise_std)
    nonfinite_steps = 0
    losses = []
    for it in range(steps):
        # stage one sample per step: at paper scale a padded partition
        # batch is GBs, so only the current one lives on the device
        _sync(dev)
        t0 = time.perf_counter()
        ps = psamples[it % len(psamples)]
        stacked, denom = prepare_gnn_batch(ps, dev)
        if noise_std > 0.0:
            # MGN rollout-stability noise, seeded by the global step
            nf = ps.stacked["node_feats"]
            nrng = np.random.default_rng((0xF10A7, it))
            stacked["node_feats"] = torch.from_numpy(
                nf + nrng.standard_normal(nf.shape).astype(nf.dtype)
                * noise_std).to(dev)
        _sync(dev)
        t1 = time.perf_counter()
        opt, loss, gnorm, skipped = step_fn(model, opt, stacked, denom)
        losses.append(float(loss))
        _sync(dev)
        t2 = time.perf_counter()
        times["prepare"].append(t1 - t0)
        times["step"].append(t2 - t1)
        if skipped:
            nonfinite_steps += 1
            print(f"step {it:5d} SKIPPED: nonfinite loss/grads (loss "
                  f"{losses[-1]}, {nonfinite_steps} skipped so far) - params "
                  "and Adam state unchanged", flush=True)
        if it % log_every == 0:
            # warm s/step excludes the first step (allocator and library
            # warm-up)
            warm = times["step"][1:]
            timing = (f"first {times['step'][0]:.2f}s" if not warm else
                      f"{sum(warm) / len(warm):.2f}s/step warm, first "
                      f"{times['step'][0]:.2f}s")
            print(f"step {it:5d} loss {losses[-1]:.5f} gnorm "
                  f"{float(gnorm):.3f} ({timing})", flush=True)
    return model, losses, (train, test, norm_in, norm_out)


def predict_gnn(cfg: GNNConfig, model: MeshGraphNet, samples, norm_in,
                norm_out):
    """Denormalized full-cloud predictions on the model's device.

    Samples are partitioned with common padding (``partition_samples``);
    each partition runs forward on its own, and owned-node predictions are
    reassembled in global order and decoded with ``norm_out``.
    """
    psamples = pipe.partition_samples(cfg, samples, norm_in, norm_out)
    dev = next(model.parameters()).device
    keys = ("node_feats", "edge_feats", "senders", "receivers", "edge_mask")
    preds = []
    with torch.no_grad():
        for s, ps in zip(samples, psamples):
            b = {k: torch.from_numpy(ps.stacked[k]).to(dev) for k in keys}
            preds_p = np.stack([
                model.apply(b["node_feats"][p], b["edge_feats"][p],
                            b["senders"][p], b["receivers"][p],
                            edge_mask=b["edge_mask"][p]).cpu().numpy()
                for p in range(b["senders"].shape[0])])
            pred = np.zeros((s.graph.n_nodes, cfg.node_out), np.float32)
            nodes = np.asarray(ps.padded["nodes_global"])
            owned = np.asarray(ps.padded["owned_mask"]) > 0
            pred[nodes[owned]] = preds_p[owned]
            preds.append(norm_out.decode(pred))
    return preds


def eval_gnn(cfg: GNNConfig, model: MeshGraphNet, samples, norm_in,
             norm_out) -> dict:
    """Paper Table I metrics on denormalized predictions."""
    errs = {"pressure": [[], []], "tau_x": [[], []], "tau_y": [[], []],
            "tau_z": [[], []]}
    names = list(errs)
    forces_true, forces_pred = [], []
    preds = predict_gnn(cfg, model, samples, norm_in, norm_out)
    for s, pred in zip(samples, preds):
        true = s.targets
        for i, nm in enumerate(names):
            num = np.linalg.norm(pred[:, i] - true[:, i])
            den = np.linalg.norm(true[:, i]) + 1e-12
            errs[nm][0].append(num / den)
            errs[nm][1].append(np.abs(pred[:, i] - true[:, i]).sum()
                               / (np.abs(true[:, i]).sum() + 1e-12))
        n = s.graph.normals
        f_true = ((-true[:, :1] * n + true[:, 1:]).mean(0) @ [1, 0, 0])
        f_pred = ((-pred[:, :1] * n + pred[:, 1:]).mean(0) @ [1, 0, 0])
        forces_true.append(f_true)
        forces_pred.append(f_pred)
    out = {nm: {"rel_l2": float(np.mean(v[0])),
                "rel_l1": float(np.mean(v[1]))}
           for nm, v in errs.items()}
    ft, fp = np.asarray(forces_true), np.asarray(forces_pred)
    ss_res = np.sum((ft - fp) ** 2)
    ss_tot = np.sum((ft - ft.mean()) ** 2) + 1e-12
    out["force_r2"] = float(1.0 - ss_res / ss_tot)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True,
                    help="xmgn-drivaer (LLM training is still to port)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--samples", type=int, default=6)
    ap.add_argument("--total-steps", type=int, default=None,
                    help="cosine-schedule horizon when it differs from "
                    "--steps")
    ap.add_argument("--noise-std", type=float, default=None,
                    help="MGN-style training noise: gaussian std added to "
                    "node features each step for rollout stability "
                    "(default: cfg.noise_std, i.e. off)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if not isinstance(cfg, GNNConfig):
        raise SystemExit(f"the port trains the GNN only; {args.arch!r} "
                         "(LLM training) is still to port, see ROADMAP.md")
    if args.reduced:
        cfg = cfg.reduced()
    model, losses, (train, test, ni, no) = train_gnn(
        cfg, args.steps, args.samples, opt_total_steps=args.total_steps,
        noise_std=args.noise_std, device=args.device)
    metrics = eval_gnn(cfg, model, test, ni, no)
    print(json.dumps(metrics, indent=2))


if __name__ == "__main__":
    main()
