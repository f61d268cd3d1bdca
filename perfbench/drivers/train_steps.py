"""X-MeshGraphNet partitioned training, through the program's step.

Set-up builds the samples with the program's data pipeline
(``repro_torch.data.pipeline``: the cloud, the host multi-scale graph,
partitions with halos, common padding), the model with the benchmark's
weights, Adam as the trainer configures it, and the step of
``repro_torch.launch.train.make_gnn_step_fn``. It then drives that one
object through its first ``check.steps`` steps, each on another sample,
which warms it up and records what the check compares, and hands the same
object to the window. A step stages its sample's partitions with
``prepare_gnn_batch`` and ends when its update has ended on the device.

End-to-end: ``train_step_s``, the window's wall time, to the end of its
last whole step, over the steps.

Check, against the full-graph reference (the paper's equivalence of
partitioned and whole-graph training), over the first steps: the first
step's loss (``loss_gap``, relative), and the worst of the later steps'
(``loss_gap_later``: the first update turns the program's rounding into
gaps that swing from seed to seed, so they have a limit of their own);
the first gradient as Adam got it, read back from its first moment after
one step (``grad_gap``); and the change of the parameters after the last
of them (``update_gap``). The last two take the worst leaf of | norm(program) - norm(reference) | over the
larger of the reference leaf's norm and the median leaf's; leaves whose
reference gradient is under a thousandth of the median leaf's are left out
of the change.
"""
from __future__ import annotations

import time

import numpy as np

from perfbench import geometry, harness
from perfbench.reference import gnn as ref


class Driver:
    def __init__(self, run: harness.Run):
        self.run = run
        self.spec = dict(run.spec["traffic"],
                         **run.overrides.get("traffic", {}))
        self.cfg = harness.program_config(
            run.config, dict(compile_cache_dir=harness.kernel_cache_dir(),
                             **run.overrides.get("config", {})))
        self.opt = dict(run.spec["adam"])
        self.check_spec = run.spec["check"]
        self.n_steps = 0
        self.order = []

    # ------------------------------------------------------------ set-up

    def setup(self):
        import torch
        from repro_torch.ckpt import compile_cache
        from repro_torch.data import pipeline as pipe
        from repro_torch.launch.train import (make_gnn_step_fn,
                                              prepare_gnn_batch)
        from repro_torch.models.meshgraphnet import MeshGraphNet
        from repro_torch.optim.adam import AdamConfig, adam_init
        from perfbench.weights import program_module
        run, cfg = self.run, self.cfg
        self.device = torch.device(run.device)
        compile_cache.enable(cfg.compile_cache_dir)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        ids = self.spec["sample_ids"]
        samples = [pipe.build_sample(cfg, i) for i in ids]
        self.norm_in = pipe.Normalizer.fit([s.node_feats for s in samples])
        self.norm_out = pipe.Normalizer.fit([s.targets for s in samples])
        self.psamples = pipe.partition_samples(cfg, samples, self.norm_in,
                                               self.norm_out)
        # the partitions each sample is stepped in: (real nodes, valid edges)
        self.parts = [[(int(n), int(e)) for n, e in
                       zip(p.padded["node_mask"].sum(1),
                           p.padded["edge_mask"].sum(1))]
                      for p in self.psamples]
        del samples
        run.say("samples built and partitioned")
        self.cycle = list(np.random.default_rng([run.seed, 1]).permutation(
            len(ids)))
        self.weights = ref.init_weights(cfg, run.seed, self.device)
        self.model = program_module(lambda: MeshGraphNet(cfg), self.weights,
                                    self.device)
        self.opt_cfg = AdamConfig(**self.opt)
        self.adam = adam_init([p for _, p in self.model.leaves()])
        self.step_fn = make_gnn_step_fn(cfg, self.opt_cfg)
        self._prepare = prepare_gnn_batch
        self.losses, self.skipped = [], 0
        for i in range(self.check_spec["steps"]):
            self._step()
            if i == 0:
                self.first_mu = {n: m.clone() for (n, _), m in
                                 zip(self.model.leaves(), self.adam.mu)}
        run.say("checked steps taken")
        self.after = {n: p.detach().clone() for n, p in self.model.leaves()}
        self.checked = list(self.order)

    def _step(self):
        """One optimizer step, on the next sample of the cycle, to the end
        of its update."""
        k = self.cycle[self.n_steps % len(self.cycle)]
        stacked, denom = self._prepare(self.psamples[k], self.device)
        self.adam, loss, _, skipped = self.step_fn(self.model, self.adam,
                                                   stacked, denom)
        self.losses.append(float(loss))
        self.skipped += int(skipped)
        self.order.append(k)
        self.n_steps += 1
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ window

    def window(self, seconds: float) -> harness.Window:
        n0, skipped0 = self.n_steps, self.skipped
        self.window_order_from = n0
        t0 = time.perf_counter()
        while True:
            self._step()
            t = time.perf_counter()
            if t - t0 >= seconds:
                break
        n = self.n_steps - n0
        return harness.Window(metrics={"train_step_s": (t - t0) / n},
                              attempted=n, failed=self.skipped - skipped0)

    def release(self):
        import torch
        del self.model, self.adam, self.step_fn
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check

    def _graph(self, sample_id: int) -> dict:
        """The whole sample as the reference sees it: the cloud, targets
        and features made again from the sample's id, the exact multi-scale
        graph, and the normalizers fit over every sample of the cell."""
        import torch
        cfg, dev = self.cfg, self.device
        params = geometry.sample_params(sample_id)
        v, f = geometry.car_surface(params)
        pts, nrm = geometry.sample_surface(
            v, f, max(cfg.levels), np.random.default_rng(sample_id))
        tgt = geometry.surface_fields(pts, nrm, params)
        p = torch.from_numpy(pts).to(dev)
        s, r = ref.multiscale_graph(p, cfg.levels, cfg.k_neighbors)
        return {"points": p, "normals": torch.from_numpy(nrm).to(dev),
                "targets": torch.from_numpy(tgt).to(dev),
                "senders": s, "receivers": r,
                "edge_feats": ref.edge_features(p, s, r)}

    def _normalized(self, graphs):
        import torch
        feats = [ref.node_features(g["points"], g["normals"],
                                   self.cfg.fourier_freqs) for g in graphs]
        out = []
        for stats_of, key in ((feats, "node_feats"),
                              ([g["targets"] for g in graphs], "targets")):
            allx = torch.cat(stats_of).double()
            mean = allx.mean(0)
            std = allx.std(0, unbiased=False) + 1e-8
            out.append([((x.double() - mean) / std).float()
                        for x in stats_of])
        for g, nf, t in zip(graphs, *out):
            g["node_feats"], g["targets"] = nf, t
        return graphs

    def checks(self, control: str = None):
        """The numbers compared, each with its limit. ``control`` puts the
        reference in the program's place: ``"tf32"`` computed in TF32,
        ``"half_batch"`` with the loss of half the nodes, its mean taken
        over them."""
        import torch
        steps = self.check_spec["steps"]
        ids = self.spec["sample_ids"]
        graphs = self._normalized([self._graph(i) for i in ids])
        run = [graphs[k] for k in self.checked[:steps]]
        losses, first, after = ref.train_steps(
            self.weights, self.cfg, run, self.opt)
        b1 = self.opt["b1"]
        if control is None:
            p_losses = self.losses[:steps]
            p_first = {k: m / (1 - b1) for k, m in self.first_mu.items()}
            p_after = self.after
        else:
            p_losses, p_first, p_after = ref.train_steps(
                self.weights, self.cfg, run, self.opt,
                tf32=control == "tf32",
                keep=0.5 if control == "half_batch" else 1.0)
        del graphs, run
        self.detail = {"losses": p_losses, "reference_losses": losses}
        lim = self.check_spec["limits"]
        gaps = [abs(a - b) / abs(b) for a, b in zip(p_losses, losses)]

        def norms(d):
            return {k: float(torch.linalg.vector_norm(v))
                    for k, v in d.items()}

        g_ref, g_prog = norms(first), norms(p_first)
        med_g = float(np.median(list(g_ref.values())))
        grad_gap = max(abs(g_prog[k] - g_ref[k]) / max(g_ref[k], med_g)
                       for k in g_ref)
        kept = [k for k in g_ref if g_ref[k] >= 1e-3 * med_g]
        d_ref = norms({k: after[k] - self.weights[k] for k in kept})
        d_prog = norms({k: p_after[k] - self.weights[k] for k in kept})
        med_d = float(np.median(list(d_ref.values())))
        update_gap = max(abs(d_prog[k] - d_ref[k]) / max(d_ref[k], med_d)
                         for k in kept)
        return [("loss_gap", gaps[0], lim["loss_gap"]),
                ("loss_gap_later", max(gaps[1:], default=0.0),
                 lim["loss_gap_later"]),
                ("grad_gap", grad_gap, lim["grad_gap"]),
                ("update_gap", update_gap, lim["update_gap"])]

    # ------------------------------------------------ per-layer readers

    def layer_context(self, timeline) -> dict:
        """The context of the per-layer readers: ``steps``, one record for
        each step of the traced window (``sample``: its id, ``nodes`` and
        ``edges``: the whole sample graph's nodes and valid directed
        edges, built again by the reference, with no halo; ``partitions``:
        the (real nodes, valid edges) of each partition the program
        stepped, halos included)."""
        import torch
        cfg = self.cfg
        ids = self.spec["sample_ids"]
        steps = self.order[self.window_order_from:]
        edges = {}
        for k in set(steps):
            g = self._graph(ids[k])
            edges[k] = int(g["senders"].numel())
            del g
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return {"timeline": timeline, "cfg": cfg, "spec": self.run.spec,
                "steps": [{"sample": ids[k], "nodes": max(cfg.levels),
                           "edges": edges[k], "partitions": self.parts[k]}
                          for k in steps]}
