"""GNN serving under a closed loop of clients, through the program's server.

Set-up builds ``repro_torch.launch.serve_gnn.GNNServer`` with the
benchmark's weights and the cell's ``server`` settings (every other knob
at the server's default), warms its buckets and starts its background
worker. The traffic is a pool of dense car surfaces, every request at the
cell's point count; each client submits its next geometry as soon as its
previous result returns, cycling the pool in an order drawn from the seed.

The window admits requests for ``seconds`` and lasts until the last of
them has returned. End-to-end: ``serve_points_per_s``, the points of every
request it admitted over its length (so a batch that is half done when
admission closes is neither lost nor counted whole); ``serve_latency_p95_s``,
the 95th
percentile (nearest rank) of the client's submit-to-result time over every
request it admitted, a failed request counting as infinitely late.

Check: a sample of the completed requests, drawn from the seed. For each,
the reference samples the cloud again from the geometry and the server's
documented key ``(server seed, request id + 1)`` (``points_mismatch``:
values that differ, exact), builds the graph, the features and the
forward, and compares the served fields (``fields_err``: the largest
absolute difference over the largest absolute reference value; where an
exact f32 tie makes two neighbour sets right, the nearer of their
references).
"""
from __future__ import annotations

import math
import threading
import time
from typing import List

import numpy as np

from perfbench import geometry, harness
from perfbench.reference import gnn as ref


def level_sizes(n: int, n_levels: int):
    return tuple(n // 2 ** (n_levels - 1 - i) for i in range(n_levels))


def p95(values: List[float]) -> float:
    """Nearest-rank 95th percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


class Driver:
    def __init__(self, run: harness.Run):
        self.run = run
        t = dict(run.spec["traffic"], **run.overrides.get("traffic", {}))
        self.traffic = t
        self.server_kw = dict(run.spec["server"],
                              **run.overrides.get("server", {}))
        self.cfg = harness.program_config(
            run.config, dict(compile_cache_dir=harness.kernel_cache_dir(),
                             **run.overrides.get("config", {})))
        self.check_spec = run.spec["check"]
        self.records = []

    # ------------------------------------------------------------ set-up

    def setup(self):
        import torch
        from repro_torch.launch.serve_gnn import GNNServer
        from repro_torch.models.meshgraphnet import MeshGraphNet
        from perfbench.weights import program_module
        run, t = self.run, self.traffic
        run.say("program imported")
        self.device = torch.device(run.device)
        self.weights = ref.init_weights(self.cfg, run.seed, self.device)
        model = program_module(lambda: MeshGraphNet(self.cfg), self.weights,
                               self.device)
        run.say("weights on the card")
        self.pool = [geometry.car_surface(geometry.sample_params(i),
                                          nu=t["nu"], nv=t["nv"])
                     for i in range(t["cars"])]
        rng = np.random.default_rng([run.seed, 1])
        self.orders = [rng.permutation(t["cars"])
                       for _ in range(t["clients"])]
        kw = dict(self.server_kw)
        buckets = kw.pop("bucket_sizes")
        run.say("cars built")
        self.server = GNNServer(self.cfg, buckets, params=model,
                                seed=run.seed, device=self.device, **kw)
        run.say("server built")
        self.server.warmup()
        self.server.start()
        run.say("server warmed")

    # ------------------------------------------------------------ window

    def _client(self, c: int, t_end: float, out: list):
        srv, n = self.server, self.traffic["points"]
        order = self.orders[c]
        i = 0
        while time.perf_counter() < t_end:
            car = int(order[i % len(order)])
            i += 1
            v, f = self.pool[car]
            t0 = time.perf_counter()
            try:
                rid = srv.submit(v, f, n)
                res = srv.result(rid, timeout=self.traffic["timeout_s"])
                err = res.error
            except Exception as e:          # the request never came back
                rid, res, err = None, None, repr(e)
            out.append((car, rid, t0, time.perf_counter(), res, err))

    def window(self, seconds: float) -> harness.Window:
        self.server.stats.reset()
        t_start = time.perf_counter()
        t_end = t_start + seconds
        outs = [[] for _ in range(self.traffic["clients"])]
        threads = [threading.Thread(target=self._client, args=(c, t_end, o))
                   for c, o in enumerate(outs)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        self.records = [r for o in outs for r in o]
        done = [r for r in self.records if r[5] is None]
        points = sum(r[4].fields.shape[0] for r in done)
        t_last = max((r[3] for r in self.records), default=t_end)
        lat = [r[3] - r[2] if r[5] is None else math.inf
               for r in self.records]
        failed = len(self.records) - len(done)
        return harness.Window(
            metrics={"serve_points_per_s": points / (t_last - t_start),
                     "serve_latency_p95_s": p95(lat) if lat else math.inf},
            attempted=len(self.records), failed=failed)

    def release(self):
        import torch
        st = self.server.stats.stage_report().get("prepare", {})
        self.prepare_s = st.get("total_s")
        self.server.stop()
        del self.server
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check

    def _reference_cloud(self, car: int, rid: int):
        v, f = self.pool[car]
        rng = np.random.default_rng((self.run.seed, rid + 1))
        return geometry.sample_surface(v, f, self.traffic["points"], rng)

    def checks(self, control: str = None):
        """The numbers compared, each with its limit. ``control="tf32"``
        puts the reference, computed in TF32, in the program's place."""
        import torch
        done = [r for r in self.records if r[5] is None]
        rng = np.random.default_rng([self.run.seed, 2])
        k = min(self.check_spec["sample"], len(done))
        pick = [done[i] for i in sorted(rng.choice(len(done), k,
                                                   replace=False))]
        n = self.traffic["points"]
        levels = level_sizes(n, self.server_kw.get("n_levels", 3))
        mismatch, err = 0, 0.0
        for car, rid, _, _, res, _ in pick:
            pts, nrm = self._reference_cloud(car, rid)
            mismatch += int((res.points != pts).sum())
            p, q = (torch.from_numpy(a).to(self.device) for a in (pts, nrm))
            ys = [y.cpu().numpy() for y in
                  ref.serve_fields(self.weights, self.cfg, p, q, levels)]
            got = res.fields
            if control == "tf32":
                ys = ys[:1]
                got = next(ref.serve_fields(self.weights, self.cfg, p, q,
                                            levels, tf32=True)).cpu().numpy()
            err = max(err, min(float(np.abs(got - y).max() / np.abs(y).max())
                               for y in ys))
        lim = self.check_spec["limits"]
        return [("points_mismatch", float(mismatch),
                 lim["points_mismatch"]),
                ("fields_err", err if pick else math.nan, lim["fields_err"])]

    # ------------------------------------------------ per-layer readers

    def layer_context(self, timeline) -> dict:
        """The context of the per-layer readers: ``requests``, one record
        for each request the traced window completed (``car``, ``rid``,
        ``points`` served, the nested ``levels``, ``edges``: the valid
        directed edges of its graph, built again by the reference, and
        ``cloud``: its points, sampled again), and ``prepare_s``, the
        server's prepare stage over the window."""
        import torch
        cfg, n = self.cfg, self.traffic["points"]
        levels = level_sizes(n, self.server_kw.get("n_levels", 3))
        requests = []
        for car, rid, _, _, res, err in self.records:
            if err is not None:
                continue
            pts, _ = self._reference_cloud(car, rid)
            s, _ = ref.multiscale_graph(torch.from_numpy(pts).to(self.device),
                                        levels, cfg.k_neighbors)
            requests.append({"car": car, "rid": rid,
                             "points": int(res.fields.shape[0]),
                             "levels": levels, "edges": int(s.numel()),
                             "cloud": pts})
        return {"timeline": timeline, "cfg": cfg, "spec": self.run.spec,
                "requests": requests, "prepare_s": self.prepare_s}
