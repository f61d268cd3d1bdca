"""X-UNet3D inference over the paper's whole grid, through the program's
halo partitioning.

Set-up builds ``repro_torch.models.xunet3d.XUNet3D`` with the benchmark's
weights and draws the cell's input volumes from the seed on the card
(a dense convolution's time does not depend on the values), then keeps
them in host memory, where the program expects them, and warms one pass.
The window runs back-to-back passes, cycling the inputs, each
``core.unet_halo.apply_partitioned`` over ``n_partitions`` slabs with the
configuration's halo, every slab copied to the card inside the pass, and
ends each pass when its stitched output is on the card.

End-to-end: ``volume_pass_s``, the window's wall time, to the end of its
last whole pass, over the passes.

Check: a sample of the passes, drawn from the seed, against the
reference's forward over the whole grid in blocks of its own layout
(``fields_err``: the largest absolute difference over the largest absolute
reference value).
"""
from __future__ import annotations

import math
import time

import numpy as np

from perfbench import harness
from perfbench.reference import unet as ref


class Driver:
    def __init__(self, run: harness.Run):
        self.run = run
        self.traffic = dict(run.spec["traffic"],
                            **run.overrides.get("traffic", {}))
        self.cfg = harness.program_config(run.config,
                                          run.overrides.get("config", {}))
        self.check_spec = dict(run.spec["check"],
                               **run.overrides.get("check", {}))
        self.outputs = []

    def setup(self):
        import torch
        from repro_torch.core import unet_halo
        from repro_torch.models import xunet3d
        from perfbench.weights import program_module
        run, cfg = self.run, self.cfg
        self.device = dev = torch.device(run.device)
        xunet3d.full_f32(dev)
        self.weights = ref.init_weights(cfg, run.seed, dev)
        self.model = program_module(lambda: xunet3d.XUNet3D(cfg),
                                    self.weights, dev)
        gen = torch.Generator(device=dev).manual_seed(run.seed)
        shape = (1,) + tuple(cfg.grid) + (cfg.in_channels,)
        self.inputs = [torch.randn(shape, generator=gen, device=dev).cpu()
                       for _ in range(self.traffic["inputs"])]
        self._partitioned = unet_halo.apply_partitioned
        run.say("weights and inputs made")
        self._pass(0)
        self.outputs = []

    def _pass(self, i: int):
        """One pass over input ``i % inputs``, to the end of its output."""
        import torch
        dev = self.device
        with torch.no_grad():
            out = self._partitioned(
                lambda s: self.model.apply(s.to(dev)),
                self.inputs[i % len(self.inputs)], self.cfg.n_partitions,
                self.cfg.halo, axis=1, align=self.traffic["align"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.outputs.append(out)

    def window(self, seconds: float) -> harness.Window:
        t0 = time.perf_counter()
        n = 0
        while True:
            self._pass(n)
            n += 1
            t = time.perf_counter()
            if t - t0 >= seconds:
                break
        self.passes = n
        return harness.Window(metrics={"volume_pass_s": (t - t0) / n},
                              attempted=n, failed=0)

    def release(self):
        import torch
        del self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def checks(self, control: str = None):
        """The numbers compared, each with its limit. ``control="tf32"``
        puts the reference, computed in TF32, in the program's place."""
        import torch
        rng = np.random.default_rng([self.run.seed, 2])
        n = len(self.outputs)
        pick = sorted(rng.choice(n, min(self.check_spec["sample"], n),
                                 replace=False))
        err = 0.0
        for k in sorted({i % len(self.inputs) for i in pick}):
            y = ref.volume_fields(
                self.weights, self.cfg, self.inputs[k],
                block=self.check_spec["block"],
                halo=self.check_spec["halo"], device=self.device)
            got = [self.outputs[i] for i in pick
                   if i % len(self.inputs) == k]
            if control == "tf32":
                got = [ref.volume_fields(
                    self.weights, self.cfg, self.inputs[k],
                    block=self.check_spec["block"],
                    halo=self.check_spec["halo"], tf32=True,
                    device=self.device)]
            scale = float(y.abs().max())
            err = max([err] + [float((g - y).abs().max()) / scale
                               for g in got])
            del y, got
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
        return [("fields_err", err if pick else math.nan,
                 self.check_spec["limits"]["fields_err"])]

    def layer_context(self, timeline) -> dict:
        """The context of the per-layer readers: ``passes``, the whole
        passes of the traced window, each over ``cfg.grid``."""
        return {"timeline": timeline, "cfg": self.cfg, "spec": self.run.spec,
                "passes": self.passes}
