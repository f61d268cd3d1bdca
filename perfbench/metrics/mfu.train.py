"""Three times the whole sample graph's forward operations a step (no halo
rows, no recomputation), over the window, in % of the TF32 peak (layer:
training step; moves train_step_s)."""
from perfbench import counts
from perfbench.readers import mfu


def read(ctx):
    return mfu(ctx, sum(3 * counts.mgn_forward_flops(ctx["cfg"], s["nodes"],
                                                     s["edges"])
                        for s in ctx["steps"]))
