"""The segment-sum kernel's share of its bytes bound in training: each
layer's aggregation and its gathers' backward over the whole sample graph
a step, without halo rows or recomputation (layer: segment-sum kernel;
moves train_step_s)."""
from perfbench import counts
from perfbench.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "segment_sum_kernel", sum(
        counts.mgn_train_segment_sum_bytes(ctx["cfg"], s["nodes"], s["edges"])
        for s in ctx["steps"]))
