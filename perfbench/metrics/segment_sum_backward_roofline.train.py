"""The segment-sum backward kernel's share of its bytes bound: each
layer's aggregation backward over the whole sample graph a step, without
halo rows or recomputation (layer: segment-sum backward; moves
train_step_s)."""
from perfbench import counts
from perfbench.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "segment_sum_backward_kernel", sum(
        counts.mgn_train_segment_sum_backward_bytes(ctx["cfg"], s["nodes"],
                                                    s["edges"])
        for s in ctx["steps"]))
