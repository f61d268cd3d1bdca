"""The segment-sum kernel's share of its bytes bound while serving
8,192-point requests: each processor layer's aggregation of every request
served, valid edges into real nodes (layer: segment-sum kernel; moves
serve_points_per_s.8k)."""
from perfbench import counts
from perfbench.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "segment_sum_kernel", sum(
        counts.mgn_aggregation_bytes(ctx["cfg"], r["points"], r["edges"])
        for r in ctx["requests"]))
