"""Useful MeshGraphNet operations of every 8,192-point request served in
the window (valid nodes and edges only) over the window, in % of the TF32
peak (layer: MeshGraphNet forward; moves serve_points_per_s.8k)."""
from perfbench import counts
from perfbench.readers import mfu


def read(ctx):
    return mfu(ctx, sum(counts.mgn_forward_flops(ctx["cfg"], r["points"],
                                                 r["edges"])
                        for r in ctx["requests"]))
