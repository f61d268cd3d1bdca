"""The kNN top-k kernel's share of its bytes bound while serving
8,192-point requests: the k-nearest work of every level of every request
the window served, counted from the algorithm's shapes (layer: graph build;
moves serve_points_per_s.8k)."""
from perfbench import counts
from perfbench.readers import kernel_roofline


def read(ctx):
    k = ctx["cfg"].k_neighbors
    return kernel_roofline(ctx, "knn_topk_kernel", sum(
        counts.knn_bytes(m, k) for r in ctx["requests"] for m in r["levels"]))
