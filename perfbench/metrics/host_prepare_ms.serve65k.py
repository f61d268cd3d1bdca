"""The server's host prepare stage (sampling each cloud, the overflow
guard) a request served while serving 65,536-point requests: its stage
seconds summed over the window, over the requests served, in ms (layer:
serving engine; moves serve_points_per_s)."""


def read(ctx):
    if ctx.get("prepare_s") is None or not ctx["requests"]:
        return None
    return 1e3 * ctx["prepare_s"] / len(ctx["requests"])
