"""Share of the window serving 65,536-point requests with no operation on
the card and no serving stage (prepare, dispatch, harvest, publish) open on
any thread (layer: serving engine; moves serve_points_per_s)."""
from perfbench.stage_spans import read  # noqa: F401
