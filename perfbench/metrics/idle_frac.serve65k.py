"""Share of the window serving 65,536-point requests with no operation on
the card (layer: device; moves serve_points_per_s)."""
from perfbench.readers import idle_fraction as read  # noqa: F401
