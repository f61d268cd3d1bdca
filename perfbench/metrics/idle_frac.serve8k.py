"""Share of the window serving 8,192-point requests with no operation on
the card (layer: device; moves serve_points_per_s.8k)."""
from perfbench.readers import idle_fraction as read  # noqa: F401
