"""Share of the training window with no operation on the card (layer:
device; moves train_step_s)."""
from perfbench.readers import idle_fraction as read  # noqa: F401
