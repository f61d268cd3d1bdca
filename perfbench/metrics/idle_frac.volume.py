"""Share of the X-UNet3D window with no operation on the card (layer:
device; moves volume_pass_s)."""
from perfbench.readers import idle_fraction as read  # noqa: F401
