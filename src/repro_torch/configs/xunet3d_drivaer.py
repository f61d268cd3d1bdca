"""X-UNet3D (paper SVI): 3-level 3D UNet with attention gates for volumetric
flow prediction, halo partitioning with halo=40, 10 partitions."""
from repro_torch.configs.base import UNetConfig

CONFIG = UNetConfig()
