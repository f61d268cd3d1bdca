"""The paper's own model: X-MeshGraphNet for DrivAerML surface aerodynamics
(paper SV): 3-level graph (500k/1M/2M points), k=6, 15 MP layers, hidden 512,
SiLU, 21 partitions, halo 15, 24 input features (pos+normals+Fourier),
4 outputs (pressure + 3 wall-shear components)."""
from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig()  # defaults encode the paper's setup exactly
