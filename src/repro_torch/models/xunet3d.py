"""X-UNet3D (paper SVI) as an ``nn.Module``: a 3D UNet with attention gates,
built so that halo partitioning is EXACT. Every operation is pointwise, a
finite-support convolution, or pooling/upsampling aligned to the partition
grid; normalization is per-voxel RMS over channels (no spatial statistics,
which would couple distant voxels and break the halo equivalence).

Port of ``repro.models.xunet3d``. Inputs and outputs are ``(B, X, Y, Z, C)``
tensors, as in JAX. Inside, the model runs in PyTorch's ``(B, C, X, Y, Z)``
layout (NCDHW, contiguous): the input is permuted once at the model's edge
and the output permuted back, and every convolution is
``torch.nn.functional.conv3d`` (cuDNN on the card), as JAX's is
``jax.lax.conv_general_dilated`` outside any Pallas kernel. Weights are held
as PyTorch's ``(cout, cin, k, k, k)``; the JAX tree's ``(k, k, k, cin,
cout)`` converts in ``models.convert`` (``xunet_from_jax``,
``xunet_to_jax``). ``"SAME"`` padding of an odd kernel is ``(k - 1) / 2``
on every side. Pool size 2 per level: partition offsets must be multiples
of ``2 ** (depth - 1)`` so pooling windows align across partitions.

The card computes in full f32: :func:`init` and ``xunet_from_jax`` on a
CUDA device turn TF32 off for cuDNN and matmuls (cuDNN's convolutions
default to TF32, about 1e-3 off JAX's f32).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import UNetConfig
from repro_torch.device import resolve
from repro_torch.models.nn import ACTS


class Conv3d(nn.Module):
    """``conv_init``: ``w`` uniform in +-sqrt(1 / (cin k^3)), ``b`` zero."""

    def __init__(self, k: int, cin: int, cout: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if k % 2 != 1:
            raise ValueError(f"kernel size {k}: only odd kernels pad "
                             "symmetrically under 'SAME'")
        lim = (1.0 / (cin * k ** 3)) ** 0.5
        w = torch.empty((cout, cin, k, k, k), dtype=torch.float32)
        self.w = nn.Parameter(w.uniform_(-lim, lim, generator=generator))
        self.b = nn.Parameter(torch.zeros((cout,), dtype=torch.float32))


class Block(nn.Module):
    def __init__(self, k: int, cin: int, cout: int, n_convs: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.convs = nn.ModuleList(
            Conv3d(k, cin if i == 0 else cout, cout, generator=generator)
            for i in range(n_convs))


class Gate(nn.Module):
    def __init__(self, c_skip: int, c_gate: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        ci = max(c_skip // 2, 1)
        self.wx = Conv3d(1, c_skip, ci, generator=generator)
        self.wg = Conv3d(1, c_gate, ci, generator=generator)
        self.psi = Conv3d(1, ci, 1, generator=generator)


def conv3d(p: Conv3d, x: torch.Tensor) -> torch.Tensor:
    """Stride-1 ``"SAME"`` convolution of an NCDHW tensor."""
    return F.conv3d(x, p.w, p.b, padding=(p.w.shape[-1] - 1) // 2)


def voxel_rms(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-voxel RMS norm over channels (dim 1): strictly local."""
    return x * torch.rsqrt(torch.mean(torch.square(x), 1, keepdim=True) + eps)


def block_apply(p: Block, x: torch.Tensor, act: str) -> torch.Tensor:
    a = ACTS[act]
    for cp in p.convs:
        x = a(conv3d(cp, voxel_rms(x)))
    return x


def gate_apply(p: Gate, skip: torch.Tensor, gate: torch.Tensor
               ) -> torch.Tensor:
    """Attention gate (1x1 convs, local): skip * sigmoid(psi(relu(wx*x +
    wg*g)))."""
    q = F.relu(conv3d(p.wx, skip) + conv3d(p.wg, gate))
    return skip * torch.sigmoid(conv3d(p.psi, q))


def _pool(x: torch.Tensor) -> torch.Tensor:
    """Max over 2x2x2 windows, VALID (JAX's ``reduce_window`` from -inf)."""
    return F.max_pool3d(x, 2)


def _upsample(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 on each spatial axis (output voxel i reads input
    voxel i // 2)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class XUNet3D(nn.Module):
    """Parameters named as in the JAX pytree: ``enc[i].convs[j]``,
    ``ups[j]``, ``gates[j]`` (none without attention gates),
    ``dec[j].convs[i]``, ``head``, each conv with ``w`` and ``b``."""

    def __init__(self, cfg: UNetConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        k, n = cfg.kernel_size, cfg.blocks_per_level
        ch = [cfg.base_channels * (2 ** i) for i in range(cfg.depth)]
        # drawn in JAX's init order: each encoder block, then per decoder
        # level its up conv, gate and block, then the head
        enc, cin = [], cfg.in_channels
        for i in range(cfg.depth):
            enc.append(Block(k, cin, ch[i], n, generator=generator))
            cin = ch[i]
        ups, gates, dec = [], [], []
        for i in reversed(range(cfg.depth - 1)):
            ups.append(Conv3d(1, ch[i + 1], ch[i], generator=generator))
            if cfg.attention_gates:
                gates.append(Gate(ch[i], ch[i], generator=generator))
            dec.append(Block(k, 2 * ch[i], ch[i], n, generator=generator))
        self.enc = nn.ModuleList(enc)
        self.ups = nn.ModuleList(ups)
        self.gates = nn.ModuleList(gates) if cfg.attention_gates else None
        self.dec = nn.ModuleList(dec)
        self.head = Conv3d(1, ch[0], cfg.out_channels, generator=generator)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, X, Y, Z, in_channels) -> (B, X, Y, Z, out_channels).
        Spatial dims must be divisible by 2**(depth-1)."""
        cfg = self.cfg
        x = x.permute(0, 4, 1, 2, 3).contiguous()      # NDHWC -> NCDHW
        skips: List[torch.Tensor] = []
        for i, bp in enumerate(self.enc):
            x = block_apply(bp, x, cfg.act)
            if i < cfg.depth - 1:
                skips.append(x)
                x = _pool(x)
        gates = self.gates if self.gates is not None else \
            [None] * len(self.ups)
        for up, gp, bp in zip(self.ups, gates, self.dec):
            x = conv3d(up, _upsample(x))
            skip = skips.pop()
            if gp is not None:
                skip = gate_apply(gp, skip, x)
            x = torch.cat([skip, x], dim=1)
            del skip           # the block needs only the concatenation
            x = block_apply(bp, x, cfg.act)
        return conv3d(self.head, x).permute(0, 2, 3, 4, 1)

    forward = apply

    def leaves(self) -> List[Tuple[str, nn.Parameter]]:
        """``(name, parameter)`` in the JAX pytree's leaf order: dict keys
        sorted at every level, list items in order. ``optim.adam``'s
        ``global_norm`` sums in this order, as JAX's sums the leaves."""
        def key(name):
            return [int(p) if p.isdigit() else p for p in name.split(".")]
        return sorted(self.named_parameters(), key=lambda kv: key(kv[0]))


def full_f32(device: torch.device):
    """Turn TF32 off on the card for matmuls and cuDNN: the JAX reference
    convolves in full f32."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def init(generator: torch.Generator, cfg: UNetConfig,
         device=None) -> XUNet3D:
    """Random weights from ``generator`` (a CPU generator, so the numbers do
    not depend on the device), moved to ``device`` (default: the card).
    The same limits as the JAX ``init``, not the same numbers."""
    dev = resolve(device)
    full_f32(dev)
    return XUNet3D(cfg, generator=generator).to(dev)


def receptive_field(cfg: UNetConfig) -> int:
    """Analytic one-sided receptive field in voxels (paper SVI: halo must
    cover it). Each conv adds (k-1)/2 * stride_product; pooling doubles the
    effective stride on the way down and back up."""
    r = 0
    stride = 1
    half = (cfg.kernel_size - 1) // 2
    for i in range(cfg.depth):
        r += cfg.blocks_per_level * half * stride
        if i < cfg.depth - 1:
            stride *= 2
    for i in range(cfg.depth - 1):
        r += cfg.blocks_per_level * half * stride
        stride //= 2
    return r


def divergence(u: torch.Tensor) -> torch.Tensor:
    """d u_x/dx + d u_y/dy + d u_z/dz of a (B, X, Y, Z, 3) velocity, as
    ``jnp.gradient``: central differences inside, one-sided first order at
    the domain's edges."""
    return sum(torch.gradient(u[..., i], dim=1 + i, edge_order=1)[0]
               for i in range(3))


def train_loss(model: XUNet3D, batch, continuity_weight: float = 0.0):
    """MSE + optional continuity (div u) penalty via central differences
    (paper SVI trains with an additional continuity constraint)."""
    pred = model.apply(batch["inputs"])
    mse = torch.mean(torch.square(pred - batch["targets"]))
    if continuity_weight:
        div = divergence(pred[..., :3])
        mse = mse + continuity_weight * torch.mean(torch.square(div))
    return mse
