"""Operations of the unpartitioned grid's convolutions and gates a pass
(no halo planes), over the window, in % of the TF32 peak (layer: X-UNet3D;
moves volume_pass_s)."""
from perfbench import counts
from perfbench.readers import mfu


def read(ctx):
    cfg = ctx["cfg"]
    return mfu(ctx, ctx["passes"] * counts.unet_flops(cfg, cfg.grid))
