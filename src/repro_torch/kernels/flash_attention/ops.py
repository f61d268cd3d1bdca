"""Flash attention: a CUDA kernel for tensors on the card, its plain
version for tensors on the CPU (dispatch by device; there is no other
switch). On the card, bf16 goes to the tensor-core kernel
(``csrc/flash_attention_wgmma.cu``: wgmma, TMA-fed K/V ring) and f32 to the
CUDA-core kernel (``csrc/flash_attention.cu``: IEEE f32 FMAs, register
tiles of S and O per thread, cp.async-fed K/V tiles); nothing falls back.
``ablate`` times that kernel's parts on the card.

``flash_attention`` takes flattened heads, ``mha`` the model layout (the
reshapes of ``repro.kernels.flash_attention.ops.mha``). ``mha.launches``
counts every launch of either kernel, through either function.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

# both kernels are templates on head_dim, instanced for those on the path:
# 256 (gemma2) and 128 (granite, starcoder2, yi, deepseek-moe, qwen3-moe,
# pixtral)
KERNEL_HEAD_DIMS = (128, 256)
# dtype -> (library in _build.SOURCES, C entry point)
_ENTRY = {torch.bfloat16: ("flash_attention_wgmma",
                           "flash_attention_wgmma_bf16"),
          torch.float32: ("flash_attention", "flash_attention_f32")}


def _lib(dtype):
    library, symbol = _ENTRY[dtype]
    fn = getattr(_build.load(library), symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
            [ctypes.c_float] * 2 + [ctypes.c_void_p]
    return fn


def flash_attention(q, k, v, *, group_size: int = 1, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None):
    """q (BH, Sq, hd); k, v (BH // group_size, Skv, hd) -> (BH, Sq, hd)."""
    if q.device.type == "cpu":
        return ref.attention(q, k, v, group_size=group_size, causal=causal,
                             window=window, softcap=softcap)
    return _launch(q, k, v, group_size, causal, window, softcap)


def mha(q, k, v, *, causal: bool = True, window: Optional[int] = None,
        softcap: Optional[float] = None):
    """q (B, Sq, H, hd); k, v (B, Skv, KV, hd); GQA with H % KV == 0.
    Returns (B, Sq, H, hd)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    if h % kvh:
        raise ValueError(f"mha: {h} query heads over {kvh} KV heads")
    # reshape may return a strided view (B = 1), so ask for a copy
    qf = q.transpose(1, 2).reshape(b * h, sq, hd).contiguous()
    kf = k.transpose(1, 2).reshape(b * kvh, -1, hd).contiguous()
    vf = v.transpose(1, 2).reshape(b * kvh, -1, hd).contiguous()
    o = flash_attention(qf, kf, vf, group_size=h // kvh, causal=causal,
                        window=window, softcap=softcap)
    return o.reshape(b, h, sq, hd).transpose(1, 2)


mha.launches = 0


def _launch(q, k, v, group_size: int, causal: bool, window: Optional[int],
            softcap: Optional[float]):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, "
                         f"not {dev}")
    if q.dtype not in _ENTRY:
        raise ValueError(f"flash_attention: the kernel is built for "
                         f"bfloat16 and float32, got {q.dtype}")
    if q.dim() != 3:
        raise ValueError(f"flash_attention: q must be (BH, Sq, hd), got "
                         f"{tuple(q.shape)}")
    bh, sq, hd = q.shape
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernels are built for hd in "
                         f"{KERNEL_HEAD_DIMS}, got hd={hd}")
    if group_size < 1 or bh % group_size:
        raise ValueError(f"flash_attention: BH={bh} is not a multiple of "
                         f"group_size={group_size}")
    shape = (bh // group_size, sq, hd)
    for name, t in (("q", q), ("k", k), ("v", v)):
        want = tuple(q.shape) if name == "q" else shape
        if t.device != dev or t.dtype != q.dtype or tuple(t.shape) != want \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"flash_attention: {name} must be a contiguous, 16-byte "
                f"aligned {q.dtype} tensor of shape {want} on {dev} (the "
                f"kernel takes Skv == Sq), got {t.dtype} {tuple(t.shape)} "
                f"on {t.device} (contiguous={t.is_contiguous()})")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got "
                         f"{softcap}")
    if q.dtype == torch.float32 and bh > 65535:
        raise ValueError(f"flash_attention: BH={bh} exceeds the f32 "
                         "kernel's grid y limit of 65535")
    out = torch.empty_like(q)
    if bh == 0 or sq == 0:
        return out
    fn = _lib(q.dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), bh, group_size, sq, int(causal),
                        0 if window is None else int(window), hd,
                        1.0 / math.sqrt(hd),
                        0.0 if softcap is None else float(softcap), stream),
                     "flash_attention")
    mha.launches += 1
    return out
