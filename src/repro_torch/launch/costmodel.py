"""Analytic per-step FLOP / HBM-byte model for every architecture family.

A copy of ``repro.launch.costmodel``'s arithmetic on the port's configs and
its parameter counts (``models.registry.param_count`` and
``active_param_count``, counted on the meta device). First-principles
counting is exact for the matmul-dominated terms (madd = 2 flops), and is
what the dry run's roofline and ``chip_smoke.py``'s fractions of roofline
read at the card's constants (``configs.base.HW``).

Conventions:
* flops are GLOBAL per optimizer/serve step (divide by devices for
  per-device);
* train multiplies forward by (1 fwd + 2 bwd + 1 remat-recompute) = 4 when
  cfg.remat != 'none', else 3;
* bytes model (coarser): 3x param traffic for train (fwd read, bwd read,
  optimizer read-modify-write on f32 m/v), 1x for serve, plus activation
  traffic ~= 2x the per-layer residual stream + attention KV/cache traffic.
  Elementwise constants are small and ignored.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import registry


@dataclass(frozen=True)
class StepCost:
    flops: float                 # global flops per step
    hbm_bytes: float             # global HBM bytes per step
    fwd_flops: float


def _attn_kv_len(shape: ShapeConfig, s_q: int, window) -> float:
    """Average #keys attended per query."""
    if shape.kind == "decode":
        kv = shape.seq_len
    else:
        kv = (s_q + 1) / 2.0                       # causal average
    if window:
        kv = min(kv, window)
    return kv


def _attention_flops(cfg: ModelConfig, b: int, s_q: int, kv_len: float) -> float:
    h, kvh, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_model
    proj = 2 * b * s_q * d * (2 * h * hd + 2 * kvh * hd)
    scores = 2 * b * s_q * kv_len * h * hd * 2     # qk^T and att@v
    return proj + scores


def _ffn_flops(cfg: ModelConfig, b: int, s: int, ff: int) -> float:
    mults = 3 if cfg.glu else 2
    return 2 * b * s * cfg.d_model * ff * mults


def _moe_flops(cfg: ModelConfig, b: int, s: int) -> float:
    m = cfg.moe
    router = 2 * b * s * cfg.d_model * m.n_experts
    slots = b * s * m.top_k * m.capacity_factor    # dispatched capacity rows
    routed = 2 * slots * cfg.d_model * m.d_ff_expert * 3
    shared = (_ffn_flops(cfg, b, s, m.d_ff_expert * m.n_shared_experts)
              if m.n_shared_experts else 0.0)
    return router + routed + shared


def _mamba2_flops(cfg: ModelConfig, b: int, s: int) -> float:
    ssm = cfg.ssm
    d = cfg.d_model
    di = ssm.expand * d
    H = ssm.n_ssm_heads
    dk = ssm.d_state
    dv = di // H
    C = min(ssm.chunk_size, s)
    conv_dim = di + 2 * dk
    in_proj = 2 * b * s * d * (2 * di + 2 * dk + H)
    conv = 2 * b * s * conv_dim * ssm.d_conv
    # chunked GLA: intra (per token: C keys) + inter/state (dk*dv per token)
    gla = 2 * b * s * H * (C * (dk + dv) + 2 * dk * dv)
    out = 2 * b * s * di * d
    return in_proj + conv + gla + out


def _mlstm_flops(cfg: ModelConfig, b: int, s: int) -> float:
    ssm = cfg.ssm
    d = cfg.d_model
    di = ssm.expand * d
    H = ssm.n_ssm_heads
    hd = di // H
    C = min(ssm.chunk_size, s)
    up = 2 * b * s * d * 2 * di
    conv = 2 * b * s * di * ssm.d_conv
    qkv = 2 * b * s * di * di * 3
    gates = 2 * b * s * di * 2 * H
    gla = 2 * b * s * H * (C * (hd + hd) + 2 * hd * hd)
    down = 2 * b * s * di * d
    return up + conv + qkv + gates + gla + down


def _slstm_flops(cfg: ModelConfig, b: int, s: int) -> float:
    d = cfg.d_model
    H = cfg.ssm.n_ssm_heads
    hd = d // H
    gates = 2 * b * s * d * d * 4
    rec = 8 * b * s * H * hd * hd                  # per-step R einsum, 4 gates
    ffn = 2 * b * s * d * ((4 * d) // 3) * 3
    return gates + rec + ffn


def _logits_flops(cfg: ModelConfig, b: int, s: int) -> float:
    return 2 * b * s * cfg.d_model * cfg.padded_vocab


def fwd_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    b = shape.global_batch
    s_q = 1 if shape.kind == "decode" else shape.seq_len
    total = 0.0
    if cfg.is_encoder_decoder:
        ta = cfg.n_frontend_tokens
        if shape.kind != "decode":                 # encoder runs on (pre)fill
            enc_attn = _attention_flops(cfg, b, ta, ta)
            enc_ffn = _ffn_flops(cfg, b, ta, cfg.d_ff)
            total += cfg.encoder_layers * (enc_attn + enc_ffn)
        self_kv = _attn_kv_len(shape, s_q, None)
        dec = (_attention_flops(cfg, b, s_q, self_kv)          # self
               + _attention_flops(cfg, b, s_q, ta)             # cross
               + _ffn_flops(cfg, b, s_q, cfg.d_ff))
        total += cfg.n_layers * dec
        total += _logits_flops(cfg, b, s_q)
        return total
    if cfg.ssm is not None and cfg.attn_every:     # hybrid (zamba2)
        ng = cfg.n_layers // cfg.attn_every
        n_mamba = ng * (cfg.attn_every - 1)
        kv_len = _attn_kv_len(shape, s_q, None)
        total += n_mamba * _mamba2_flops(cfg, b, s_q)
        total += ng * (_attention_flops(cfg, b, s_q, kv_len)
                       + _ffn_flops(cfg, b, s_q, cfg.d_ff))
        total += _logits_flops(cfg, b, s_q)
        return total
    if cfg.ssm is not None:                        # xlstm
        gs = cfg.ssm.slstm_every
        ng = cfg.n_layers // gs
        total += ng * (gs - 1) * _mlstm_flops(cfg, b, s_q)
        total += ng * _slstm_flops(cfg, b, s_q)
        total += _logits_flops(cfg, b, s_q)
        return total
    # decoder transformer (dense / moe / vlm)
    s_model = s_q
    if cfg.frontend == "vision" and shape.kind != "decode":
        s_model = s_q                              # seq_len already includes patches
    windows = [cfg.sliding_window, None] if \
        cfg.layer_pattern == "alt_local_global" else [cfg.sliding_window]
    nfd = cfg.moe.first_dense_layers if cfg.moe else 0
    n_scanned = cfg.n_layers - nfd
    per_window = n_scanned / len(windows)
    for w in windows:
        kv_len = _attn_kv_len(shape, s_model, w)
        total += per_window * _attention_flops(cfg, b, s_model, kv_len)
    if cfg.moe is not None:
        total += n_scanned * _moe_flops(cfg, b, s_model)
        dense_ff = cfg.moe.d_ff_expert * (cfg.moe.top_k + cfg.moe.n_shared_experts)
        total += nfd * (_attention_flops(cfg, b, s_model,
                                         _attn_kv_len(shape, s_model, None))
                        + _ffn_flops(cfg, b, s_model, dense_ff))
    else:
        total += n_scanned * _ffn_flops(cfg, b, s_model, cfg.d_ff)
    total += _logits_flops(cfg, b, s_model)
    return total


def _param_bytes(cfg: ModelConfig) -> float:
    return registry.param_count(cfg) * 2.0         # bf16


def _active_param_bytes(cfg: ModelConfig) -> float:
    return registry.active_param_count(cfg) * 2.0


def hbm_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    b = shape.global_batch
    s_q = 1 if shape.kind == "decode" else shape.seq_len
    d = cfg.d_model
    L = cfg.n_layers + (cfg.encoder_layers if cfg.is_encoder_decoder else 0)
    act_stream = 2 * b * s_q * d * 2 * L * 4       # read+write residual/layer
    if shape.kind == "train":
        # params: fwd read + bwd read + grad write (bf16) + Adam m/v f32 RMW
        params = _param_bytes(cfg) * 3 + registry.param_count(cfg) * 4 * 4
        return params + 2 * act_stream             # fwd + recompute-ish
    params = _active_param_bytes(cfg) if shape.kind == "decode" \
        else _param_bytes(cfg)
    cache = 0.0
    if shape.kind == "decode":
        kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        if cfg.ssm is not None and cfg.attn_every:
            n_attn = cfg.n_layers // cfg.attn_every
            cache = n_attn * b * shape.seq_len * kvh * hd * 2 * 2
            ssm_state = (cfg.n_layers - n_attn) * b * cfg.ssm.n_ssm_heads * \
                cfg.ssm.d_state * (cfg.ssm.expand * d //
                                   cfg.ssm.n_ssm_heads) * 4 * 2
            cache += ssm_state
        elif cfg.ssm is not None:
            di = cfg.ssm.expand * d
            hd_i = di // cfg.ssm.n_ssm_heads
            cache = cfg.n_layers * b * cfg.ssm.n_ssm_heads * hd_i * hd_i * 4 * 2
        else:
            eff = shape.seq_len
            if cfg.layer_pattern == "alt_local_global" and cfg.sliding_window:
                eff = (shape.seq_len + cfg.sliding_window) / 2
            cache = L * b * eff * kvh * hd * 2 * 2  # k+v read (+1-slot write)
        if cfg.is_encoder_decoder:
            cache += cfg.n_layers * b * cfg.n_frontend_tokens * kvh * hd * 2 * 2
    elif shape.kind == "prefill":
        cache = 0.0                                 # included in act_stream-ish
    return params + act_stream + cache


def step_cost(cfg: ModelConfig, shape: ShapeConfig) -> StepCost:
    f = fwd_flops(cfg, shape)
    if shape.kind == "train":
        mult = 4.0 if cfg.remat != "none" else 3.0
        flops = mult * f
    else:
        flops = f
    return StepCost(flops=flops, hbm_bytes=hbm_bytes(cfg, shape), fwd_flops=f)
