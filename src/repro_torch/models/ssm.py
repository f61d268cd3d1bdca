"""Recurrent blocks: the gated linear attention (GLA) core, Mamba2's SSD
block and the xLSTM's mLSTM block on it, and the sLSTM block.

Port of ``repro.models.ssm``. The GLA recurrence, per head, with scalar
gates:

    S_t = a_t S_{t-1} + b_t k_t v_t^T,    y_t = q_t^T S_t

is evaluated exactly in chunks (``gla_chunked``): within a chunk a masked
(Q K^T) V product, across chunks the carried state S. The intra-chunk
products of every chunk run at once; the loop over chunks carries S only.
All of it is float32 ``torch.einsum``, as JAX computes it in XLA: no Pallas
kernel runs here, so the port writes none. Mamba2 (zamba2's blocks) feeds
it a per-head scalar decay ``a = exp(-dt exp(A_log))`` and input scale
``b = dt``, with its B and C shared by every head (one group), around a
causal depthwise conv and a gated output RMSNorm; its GLA core is marked
``mamba2.gla``. The mLSTM folds its max-stabilised exponential gating
into (a, b) through ``stabilizer_scan``;
the sLSTM is a scalar recurrence through its hidden state, a loop over
time steps. The GLA core and the sLSTM's loop are marked for
``torch.profiler`` (``mlstm.gla``, ``slstm.loop``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.nn import ACTS, Dense, RMSNorm, whole
from repro_torch.telemetry import span

State = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# GLA core
# ---------------------------------------------------------------------------

def gla_scan_reference(q, k, v, log_a, log_b, S0, n0=None):
    """The recurrence one step at a time (the oracle of the tests).
    q, k (B, T, H, dk); v (B, T, H, dv); log_a, log_b (B, T, H); S0 (B, H,
    dk, dv); n0 (B, H, dk) or None. Returns y (B, T, H, dv), ny (B, T, H) or
    None, S_T, n_T."""
    S = S0
    n = n0 if n0 is not None else torch.zeros(S0.shape[:-1], device=q.device)
    ys, nys = [], []
    for t in range(q.shape[1]):
        a = torch.exp(log_a[:, t])[..., None, None]
        b = torch.exp(log_b[:, t])[..., None, None]
        kt, qt = k[:, t], q[:, t]
        S = a * S + b * (kt[..., :, None] * v[:, t][..., None, :])
        ys.append(torch.einsum("bhd,bhdv->bhv", qt, S))
        if n0 is not None:
            n = a[..., 0] * n + b[..., 0] * kt
            nys.append(torch.einsum("bhd,bhd->bh", qt, n))
    y = torch.stack(ys, dim=1)
    if n0 is None:
        return y, None, S, None
    return y, torch.stack(nys, dim=1), S, n


def gla_chunked(q, k, v, log_a, log_b, S0, n0=None, chunk: int = 64):
    """The recurrence evaluated exactly in chunks of ``chunk`` steps (T must
    be a multiple), all in float32; the shapes of
    :func:`gla_scan_reference`."""
    B, T, H, dk = q.shape
    dv = v.shape[-1]
    if T % chunk:
        raise ValueError(f"gla_chunked: T={T} is not a multiple of "
                         f"chunk={chunk}")
    nc = T // chunk
    f32 = torch.float32
    q, k, v, log_a, log_b = (whole(x, 1).to(f32)
                             for x in (q, k, v, log_a, log_b))
    track_n = n0 is not None

    def resh(x):          # (B, T, ...) -> (nc, B, C, ...)
        return x.reshape(B, nc, chunk, *x.shape[2:]).transpose(0, 1)

    qs, ks, vs, las, lbs = map(resh, (q, k, v, log_a, log_b))
    cum = torch.cumsum(las, dim=2)                      # inclusive
    tot = cum[:, :, -1]                                 # (nc, B, H)
    e = torch.exp(cum)                                  # (nc, B, C, H)
    r = torch.exp(tot[:, :, None] - cum + lbs)          # decay to end * b
    # intra-chunk, every chunk at once
    scores = torch.einsum("nbthd,nbshd->nbhts", qs, ks)
    cum_h = cum.transpose(2, 3)                         # (nc, B, H, C)
    dmat = cum_h[..., :, None] - cum_h[..., None, :] + \
        lbs.transpose(2, 3)[..., None, :]               # (nc, B, H, C, C)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q.device))
    # masked before the exp: above the diagonal dmat is a sum of -log decays,
    # which overflows exp once it passes ~88, and JAX's where(mask,
    # exp(dmat), 0) then makes the gradient 0 * inf = NaN
    sw = scores * torch.exp(dmat.masked_fill(~mask, float("-inf")))
    y_intra = torch.einsum("nbhts,nbshv->nbthv", sw, vs)
    qe = qs * e[..., None]
    kr = ks * r[..., None]
    S = S0.to(f32)
    n = n0.to(f32) if track_n else None
    ys, nys = [], []
    # one chunk at a time through unbind, whose backward stacks the chunks'
    # gradients once (indexing would add nc full-size gradients)
    for qe_c, kr_c, v_c, yi_c, tot_c, sw_c in zip(
            *(x.unbind(0) for x in (qe, kr, vs, y_intra, tot, sw))):
        # inter-chunk from the carried state, then the state update
        ys.append(torch.einsum("bchd,bhdv->bchv", qe_c, S) + yi_c)
        if track_n:
            nys.append(torch.einsum("bchd,bhd->bch", qe_c, n)
                       + sw_c.sum(dim=3).transpose(1, 2))
        decay = torch.exp(tot_c)
        S = decay[..., None, None] * S + \
            torch.einsum("bshd,bshv->bhdv", kr_c, v_c)
        if track_n:
            n = decay[..., None] * n + kr_c.sum(dim=1)
    y = torch.stack(ys, dim=1).reshape(B, T, H, dv)
    if not track_n:
        return y, None, S, None
    return y, torch.stack(nys, dim=1).reshape(B, T, H), S, n


def gla_decode_step(q, k, v, log_a, log_b, S, n=None):
    """One step. q, k (B, H, dk); v (B, H, dv); log_a, log_b (B, H)."""
    a = torch.exp(log_a.float())[..., None, None]
    b = torch.exp(log_b.float())[..., None, None]
    kf, qf = k.float(), q.float()
    S = a * S + b * (kf[..., :, None] * v.float()[..., None, :])
    y = torch.einsum("bhd,bhdv->bhv", qf, S)
    ny = None
    if n is not None:
        n = a[..., 0] * n + b[..., 0] * kf
        ny = torch.einsum("bhd,bhd->bh", qf, n)
    return y, ny, S, n


def stabilizer_scan(log_f, log_i, m0):
    """m_t = max(m_{t-1} + log_f_t, log_i_t) from m0. log_f, log_i (B, T,
    H); m0 (B, H). Returns m and m_prev (m shifted by one, m0 first), each
    (B, T, H). The max-plus scan of JAX's ``lax.associative_scan``, with its
    combine ``(a1, b1), (a2, b2) -> (a1 + a2, max(b1 + a2, b2))``, in
    log2(T) doubling steps (Hillis-Steele) along time."""
    a, b = log_f, log_i
    T = a.shape[1]
    d = 1
    while d < T:
        a, b = (torch.cat([a[:, :d], a[:, :-d] + a[:, d:]], dim=1),
                torch.cat([b[:, :d], torch.maximum(b[:, :-d] + a[:, d:],
                                                   b[:, d:])], dim=1))
        d *= 2
    m = torch.maximum(b, m0[:, None] + a)
    return m, torch.cat([m0[:, None], m[:, :-1]], dim=1)


def causal_conv(x, w, b, state=None):
    """Depthwise causal convolution. x (B, T, C); w (K, C); b (C,); state
    (B, K - 1, C) of the previous inputs, or None (zeros). Returns y (B, T,
    C) and the new state."""
    kw = w.shape[0]
    pad = state if state is not None else torch.zeros(
        (x.shape[0], kw - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(kw)) + b
    return y, xp[:, xp.shape[1] - (kw - 1):]


def _chunk_for(T: int, chunk_size: int) -> int:
    chunk = min(chunk_size, T)
    if T % chunk:
        chunk = math.gcd(T, chunk) or 1
    return chunk


# ---------------------------------------------------------------------------
# Mamba2 block (SSD)
# ---------------------------------------------------------------------------

def mamba2_dims(cfg: ModelConfig):
    """(d_inner, heads, head width, conv width) of Mamba2: the conv runs
    over [x, B, C] (one group)."""
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    n_heads = ssm.n_ssm_heads
    return d_inner, n_heads, d_inner // n_heads, d_inner + 2 * ssm.d_state


class Mamba2(nn.Module):
    """Pre-norm, the input projection to (z, x, B, C, dt), a causal
    depthwise conv and SiLU over [x, B, C], the SSD recurrence through the
    GLA core (``D`` skip in f32), an output RMSNorm gated by ``silu(z)``,
    the output projection, and the residual. ``A_log``, ``dt_bias`` and
    ``D`` are float32 whatever the model's dtype, as in
    ``repro.models.ssm.mamba2_init``."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        d, ssm = cfg.d_model, cfg.ssm
        d_inner, n_heads, _, conv_dim = mamba2_dims(cfg)
        init = dict(generator=generator, device=device, dtype=dtype)
        self.norm = RMSNorm(d, device=device, dtype=dtype)
        self.in_proj = Dense(d, 2 * d_inner + 2 * ssm.d_state + n_heads,
                             use_bias=False, **init)
        w = torch.randn((ssm.d_conv, conv_dim), generator=generator,
                        device=device)
        self.conv_w = nn.Parameter(w.mul_(0.1).to(dtype))
        self.conv_b = nn.Parameter(torch.zeros(conv_dim, device=device,
                                               dtype=dtype))
        f32 = dict(device=device, dtype=torch.float32)
        self.A_log = nn.Parameter(torch.zeros(n_heads, **f32))  # A = -1
        self.dt_bias = nn.Parameter(torch.zeros(n_heads, **f32))
        self.D = nn.Parameter(torch.ones(n_heads, **f32))
        self.out_norm = RMSNorm(d_inner, device=device, dtype=dtype)
        self.out_proj = Dense(d_inner, d, use_bias=False, **init)

    def forward(self, u, state: Optional[State] = None):
        """u (B, T, d); ``state`` {conv, S} of the previous steps, or None
        (zeros). T == 1 with a state is one decode step; otherwise the
        chunked recurrence starts from ``state['S']``. Returns (u + out,
        new state)."""
        ssm = self.cfg.ssm
        d_inner, H, hd, conv_dim = mamba2_dims(self.cfg)
        B, T, _ = u.shape
        z, xbc, dt_raw = torch.split(self.in_proj(self.norm(u)),
                                     [d_inner, conv_dim, H], dim=-1)
        xbc, new_conv = causal_conv(xbc, self.conv_w, self.conv_b,
                                    None if state is None else state["conv"])
        x, Bm, Cm = torch.split(F.silu(xbc),
                                [d_inner, ssm.d_state, ssm.d_state], dim=-1)
        v = x.reshape(B, T, H, hd)
        # B and C are shared by every head (one group)
        k = Bm[:, :, None, :].expand(B, T, H, ssm.d_state)
        q = Cm[:, :, None, :].expand(B, T, H, ssm.d_state)
        dt = F.softplus(dt_raw.float() + self.dt_bias)           # (B, T, H)
        log_a = -dt * torch.exp(self.A_log)                       # <= 0
        log_b = torch.log(dt + 1e-20)
        S0 = torch.zeros((B, H, ssm.d_state, hd), device=u.device) \
            if state is None else state["S"]
        with span("mamba2.gla"):
            if T == 1 and state is not None:
                y, _, S, _ = gla_decode_step(q[:, 0], k[:, 0], v[:, 0],
                                             log_a[:, 0], log_b[:, 0], S0)
                y = y[:, None]
            else:
                y, _, S, _ = gla_chunked(q, k, v, log_a, log_b, S0,
                                         chunk=_chunk_for(T, ssm.chunk_size))
        y = y.reshape(B, T, d_inner) + \
            self.D.repeat_interleave(hd) * x.float()
        y = self.out_norm(y.to(u.dtype)) * F.silu(z)
        return u + self.out_proj(y), {"conv": new_conv, "S": S}


def mamba2_empty_state(cfg: ModelConfig, batch: int, device=None) -> State:
    """Zero state: the conv inputs in ``cfg.dtype``, S float32."""
    d_inner, H, hd, conv_dim = mamba2_dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm.d_conv - 1, conv_dim),
                            dtype=getattr(torch, cfg.dtype), device=device),
        "S": torch.zeros((batch, H, cfg.ssm.d_state, hd), device=device),
    }


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM)
# ---------------------------------------------------------------------------

def mlstm_dims(cfg: ModelConfig):
    """(d_inner, heads, head width) of the mLSTM."""
    d_inner = cfg.ssm.expand * cfg.d_model
    heads = cfg.ssm.n_ssm_heads
    return d_inner, heads, d_inner // heads


class MLSTM(nn.Module):
    """Pre-norm, up-projection to (x_in, z), causal conv and SiLU on x_in
    for q and k, v and the input/forget gates from x_in, the stabilised
    matrix memory through the GLA core, an output RMSNorm gated by
    ``silu(z)``, the down-projection, and the residual."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        d_inner, heads, _ = mlstm_dims(cfg)
        init = dict(generator=generator, device=device, dtype=dtype)
        self.norm = RMSNorm(d, device=device, dtype=dtype)
        self.up_proj = Dense(d, 2 * d_inner, use_bias=False, **init)
        w = torch.randn((cfg.ssm.d_conv, d_inner), generator=generator,
                        device=device)
        self.conv_w = nn.Parameter(w.mul_(0.1).to(dtype))
        self.conv_b = nn.Parameter(torch.zeros(d_inner, device=device,
                                               dtype=dtype))
        for name in ("wq", "wk", "wv"):
            setattr(self, name, Dense(d_inner, d_inner, use_bias=False,
                                      **init))
        self.w_igate = Dense(d_inner, heads, **init)
        self.w_fgate = Dense(d_inner, heads, **init)
        self.out_norm = RMSNorm(d_inner, device=device, dtype=dtype)
        self.down_proj = Dense(d_inner, d, use_bias=False, **init)

    def forward(self, x, state: Optional[State] = None):
        """x (B, T, d); ``state`` {conv, S, n, m} of the previous steps, or
        None (zeros). T == 1 with a state is one decode step. Returns (x +
        out, new state)."""
        d_inner, H, hd = mlstm_dims(self.cfg)
        B, T, _ = x.shape
        x_in, z = self.up_proj(self.norm(x)).chunk(2, dim=-1)
        xc, new_conv = causal_conv(x_in, self.conv_w, self.conv_b,
                                   None if state is None else state["conv"])
        xc = F.silu(xc)
        q = self.wq(xc).reshape(B, T, H, hd) / math.sqrt(hd)
        k = self.wk(xc).reshape(B, T, H, hd) / math.sqrt(hd)
        v = self.wv(x_in).reshape(B, T, H, hd)
        log_f = F.logsigmoid(self.w_fgate(x_in).float())
        log_i = self.w_igate(x_in).float()          # i = exp(raw)
        if state is None:
            S0 = torch.zeros((B, H, hd, hd), device=x.device)
            n0 = torch.zeros((B, H, hd), device=x.device)
            # not -inf: a -1e30 sentinel would be absorbed in the chunked
            # cumsum (f32), zeroing the intra-chunk decays
            m0 = torch.zeros((B, H), device=x.device)
        else:
            S0, n0, m0 = state["S"], state["n"], state["m"]
        with span("mlstm.gla"):
            m, m_prev = stabilizer_scan(log_f, log_i, m0)
            la_eff = log_f + m_prev - m
            lb_eff = log_i - m
            if T == 1 and state is not None:
                y, ny, S, n = gla_decode_step(q[:, 0], k[:, 0], v[:, 0],
                                              la_eff[:, 0], lb_eff[:, 0], S0,
                                              n0)
                y, ny = y[:, None], ny[:, None]
            else:
                y, ny, S, n = gla_chunked(
                    q, k, v, la_eff, lb_eff, S0, n0,
                    chunk=_chunk_for(T, self.cfg.ssm.chunk_size))
        denom = torch.maximum(ny.abs(), torch.exp(-m))[..., None]
        h = (y / denom.clamp_min(1e-20)).reshape(B, T, d_inner)
        h = self.out_norm(h.to(x.dtype)) * F.silu(z)
        return x + self.down_proj(h), {"conv": new_conv, "S": S, "n": n,
                                       "m": m[:, -1]}


def mlstm_empty_state(cfg: ModelConfig, batch: int, device=None) -> State:
    d_inner, H, hd = mlstm_dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm.d_conv - 1, d_inner),
                            dtype=getattr(torch, cfg.dtype), device=device),
        "S": torch.zeros((batch, H, hd, hd), device=device),
        "n": torch.zeros((batch, H, hd), device=device),
        "m": torch.zeros((batch, H), device=device),
    }


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM)
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    """Pre-norm, the four gate projections, the stabilised scalar LSTM with
    per-head recurrent weights ``R`` (4, H, hd, hd) stepped over time, an
    output RMSNorm and residual, then a gated FFN of width 4d/3 (tanh GELU)
    and residual."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        d, H = cfg.d_model, cfg.ssm.n_ssm_heads
        hd = d // H
        init = dict(generator=generator, device=device, dtype=dtype)
        self.norm = RMSNorm(d, device=device, dtype=dtype)
        for name in ("w_z", "w_i", "w_f", "w_o"):
            setattr(self, name, Dense(d, d, **init))
        lim = (1.0 / hd) ** 0.5
        r = torch.rand((4, H, hd, hd), generator=generator, device=device)
        self.R = nn.Parameter(r.mul_(2 * lim).sub_(lim).to(dtype))
        self.out_norm = RMSNorm(d, device=device, dtype=dtype)
        ff = (4 * d) // 3
        self.ffn = nn.Module()
        self.ffn.w_gate = Dense(d, ff, use_bias=False, **init)
        self.ffn.w_up = Dense(d, ff, use_bias=False, **init)
        self.ffn.w_down = Dense(ff, d, use_bias=False, **init)

    def forward(self, x, state: Optional[State] = None):
        """x (B, T, d); ``state`` {c, n, m, h}, each (B, H, hd) float32, or
        None (zeros, m = -1e30). Returns (x, new state)."""
        d, H = self.cfg.d_model, self.cfg.ssm.n_ssm_heads
        hd = d // H
        B, T, _ = x.shape
        xn = self.norm(x)
        # (4, T, B, H, hd) in float32: z, i, f, o before the recurrence
        gates = torch.stack([g(xn).reshape(B, T, H, hd).float()
                             for g in (self.w_z, self.w_i, self.w_f,
                                       self.w_o)]).transpose(1, 2)
        if state is None:
            zero = torch.zeros((B, H, hd), device=x.device)
            state = {"c": zero, "n": zero, "m": zero - 1e30, "h": zero}
        c, n, m, h = (state[key] for key in ("c", "n", "m", "h"))
        R = self.R.float()
        hs = []
        with span("slstm.loop"):
            # unbind: its backward stacks the steps' gradients once
            for zt, it, ft, ot in gates.unbind(1):
                rz, ri, rf, ro = torch.einsum("bhd,ghde->gbhe", h, R)
                z = torch.tanh(zt + rz)
                li = it + ri
                lf = F.logsigmoid(ft + rf)
                o = torch.sigmoid(ot + ro)
                m_new = torch.maximum(lf + m, li)
                fp = torch.exp(lf + m - m_new)
                ip = torch.exp(li - m_new)
                c = fp * c + ip * z
                n = fp * n + ip
                h = o * c / torch.clamp_min(n, 1e-6)
                m = m_new
                hs.append(h)
        out = torch.stack(hs, dim=1).reshape(B, T, d).to(x.dtype)
        x = x + self.out_norm(out)
        f = self.ffn
        x = x + f.w_down(ACTS["gelu"](f.w_gate(x)) * f.w_up(x))
        return x, {"c": c, "n": n, "m": m, "h": h}


def slstm_empty_state(cfg: ModelConfig, batch: int, device=None) -> State:
    H = cfg.ssm.n_ssm_heads
    zero = torch.zeros((batch, H, cfg.d_model // H), device=device)
    return {"c": zero, "n": zero.clone(), "m": zero - 1e30,
            "h": zero.clone()}
