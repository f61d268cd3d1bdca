"""Plain PyTorch reference of X-MeshGraphNet (arXiv:2411.17164 SIII, SV):
the multi-scale kNN graph, the features, the MeshGraphNet forward, the
full-graph loss and its gradients, and Adam with cosine annealing and
global-norm clipping.

Written from the paper's equations and the configuration alone. It imports
nothing of the program and takes nothing the program made: the graph is
built by an exact brute-force kNN over each nested level, every feature
and normalizer is computed here again, and the weights come from
:func:`init_weights`, the benchmark's own draw from the seed, which the
benchmark hands to both sides.

The kNN orders candidates by their squared distance: in f64 for training,
whose graph the program builds on the host in f64, and for serving in f32
as the serving path takes it, where an exact tie at the k-th neighbour
(about one request in 600 at 8,192 points) makes more than one neighbour
set right, and each is tried. ``tf32=True`` is the control: every matrix product in
TF32 (on the card the tensor cores' own, on the CPU the inputs rounded to
TF32's 10-bit mantissa), the step below f32 that the configuration states.
"""
from __future__ import annotations

import contextlib
import itertools
import math
from typing import Dict, List, Sequence, Tuple

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

Weights = Dict[str, torch.Tensor]


# ------------------------------------------------------------------ weights

def _mlp_spec(prefix: str, dims: Sequence[int], ln: bool):
    out = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out += [(f"{prefix}.layers.{i}.w", (a, b)),
                (f"{prefix}.layers.{i}.b", (b,))]
    if ln:
        out += [(f"{prefix}.ln.scale", (dims[-1],)),
                (f"{prefix}.ln.bias", (dims[-1],))]
    return out


def param_spec(cfg) -> List[Tuple[str, Tuple[int, ...]]]:
    """``(name, shape)`` of every weight: an encoder MLP for nodes and one
    for edges, per processor layer an edge MLP over [h_s, h_r, e] and a
    node MLP over [h, agg], all with a trailing LayerNorm, and a decoder
    MLP without one. A dense layer's ``w`` is (in, out)."""
    h = cfg.hidden
    hid = [h] * cfg.mlp_layers
    spec = _mlp_spec("node_encoder", [cfg.node_in] + hid + [h], True)
    spec += _mlp_spec("edge_encoder", [cfg.edge_in] + hid + [h], True)
    for i in range(cfg.n_mp_layers):
        spec += _mlp_spec(f"proc_edge.{i}", [3 * h] + hid + [h], True)
    for i in range(cfg.n_mp_layers):
        spec += _mlp_spec(f"proc_node.{i}", [2 * h] + hid + [h], True)
    return spec + _mlp_spec("decoder", [h] + hid + [cfg.node_out], False)


def init_weights(cfg, seed: int, device) -> Weights:
    """The benchmark's weights: every dense ``w`` uniform in
    +-sqrt(1 / fan_in), drawn in one call on ``device`` from a generator
    seeded with ``seed``; biases 0, LayerNorm scales 1."""
    spec = param_spec(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n_w = sum(math.prod(s) for n, s in spec if n.endswith(".w"))
    flat = torch.rand(n_w, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in spec:
        if name.endswith(".w"):
            n = math.prod(shape)
            lim = math.sqrt(1.0 / shape[0])
            out[name] = flat[at:at + n].view(shape).mul(2 * lim).sub_(lim)
            at += n
        elif name.endswith(".scale"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


# ------------------------------------------------------------ precisions

def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32's 10-bit mantissa, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products and convolutions in f32 (TF32 off), or in TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class _TF32MatMul(torch.autograd.Function):
    """``x @ w`` with TF32 operands, forward and backward (the CPU's stand-in
    for the tensor cores' TF32)."""

    @staticmethod
    def forward(ctx, x, w):
        xr, wr = round_tf32(x), round_tf32(w)
        ctx.save_for_backward(xr, wr)
        return xr @ wr

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = round_tf32(g)
        return gr @ wr.T, xr.T @ gr


def matmul(x, w, tf32: bool):
    if tf32 and not x.is_cuda:
        return _TF32MatMul.apply(x, w)
    return x @ w


# ------------------------------------------------------------------- graph

def knn(points: torch.Tensor, k: int, *, f32: bool = False,
        block: int = 0):
    """Exact k nearest neighbours of every point among the others:
    ``(idx (n, k) i64, ties)``.

    By default the squared distance is taken in f64, where these clouds
    have no ties. ``f32=True`` takes it as the f32 serving path states it,
    ``(dx*dx + dy*dy) + dz*dz`` rounded at each step, and orders an exact
    tie by the lower id; ``ties`` then lists, for each point whose k-th and
    (k+1)-th candidates lie at the same f32 distance, ``(point, the
    neighbours nearer than that distance, every candidate at it)``: any
    choice among the latter is a k-nearest set of equal right."""
    n = points.shape[0]
    pts = points.contiguous().double() if not f32 else \
        points.contiguous().float()
    block = block or max(1, (1 << 25) // max(n, 1))
    ids = torch.arange(n, device=pts.device)
    idx, ties = [], []
    for q0 in range(0, n, block):
        q = pts[q0:q0 + block]
        rows = torch.arange(q.shape[0], device=pts.device)
        if not f32:
            d2 = torch.square(pts[None, :, :] - q[:, None, :]).sum(-1)
            d2[rows, q0 + rows] = math.inf
            idx.append(torch.topk(d2, k, dim=1, largest=False).indices)
            continue
        dx, dy, dz = (pts[None, :, :] - q[:, None, :]).unbind(-1)
        d2 = (dx * dx + dy * dy) + dz * dz
        # (f32 bits, id): d2 >= 0, so the key orders by distance, then id
        key = (d2.view(torch.int32).to(torch.int64) << 32) | ids[None, :]
        key[rows, q0 + rows] = torch.iinfo(torch.int64).max
        top = torch.topk(key, k + 1, dim=1, largest=False).values
        idx.append(top[:, :k] & 0xFFFFFFFF)
        for r in ((top[:, k - 1] >> 32) == (top[:, k] >> 32)).nonzero()[:, 0]:
            at = key[r] >> 32
            edge = at[top[r, k - 1] & 0xFFFFFFFF]
            ties.append((q0 + int(r), (at < edge).nonzero()[:, 0],
                         (at == edge).nonzero()[:, 0]))
    return torch.cat(idx), ties


def multiscale_graphs(points: torch.Tensor, level_sizes: Sequence[int],
                      k: int, *, f32: bool = False, limit: int = 16):
    """The union over the nested levels (prefixes of ``points``) of each
    level's symmetric kNN edges, every directed edge once, as ``(senders,
    receivers)`` i64 sorted by (sender, receiver): one graph for each way of
    choosing among the exact f32 ties of :func:`knn` (the lower ids first),
    at most ``limit``."""
    n = points.shape[0]
    levels = [knn(points[:n_l], k, f32=f32) for n_l in level_sizes]
    options = [[(lvl, q, torch.cat([near, torch.tensor(pick,
                                                      device=near.device)]))
                 for pick in itertools.combinations(tied.tolist(),
                                                    k - len(near))]
               for lvl, (_, ties) in enumerate(levels)
               for q, near, tied in ties]
    for choice in itertools.islice(itertools.product(*options), limit):
        keys = []
        for lvl, (n_l, (nbr, _)) in enumerate(zip(level_sizes, levels)):
            nbr = nbr.clone()
            for c_lvl, q, row in choice:
                if c_lvl == lvl:
                    nbr[q] = row
            rec = torch.arange(n_l, device=points.device)[:, None] \
                .expand_as(nbr)
            keys += [(nbr * n + rec).reshape(-1), (rec * n + nbr).reshape(-1)]
        key = torch.unique(torch.cat(keys))
        yield key // n, key % n


def multiscale_graph(points: torch.Tensor, level_sizes: Sequence[int],
                     k: int):
    """The multi-scale graph by f64 distances (no ties)."""
    return next(multiscale_graphs(points, level_sizes, k))


def node_features(points, normals, freqs: Sequence[float]):
    """Positions, normals and sin/cos of pi f x per frequency: 24 wide."""
    parts = [points, normals]
    for f in freqs:
        parts += [torch.sin(math.pi * f * points),
                  torch.cos(math.pi * f * points)]
    return torch.cat(parts, dim=-1)


def edge_features(points, senders, receivers):
    rel = points[senders] - points[receivers]
    return torch.cat([rel, torch.linalg.vector_norm(rel, dim=-1,
                                                     keepdim=True)], -1)


# ------------------------------------------------------------------- model

def layernorm(x, scale, bias, eps: float = 1e-5):
    mu = x.mean(-1, keepdim=True)
    var = torch.square(x - mu).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def mlp(W: Weights, prefix: str, x, n_layers: int, ln: bool, tf32: bool):
    for i in range(n_layers):
        x = matmul(x, W[f"{prefix}.layers.{i}.w"], tf32) \
            + W[f"{prefix}.layers.{i}.b"]
        if i < n_layers - 1:
            x = F.silu(x)
    if ln:
        x = layernorm(x, W[f"{prefix}.ln.scale"], W[f"{prefix}.ln.bias"])
    return x


def forward(W: Weights, cfg, node_feats, edge_feats, senders, receivers, *,
            tf32: bool = False, remat: bool = False):
    """MeshGraphNet over valid edges only: encode, ``n_mp_layers`` residual
    edge and node updates with a sum over each receiver's edges, decode.
    ``remat`` recomputes each layer in the backward pass, to fit the full
    training graph's activations on one card."""
    nl = cfg.mlp_layers + 1
    n = node_feats.shape[0]
    h = mlp(W, "node_encoder", node_feats, nl, True, tf32)
    e = mlp(W, "edge_encoder", edge_feats, nl, True, tf32)

    def layer(i, h, e):
        msg = torch.cat([h[senders], h[receivers], e], dim=-1)
        e = e + mlp(W, f"proc_edge.{i}", msg, nl, True, tf32)
        agg = torch.zeros((n, e.shape[1]), dtype=e.dtype, device=e.device)
        agg.index_add_(0, receivers, e)
        return h + mlp(W, f"proc_node.{i}", torch.cat([h, agg], -1), nl,
                       True, tf32), e

    for i in range(cfg.n_mp_layers):
        if remat and torch.is_grad_enabled():
            h, e = checkpoint(layer, i, h, e, use_reentrant=False)
        else:
            h, e = layer(i, h, e)
    return mlp(W, "decoder", h, nl, False, tf32)


@torch.no_grad()
def serve_fields(W: Weights, cfg, points, normals, level_sizes, *,
                 tf32: bool = False):
    """One served request's fields (n, node_out), over the graph of the
    serving path's f32 kNN: one for each way of choosing among its exact
    ties (almost always one)."""
    nf = node_features(points, normals, cfg.fourier_freqs)
    for s, r in multiscale_graphs(points, level_sizes, cfg.k_neighbors,
                                  f32=True):
        with precision(tf32):
            yield forward(W, cfg, nf, edge_features(points, s, r), s, r,
                          tf32=tf32)


# ---------------------------------------------------------------- training

def full_graph_loss_and_grads(W: Weights, cfg, g: dict, *,
                              tf32: bool = False, keep: float = 1.0):
    """Mean squared error over every node and output of the whole sample
    graph ``g`` (normalized inputs and targets), and its gradients.
    ``keep < 1`` is a planted fault: the loss of the first ``keep`` share
    of the nodes alone, its mean taken over them."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in W.items()}
    with precision(tf32):
        pred = forward(leaves, cfg, g["node_feats"], g["edge_feats"],
                       g["senders"], g["receivers"], tf32=tf32, remat=True)
        m = int(round(pred.shape[0] * keep))
        loss = torch.mean(torch.square(pred[:m] - g["targets"][:m]))
        loss.backward()
    return loss.detach(), {k: v.grad for k, v in leaves.items()}


def cosine_lr(opt: dict, step: int) -> float:
    t = min(max(step / max(opt["total_steps"], 1), 0.0), 1.0)
    return opt["lr_min"] + 0.5 * (opt["lr_max"] - opt["lr_min"]) * (
        1.0 + math.cos(math.pi * t))


def adam_step(opt: dict, W: Weights, grads: Weights, state: dict):
    """Clip the gradients to global norm ``clip_norm``, then one Adam step
    with the cosine learning rate (bias-corrected moments, no weight
    decay). Returns ``(new weights, clipped gradients)``; ``state`` holds
    ``step``, ``mu`` and ``nu`` and is updated in place."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads.values()))
    scale = torch.clamp(opt["clip_norm"] / (norm + 1e-12), max=1.0)
    state["step"] += 1
    t = state["step"]
    lr = cosine_lr(opt, t)
    b1, b2 = opt["b1"], opt["b2"]
    new, clipped = {}, {}
    for k, w in W.items():
        g = grads[k] * scale
        clipped[k] = g
        m = state["mu"].get(k, torch.zeros_like(w)) * b1 + (1 - b1) * g
        v = state["nu"].get(k, torch.zeros_like(w)) * b2 \
            + (1 - b2) * torch.square(g)
        state["mu"][k], state["nu"][k] = m, v
        new[k] = w - lr * (m / (1 - b1 ** t)) / (
            torch.sqrt(v / (1 - b2 ** t)) + opt["eps"])
    return new, clipped


def train_steps(W0: Weights, cfg, graphs: Sequence[dict], opt: dict, *,
                tf32: bool = False, keep: float = 1.0):
    """Follow the program's first steps, one graph a step: ``(losses,
    clipped first gradients, weights after the last step)``."""
    W, state = dict(W0), {"step": 0, "mu": {}, "nu": {}}
    losses, first = [], None
    for g in graphs:
        loss, grads = full_graph_loss_and_grads(W, cfg, g, tf32=tf32,
                                                keep=keep)
        W, clipped = adam_step(opt, W, grads, state)
        losses.append(float(loss))
        if first is None:
            first = clipped
        del grads
    return losses, first, W
