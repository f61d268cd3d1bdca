"""MeshGraphNet / X-MeshGraphNet model (paper SII + SIII-D) as an
``nn.Module``.

Encoder -> ``n_mp_layers`` message-passing layers (distinct params, residual
edge and node updates, MLPs with trailing LayerNorm) -> decoder. The
processor's receiver scatter-add and the backward of its two edge gathers
(``h[senders]``, ``h[receivers]``) go through ``kernels.segment_agg``: a
receiver CSR and a sender CSR are built once per graph, outside the layer
loop and the remat boundary, and each layer runs the CUDA kernels on the
card or their plain versions on the CPU. ``masked_mse`` and ``loss_fn`` are
the training loss. ``apply`` marks ``encoder``, ``processor`` and
``decoder`` with spans (``telemetry.span``) for ``torch.profiler``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import GNNConfig
from repro_torch.device import resolve
from repro_torch.kernels.segment_agg import ops as segops
from repro_torch.models.nn import MLP
from repro_torch.telemetry import span


class MeshGraphNet(nn.Module):
    """Parameters named as in the JAX pytree: ``node_encoder``,
    ``edge_encoder``, ``proc_edge[i]``, ``proc_node[i]``, ``decoder``."""

    def __init__(self, cfg: GNNConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden
        hid = [h] * cfg.mlp_layers

        def mlp(dims, ln=True):
            return MLP(dims, cfg.act, final_layernorm=ln, generator=generator)

        self.node_encoder = mlp([cfg.node_in_eff] + hid + [h])
        self.edge_encoder = mlp([cfg.edge_in] + hid + [h])
        self.proc_edge = nn.ModuleList(mlp([3 * h] + hid + [h])
                                       for _ in range(cfg.n_mp_layers))
        self.proc_node = nn.ModuleList(mlp([2 * h] + hid + [h])
                                       for _ in range(cfg.n_mp_layers))
        self.decoder = mlp([h] + hid + [cfg.node_out], ln=False)

    def apply(self, node_feats, edge_feats, senders, receivers,
              edge_mask: Optional[torch.Tensor] = None):
        """Forward pass on one graph.

        node_feats (N, node_in); edge_feats (E, edge_in); senders/receivers
        (E,) int; edge_mask (E,) 1.0 for real edges. Returns (N, node_out).
        """
        n_nodes = node_feats.shape[0]
        send, recv = senders.long(), receivers.long()
        # the CSRs, once per graph: masked edges are left out of both (their
        # messages, and their rows of the gathers' gradient, are zero)
        send_csr = segops.prepare(senders, n_nodes, edge_mask)
        recv_csr = segops.prepare(receivers, n_nodes, edge_mask)
        m = None if edge_mask is None else edge_mask[:, None].to(
            edge_feats.dtype)
        with span("encoder"):
            h = self.node_encoder(node_feats)
            e = self.edge_encoder(edge_feats)
            if m is not None:
                e = e * m

        def mp_layer(pe, pn, h, e):
            msg_in = torch.cat([segops.gather_rows(h, send, send_csr),
                                segops.gather_rows(h, recv, recv_csr), e],
                               dim=-1)
            e_new = e + pe(msg_in)
            if m is not None:
                e_new = e_new * m
            agg = segops.segment_sum_prepared(recv_csr, e_new)
            return h + pn(torch.cat([h, agg], dim=-1)), e_new

        # activation checkpointing (paper SV-D), as jax.checkpoint with
        # nothing_saveable around the JAX layer: only the (h, e) carries are
        # kept, and each layer is recomputed in the backward pass. Without
        # autograd (serving) there is nothing to save.
        remat = self.cfg.remat and torch.is_grad_enabled()
        with span("processor"):
            for pe, pn in zip(self.proc_edge, self.proc_node):
                if remat:
                    h, e = checkpoint(mp_layer, pe, pn, h, e,
                                      use_reentrant=False)
                else:
                    h, e = mp_layer(pe, pn, h, e)
        with span("decoder"):
            return self.decoder(h)

    forward = apply

    def leaves(self) -> List[Tuple[str, nn.Parameter]]:
        """``(name, parameter)`` in the JAX pytree's leaf order: dict keys
        sorted at every level, list items in order, and a stacked
        ``proc_edge``/``proc_node`` leaf as its ``n_mp_layers`` tensors in
        layer order. ``optim.adam.global_norm`` sums in this order, as
        JAX's sums the pytree's leaves."""
        def key(name):
            parts = [int(p) if p.isdigit() else p for p in name.split(".")]
            if parts[0] in ("proc_edge", "proc_node"):
                parts = [parts[0], *parts[2:], parts[1]]
            return parts
        return sorted(self.named_parameters(), key=lambda kv: key(kv[0]))

    def step(self, node_feats, edge_feats, senders, receivers, state, *,
             edge_mask: Optional[torch.Tensor] = None, out_stats=None,
             cfg: Optional[GNNConfig] = None):
        """One autoregressive physics step: state (N, node_out) -> state'.

        With ``cfg.rollout_state_feats`` the state, normalized by
        ``out_stats`` (mean, std), is appended to the node features; the
        prediction is denormalized by ``out_stats`` before integration
        (``'direct'``: state' = pred, ``'residual'``: state' = state + pred).
        ``cfg`` (default: the model's) supplies the two rollout fields, as
        the JAX ``step(params, cfg, ...)`` takes the caller's config.
        """
        cfg = self.cfg if cfg is None else cfg
        feats = node_feats
        if cfg.rollout_state_feats:
            s = state
            if out_stats is not None:
                s = (state - out_stats[0]) / out_stats[1]
            feats = torch.cat([feats, s.to(feats.dtype)], dim=-1)
        pred = self.apply(feats, edge_feats, senders, receivers,
                          edge_mask=edge_mask)
        if out_stats is not None:
            pred = pred * out_stats[1] + out_stats[0]
        if cfg.rollout_integrator == "residual":
            return state + pred
        if cfg.rollout_integrator != "direct":
            raise ValueError(f"unknown rollout_integrator "
                             f"{cfg.rollout_integrator!r} "
                             "(expected 'direct' | 'residual')")
        return pred


def init(generator: torch.Generator, cfg: GNNConfig,
         device=None) -> MeshGraphNet:
    """Random weights from ``generator`` (a CPU generator, so the numbers do
    not depend on the device), moved to ``device`` (default: the card)."""
    return MeshGraphNet(cfg, generator=generator).to(resolve(device))


def masked_mse(pred, target, mask, denom=None):
    """Sum of squared errors over masked nodes, divided by ``denom``.

    With ``denom = total_owned_nodes * node_out`` summed across partitions,
    partition losses add up exactly to the full-graph mean-squared error
    (paper SIII-A: halo nodes are filtered out before the loss).
    """
    se = torch.sum(torch.square(pred - target) * mask[:, None])
    if denom is None:
        denom = torch.clamp(torch.sum(mask) * pred.shape[-1], min=1.0)
    return se / denom


def loss_fn(model: MeshGraphNet, batch, denom=None):
    """batch keys: node_feats, edge_feats, senders, receivers, targets,
    loss_mask (owned nodes), optional edge_mask."""
    pred = model.apply(batch["node_feats"], batch["edge_feats"],
                       batch["senders"], batch["receivers"],
                       edge_mask=batch.get("edge_mask"))
    return masked_mse(pred, batch["targets"], batch["loss_mask"], denom)
