"""The program's modules, holding the benchmark's weights.

The weights are drawn on the device from the seed by the reference's
``init_weights`` (one generator call) and handed to both sides: the program
gets a module built without storage (on the ``meta`` device), given storage
on the card, and filled by name, so nothing is drawn twice or on the host.
"""
from __future__ import annotations

from typing import Callable, Dict


def program_module(ctor: Callable, weights: Dict, device):
    """``ctor()`` built on ``meta``, moved to ``device`` and filled from
    ``weights``; its parameter names and shapes must be exactly those of
    ``weights``."""
    import torch
    with torch.device("meta"):
        module = ctor()
    module = module.to_empty(device=device)
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise ValueError(
            "the program's parameters are not the benchmark's weights: "
            f"missing {sorted(set(weights) - set(params))[:5]}, "
            f"unknown {sorted(set(params) - set(weights))[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            w = weights[name]
            if tuple(p.shape) != tuple(w.shape):
                raise ValueError(f"{name}: the program holds "
                                 f"{tuple(p.shape)}, the benchmark "
                                 f"{tuple(w.shape)}")
            p.copy_(w)
    return module
