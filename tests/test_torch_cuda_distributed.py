"""The baseline's boundary exchange (``core.distributed_mgn.exchange``) on
CUDA tensors, on one card: at world size 1 through NCCL and at world size 2
through ``gloo``, two processes sharing the card.

This file imports no JAX, so it also runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_distributed.py

Each case spawns its ranks (``tests/_torch_dist_worker.spawn``, the
``spawn`` start method, a ``FileStore`` under ``tmp_path``); without a card
they skip."""
import pytest
import torch
import torch.distributed as dist

import _torch_dist_worker as worker
from repro_torch.core import distributed_mgn as dmgn
from repro_torch.core.gradient_aggregation import all_reduce

B, H = 37, 512


def _rows(rank: int, dev) -> torch.Tensor:
    g = torch.Generator().manual_seed(100 + rank)
    return torch.randn((B, H), generator=g).to(dev)


def exchange_job(rank: int, world: int, d):
    """The forward is every rank's rows in rank order, exactly; the
    backward of ``sum(w * y)``, the same ``w`` on every rank, is the sum
    over ranks of the rank's slot of ``w``: ``world`` times it, exactly
    (small integers); each direction is one collective."""
    dev = torch.device("cuda", 0)
    x = _rows(rank, dev).requires_grad_(True)
    w = torch.arange(world * B * H, dtype=torch.float32, device=dev
                     ).reshape(world * B, H) % 7
    c0 = all_reduce.collectives
    y = dmgn.exchange(x, dist.group.WORLD)
    want = torch.cat([_rows(r, dev) for r in range(world)])
    assert y.is_cuda and torch.equal(y.detach(), want)
    (w * y).sum().backward()
    assert torch.equal(x.grad, world * w[rank * B:(rank + 1) * B])
    assert all_reduce.collectives - c0 == 2


@pytest.mark.cuda
@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")])
def test_exchange_on_cuda_tensors(tmp_path, world, backend):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    worker.spawn(world, exchange_job, tmp_path, timeout=120.0,
                 backend=backend)
