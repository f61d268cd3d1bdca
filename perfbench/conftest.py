"""Shared set-up of the benchmark's CPU tests: every cell at a size a test
run holds, torch on one thread (the suite runs several workers)."""
import pytest
import torch

SMALL = {
    "xmgn-serve-65k": {
        "config": {"hidden": 32, "n_mp_layers": 2, "halo": 2},
        "traffic": {"clients": 2, "points": 512, "cars": 2, "nu": 32,
                    "nv": 16},
        "server": {"bucket_sizes": [512]}},
    "xmgn-serve-8k": {
        "config": {"hidden": 32, "n_mp_layers": 2, "halo": 2},
        "traffic": {"clients": 2, "points": 256, "cars": 2, "nu": 32,
                    "nv": 16},
        "server": {"bucket_sizes": [256]}},
    "xmgn-train-8part": {
        "config": {"hidden": 32, "n_mp_layers": 2, "halo": 2,
                   "levels": [128, 256, 512], "n_partitions": 2},
        "traffic": {"sample_ids": [0, 1, 2]}},
    "xunet3d-pass": {
        "config": {"base_channels": 4, "depth": 2, "grid": [16, 8, 8],
                   "halo": 8, "n_partitions": 2},
        "traffic": {"align": 2}, "check": {"block": 8, "halo": 8}},
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small():
    return SMALL
