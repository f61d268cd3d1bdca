"""The plain references against the port on the CPU, at reduced sizes: the
geometry and sampling copies bit-equal, the exact kNN and the multi-scale
union against the hash-grid build, the MeshGraphNet and X-UNet3D forwards
with the benchmark's weights, the reference's blocked volume against its
whole-grid forward, and the TF32 stand-in."""
import numpy as np
import pytest
import torch

from perfbench import geometry
from perfbench.reference import gnn, unet
from perfbench.weights import program_module


def test_geometry_copies_are_bit_equal_to_the_program():
    from repro_torch.core.graph_build import sample_surface
    from repro_torch.data import geometry as prog
    for i, (nu, nv) in enumerate([(64, 32), (40, 12)]):
        v, f = geometry.car_surface(geometry.sample_params(i), nu=nu, nv=nv)
        pv, pf = prog.car_surface(prog.sample_params(i), nu=nu, nv=nv)
        assert np.array_equal(v, pv) and np.array_equal(f, pf)
        a = geometry.sample_surface(v, f, 300, np.random.default_rng((7, i)))
        b = sample_surface(pv, pf, 300, np.random.default_rng((7, i)))
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        params = geometry.sample_params(i)
        assert np.array_equal(geometry.surface_fields(a[0], a[1], params),
                              prog.surface_fields(a[0], a[1], params))


@pytest.fixture(scope="module")
def cloud():
    v, f = geometry.car_surface(geometry.sample_params(3))
    pts, nrm = geometry.sample_surface(v, f, 1024, np.random.default_rng(5))
    return torch.from_numpy(pts), torch.from_numpy(nrm)


def test_exact_knn_and_union_match_the_hash_grid_build(cloud):
    from repro_torch.graphx import hashgrid
    from repro_torch.graphx.multiscale import (MultiscaleSpec,
                                               multiscale_edges)
    pts = cloud[0]
    levels = (256, 512, 1024)
    grids = tuple(hashgrid.calibrate_spec(pts[:m].numpy(), 6, n_points=m)
                  for m in levels)
    idx, _ = gnn.knn(pts, 6, block=100)
    assert torch.equal(idx, gnn.knn(pts, 6, f32=True, block=100)[0])
    got, _, _ = hashgrid.knn(pts, 1024, grids[-1])
    assert torch.equal(idx.sort(1).values, got.long().sort(1).values)
    s, r = gnn.multiscale_graph(pts, levels, 6)
    ps, pr, pm = multiscale_edges(pts, 1024, MultiscaleSpec(levels, 6, grids))
    key = torch.sort(ps[pm].long() * 1024 + pr[pm].long()).values
    assert torch.equal(key, s * 1024 + r)


def test_meshgraphnet_forward_matches_the_program(cloud):
    from repro_torch.configs.base import GNNConfig
    from repro_torch.graphx import features
    from repro_torch.models.meshgraphnet import MeshGraphNet
    cfg = GNNConfig(hidden=32, n_mp_layers=3)
    W = gnn.init_weights(cfg, 11, "cpu")
    model = program_module(lambda: MeshGraphNet(cfg), W, "cpu")
    pts, nrm = cloud
    s, r = gnn.multiscale_graph(pts, (256, 512, 1024), 6)
    nf = gnn.node_features(pts, nrm, cfg.fourier_freqs)
    assert torch.allclose(nf, features.node_input_features(
        pts, nrm, cfg.fourier_freqs), atol=1e-6)
    ef = gnn.edge_features(pts, s, r)
    with torch.no_grad():
        want = model.apply(nf, ef, s, r)
    got = gnn.forward(W, cfg, nf, ef, s, r)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    tf32 = gnn.forward(W, cfg, nf, ef, s, r, tf32=True)
    err = float((tf32 - want).abs().max() / want.abs().max())
    assert 1e-5 < err < 1e-1


def test_an_exact_f32_tie_gives_every_right_neighbour_set():
    # point 0's neighbours: 1 at d2 1, then 2 and 3 both at d2 4 (and 1's
    # second one ties too); 2 and 3 have nearer neighbours of their own
    pts = torch.tensor([[0., 0, 0], [1, 0, 0], [0, 2, 0], [0, 0, -2],
                        [0, 2.5, 0], [0, 2.5, 0.5], [0, 0, -2.5],
                        [0, 0.5, -2.5]])
    idx, ties = gnn.knn(pts, 2, f32=True)
    assert idx[0].tolist() == [1, 2]
    (q, near, tied), = [t for t in ties if t[0] == 0]
    assert near.tolist() == [1] and tied.tolist() == [2, 3]
    graphs = list(gnn.multiscale_graphs(pts, (8,), 2, f32=True))
    with_30 = [(3, 0) in set(zip(s.tolist(), r.tolist())) for s, r in graphs]
    assert len(graphs) == 4 and with_30 == [False, False, True, True]


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -2.5])
    assert gnn.round_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0,
                                          1.0 + 2 ** -9, -2.5]


def test_xunet_forward_and_blocks_match_the_program():
    from repro_torch.configs.base import UNetConfig
    from repro_torch.models.xunet3d import XUNet3D
    cfg = UNetConfig(base_channels=4, depth=3, grid=(32, 8, 8))
    W = unet.init_weights(cfg, 5, "cpu")
    model = program_module(lambda: XUNet3D(cfg), W, "cpu")
    x = torch.randn((1, 32, 8, 8, 16), generator=torch.Generator()
                    .manual_seed(1))
    with torch.no_grad():
        want = model.apply(x)
    whole = unet.forward(W, cfg, x.permute(0, 4, 1, 2, 3)).permute(
        0, 2, 3, 4, 1)
    assert torch.allclose(whole, want, rtol=1e-5, atol=1e-6)
    blocked = unet.volume_fields(W, cfg, x, block=8, halo=28)
    assert torch.allclose(blocked, want, rtol=1e-5, atol=1e-6)
