"""The port's MeshGraphNet on the CPU against ``repro.models.meshgraphnet``:
JAX params loaded with ``params_from_jax``, the same graph and features.

Tolerance 1e-5 (f32 throughout; matmul and reduction orders differ)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import GNNConfig as JaxGNNConfig
from repro.models import meshgraphnet as jmgn
from repro_torch.configs.base import GNNConfig
from repro_torch.models import meshgraphnet as mgn
from repro_torch.models.convert import params_from_jax

TOL = 1e-5


def _graph(cfg, n=96, e=500, seed=0, masked=True):
    """Random features and edges; padding slots carry receiver 0."""
    rng = np.random.default_rng(seed)
    nf = rng.normal(size=(n, cfg.node_in)).astype(np.float32)
    ef = rng.normal(size=(e, cfg.edge_in)).astype(np.float32)
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    m = (rng.random(e) > 0.3) if masked else np.ones(e, bool)
    s, r = np.where(m, s, 0).astype(np.int32), np.where(m, r, 0).astype(
        np.int32)
    state = rng.normal(size=(n, cfg.node_out)).astype(np.float32)
    return nf, ef * m[:, None], s, r, m.astype(np.float32), state


def _pair(cfg_kw=None, seed=0):
    kw = cfg_kw or {}
    jcfg = JaxGNNConfig().reduced().replace(**kw)
    tcfg = GNNConfig().reduced().replace(**kw)
    params = jmgn.init(jax.random.PRNGKey(seed), jcfg)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg,
                            device="cpu")
    return jcfg, tcfg, params, model


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("masked", [True, False])
def test_apply_matches_jax(masked):
    jcfg, tcfg, params, model = _pair()
    nf, ef, s, r, m, _ = _graph(tcfg, masked=masked)
    want = np.asarray(jmgn.apply(params, jcfg, nf, ef, s, r,
                                 edge_mask=m if masked else None))
    with torch.no_grad():
        got = model.apply(*_t(nf, ef, s, r),
                          edge_mask=torch.from_numpy(m) if masked else None)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("integrator", ["direct", "residual"])
@pytest.mark.parametrize("state_feats", [False, True])
def test_step_matches_jax(integrator, state_feats):
    kw = dict(rollout_integrator=integrator, rollout_state_feats=state_feats)
    jcfg, tcfg, params, model = _pair(kw, seed=1)
    nf, ef, s, r, m, state = _graph(tcfg, seed=2)
    out_stats = (np.full((1, 4), 0.5, np.float32),
                 np.full((1, 4), 2.0, np.float32))
    want = np.asarray(jmgn.step(params, jcfg, nf, ef, s, r, state,
                                edge_mask=m, out_stats=out_stats))
    with torch.no_grad():
        got = model.step(*_t(nf, ef, s, r, state), edge_mask=torch.from_numpy(m),
                         out_stats=tuple(_t(*out_stats)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_params_from_jax_unstacks_layers_and_checks():
    jcfg, tcfg, params, model = _pair()
    tree = jax.tree_util.tree_map(np.asarray, params)
    assert len(model.proc_edge) == tcfg.n_mp_layers
    np.testing.assert_array_equal(
        model.proc_node[2].layers[1].w.detach().numpy(),
        tree["proc_node"]["layers"][1]["w"][2])
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    del bad["decoder"]["layers"][0]["b"]
    with pytest.raises(KeyError):
        params_from_jax(bad, tcfg, device="cpu")
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["node_encoder"]["ln"]["scale"] = np.ones(7, np.float32)
    with pytest.raises(ValueError):
        params_from_jax(bad, tcfg, device="cpu")
    with pytest.raises(ValueError):     # stacked axis != n_mp_layers
        params_from_jax(tree, tcfg.replace(n_mp_layers=2), device="cpu")


def test_init_lecun_limits_and_generator_determinism():
    cfg = GNNConfig().reduced()
    a = mgn.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    b = mgn.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        if name.endswith(".w"):
            assert p.abs().max() <= (1.0 / p.shape[0]) ** 0.5
        if name.endswith(".b"):
            assert not p.any()
    w = a.proc_edge[0].layers[0].w
    assert tuple(w.shape) == (3 * cfg.hidden, cfg.hidden)   # (in, out)
