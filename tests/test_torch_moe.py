"""The port's MoE layer on the CPU against ``repro.models.moe``: JAX params
loaded one to one, the same inputs made with numpy from a seed.

Outputs are held to 1e-5 (f32; the expert products and the combine sum in
other orders: JAX scatter-adds slots by expert, the port adds each token's
k slots in k order). Routing (expert ids, slots, drops) must be equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as jmoe
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe

TOL = 1e-5
B, S, D = 2, 24, 32
# (name, MoEConfig fields): capacity 2 of 6 mean assignments per expert
# drops; capacity_factor E / k gives capacity S (no drops); shared experts
CASES = {
    "drops": dict(n_experts=8, top_k=2, d_ff_expert=16, capacity_factor=0.5),
    "dropless": dict(n_experts=4, top_k=2, d_ff_expert=16,
                     capacity_factor=2.0),
    "shared": dict(n_experts=4, top_k=3, d_ff_expert=8, capacity_factor=4.0,
                   n_shared_experts=2),
}


def _load(params, cfg: MoEConfig) -> moe.MoE:
    """A port MoE holding the JAX param dict."""
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[f"{prefix}{k}"] = torch.from_numpy(np.array(v))
    walk(params, "")
    layer = moe.MoE(D, cfg, device="meta")
    layer.load_state_dict(flat, strict=True, assign=True)
    return layer


def _jax_results(params, x, c):
    """JAX's ``apply``, dense reference, routing and drop rate on x."""
    w, idx, _ = jmoe.route(params, x, c)
    return dict(apply=jmoe.apply(params, x, c),
                dense=jmoe.apply_dense_reference(params, x, c),
                weights=w, idx=idx, drop_rate=jmoe.drop_rate(idx, c))


@pytest.fixture(scope="module")
def pairs():
    """Per case: the JAX params, the port layer, the inputs, and JAX's
    results on them (one ``jax.jit`` a case)."""
    x = np.random.default_rng(0).normal(size=(B, S, D)).astype(np.float32)
    out = {}
    for i, (name, kw) in enumerate(CASES.items()):
        jcfg, cfg = JMoEConfig(**kw), MoEConfig(**kw)
        params = jmoe.init(jax.random.PRNGKey(i), D, jcfg)
        want = jax.jit(lambda p, x, c=jcfg: _jax_results(p, x, c))(
            params, jnp.asarray(x))
        out[name] = dict(cfg=cfg, layer=_load(params, cfg), x=x, want=want)
    return out


def test_config_matches_jax():
    for kw in CASES.values():
        assert dataclasses.asdict(MoEConfig(**kw)) == \
            dataclasses.asdict(JMoEConfig(**kw))
    assert [f.name for f in dataclasses.fields(MoEConfig)] == \
        [f.name for f in dataclasses.fields(JMoEConfig)]


@pytest.mark.parametrize("name", list(CASES))
def test_apply_matches_jax(pairs, name):
    p = pairs[name]
    want, want_aux = p["want"]["apply"]
    with torch.no_grad():
        got, aux = p["layer"](torch.from_numpy(p["x"]))
    assert got.shape == (B, S, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=TOL)


@pytest.mark.parametrize("name", ["dropless", "shared"])
def test_dense_reference_matches_jax_and_apply(pairs, name):
    """Without drops the capacity path is the dense oracle, in both
    packages."""
    p = pairs[name]
    want, _ = p["want"]["dense"]
    xt = torch.from_numpy(p["x"])
    dense, _ = moe.apply_dense_reference(p["layer"], xt)
    got, _ = moe.apply(p["layer"], xt)
    np.testing.assert_allclose(dense.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.detach().numpy(), dense.detach().numpy(),
                               rtol=TOL, atol=TOL)


def test_drops_differ_from_dense_reference(pairs):
    """At capacity 2 the capacity path drops assignments, so it is not the
    dense oracle (the residual carries the dropped tokens)."""
    p = pairs["drops"]
    xt = torch.from_numpy(p["x"])
    got, _ = moe.apply(p["layer"], xt)
    dense, _ = moe.apply_dense_reference(p["layer"], xt)
    assert float((got - dense).abs().max().detach()) > 1e-2


@pytest.mark.parametrize("name", list(CASES))
def test_routing_and_drop_rate_match_jax(pairs, name):
    p = pairs[name]
    w, idx, _ = moe.route(p["layer"], torch.from_numpy(p["x"]), p["cfg"])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(p["want"]["idx"]))
    np.testing.assert_allclose(w.detach().numpy(),
                               np.asarray(p["want"]["weights"]), rtol=TOL,
                               atol=TOL)
    rate = float(moe.drop_rate(idx, p["cfg"]))
    # the same assignments dropped; the two means round differently
    assert rate == pytest.approx(float(p["want"]["drop_rate"]), rel=1e-6)
    assert (rate > 0) == (name == "drops")


@pytest.mark.parametrize("cap", [1, 3, 7, 40])
def test_dispatch_indices_match_jax(cap):
    """Slots, tokens, positions and weights equal to JAX's (vmapped over
    rows), with assignments over capacity dropped, never written into slot
    cap - 1."""
    rng = np.random.default_rng(cap)
    e, k = 6, 3
    idx = np.stack([np.stack([rng.permutation(e)[:k] for _ in range(S)])
                    for _ in range(B)]).astype(np.int32)
    w = rng.random((B, S, k)).astype(np.float32)
    want = jax.vmap(lambda ei, wi: jmoe._dispatch_indices(ei, e, cap, wi))(
        jnp.asarray(idx), jnp.asarray(w))
    got = moe._dispatch_indices(torch.from_numpy(idx), e, cap,
                                torch.from_numpy(w))
    for name, g, j in zip(("src", "src_ok", "pos", "w_slot"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j), err_msg=name)


def test_tied_probabilities_route_to_the_lower_expert_first():
    """Equal router columns give equal probabilities: ``lax.top_k`` keeps
    the lower expert index first, and so must the port (a stable descending
    sort; ``torch.topk`` promises no order)."""
    kw = dict(n_experts=6, top_k=3, d_ff_expert=8, capacity_factor=4.0)
    jcfg, cfg = JMoEConfig(**kw), MoEConfig(**kw)
    params = jmoe.init(jax.random.PRNGKey(7), D, jcfg)
    w = np.array(params["router"]["w"])
    w[:, 1] = w[:, 4] = w[:, 5] = w[:, 2]        # four experts tie
    params["router"]["w"] = jnp.asarray(w)
    x = np.random.default_rng(8).normal(size=(B, S, D)).astype(np.float32)
    _, jidx, _ = jmoe.route(params, jnp.asarray(x), jcfg)
    _, idx, _ = moe.route(_load(params, cfg), torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    tied = np.isin(idx.numpy(), [1, 2, 4, 5])
    assert tied.sum(-1).max() >= 2      # some token picks tied experts
    for row in idx.numpy().reshape(-1, 3):
        picked = [i for i in row if i in (1, 2, 4, 5)]
        assert picked == sorted(picked)


def test_init_draws_within_jax_limits_from_seed():
    cfg = MoEConfig(**CASES["shared"])

    def make(seed):
        return moe.MoE(D, cfg, generator=torch.Generator().manual_seed(seed),
                       dtype=torch.bfloat16)
    a, b = make(3), make(3)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert p.dtype == torch.bfloat16 and torch.equal(p, q), name
    lim = (1.0 / D) ** 0.5
    assert a.w_up.shape == (4, D, 8)
    assert float(a.w_up.detach().abs().max()) <= lim
    sff = 8 * cfg.n_shared_experts
    assert a.shared.w_down.shape == (sff, D)
    assert float(a.shared.w_down.detach().abs().max()) <= (1.0 / sff) ** 0.5
    assert not torch.equal(make(4).w_gate, a.w_gate)
