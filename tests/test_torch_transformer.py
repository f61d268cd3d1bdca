"""The port's dense decoder on the CPU against ``repro.models`` (reduced
gemma2 and two variants): JAX params converted by ``transformer_from_jax``,
the same tokens.

Tolerance 1e-4 against JAX (f32 throughout; matmul and softmax orders
differ, and prefill attention is the flash reference rather than
``_attend``). The port's own prefill/decode consistency is held to 2e-3, as
``tests/test_archs_smoke.py`` holds JAX's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import registry as jregistry
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.models import registry, transformer as tfm
from repro_torch.models.convert import transformer_from_jax
from repro_torch.models.nn import ACTS

TOL = 1e-4
B, S = 2, 32

VARIANTS = {
    "gemma2": {},
    "qk_norm_tied": dict(qk_norm=True, tie_embeddings=True),
    "global_layernorm_mlp": dict(
        layer_pattern="global", norm="layernorm", glu=False, act="silu",
        post_norms=False, scale_embeddings=False, attn_softcap=None,
        final_softcap=None, sliding_window=None),
}


def _pair(variant: str, seed: int = 0):
    kw = VARIANTS[variant]
    jcfg = jax_get_config("gemma2-9b").reduced().replace(**kw)
    cfg = get_config("gemma2-9b").reduced().replace(**kw)
    japi = jregistry.get_model(jcfg)
    params = japi.init(jax.random.PRNGKey(seed))
    model = transformer_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 cfg, device="cpu")
    return japi, params, registry.get_model(cfg), model


def _tokens(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _jax_cache(cache):
    return {n: np.asarray(cache["blocks"][n]) for n in ("k", "v")}


def test_config_matches_jax():
    """Every field the port keeps equals the JAX config's, full and
    reduced."""
    for full in (True, False):
        jcfg = jax_get_config("gemma2-9b")
        cfg = get_config("gemma2-9b")
        if not full:
            jcfg, cfg = jcfg.reduced(), cfg.reduced()
        for f in dataclasses.fields(ModelConfig):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert cfg.padded_vocab == jcfg.padded_vocab
        assert cfg.resolved_head_dim == jcfg.resolved_head_dim


def test_unknown_config_and_family_raise():
    """A config name neither package has raises; the family is read from
    the config's fields (Mamba2 blocks and ``attn_every``: the hybrid
    stack), as JAX's ``get_model`` reads it."""
    with pytest.raises(KeyError, match="repro.configs"):
        get_config("zamba2-7b")
    api = registry.get_model(get_config("gemma2-9b").replace(
        family="hybrid", ssm=SSMConfig(kind="mamba2"), attn_every=6))
    assert api.init.__qualname__.startswith("_hybrid_api")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_matches_jax(variant):
    japi, params, api, model = _pair(variant)
    toks = _tokens(api.cfg)
    jl, jc = jax.jit(japi.prefill)(params, {"tokens": jnp.asarray(toks)})
    tl, tc = api.prefill(model, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    for name, want in _jax_cache(jc).items():
        assert tuple(tc[name].shape) == want.shape
        np.testing.assert_allclose(tc[name].numpy(), want, rtol=TOL,
                                   atol=TOL)


def _pad(cache, s_max, dtype):
    """The test_archs_smoke padding: to s_max slots, in the given dtype."""
    out = {}
    for name, c in cache.items():
        t = np.zeros(c.shape[:3] + (s_max,) + c.shape[4:], dtype)
        t[:, :, :, :c.shape[3]] = c
        out[name] = t
    return out


@pytest.mark.parametrize("variant", ["gemma2", "qk_norm_tied"])
def test_decode_matches_jax(variant):
    """Prefill S-1 tokens, then decode token S-1 at position S-1, each
    framework from its own prefill cache padded in f32."""
    japi, params, api, model = _pair(variant, seed=2)
    toks = _tokens(api.cfg, seed=3)
    _, jc = jax.jit(japi.prefill)(params,
                                   {"tokens": jnp.asarray(toks[:, :-1])})
    jcache = {"blocks": {n: jnp.asarray(a) for n, a in
                         _pad(_jax_cache(jc), S, np.float32).items()}}
    jl, _ = jax.jit(japi.decode)(params, jcache,
                                 {"tokens": jnp.asarray(toks[:, -1:])},
                                 jnp.asarray(S - 1, jnp.int32))
    _, tc = api.prefill(model, {"tokens": torch.from_numpy(toks[:, :-1])})
    tcache = {n: torch.from_numpy(a) for n, a in
              _pad({n: t.numpy() for n, t in tc.items()}, S,
                   np.float32).items()}
    tl, out_cache = api.decode(model, tcache,
                               {"tokens": torch.from_numpy(toks[:, -1:])},
                               S - 1)
    assert out_cache is tcache                      # updated in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)


def test_prefill_decode_consistency():
    """decode(token_t | prefill cache of tokens_<t) equals the full prefill's
    logits at t (the port alone, as test_archs_smoke checks JAX)."""
    cfg = get_config("gemma2-9b").reduced()
    api = registry.get_model(cfg)
    model = api.init(seed=1, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, seed=4))
    full, _ = api.prefill(model, {"tokens": toks})
    _, cache = api.prefill(model, {"tokens": toks[:, :-1]})
    target = tfm.empty_cache(cfg, B, S, dtype=torch.float32)
    for name, c in cache.items():
        target[name][:, :, :, :S - 1] = c
    got, _ = api.decode(model, target, {"tokens": toks[:, -1:]}, S - 1)
    np.testing.assert_allclose(got[:, -1].numpy(), full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_transformer_from_jax_splits_groups_and_checks():
    japi, params, api, model = _pair("gemma2")
    tree = jax.tree_util.tree_map(np.asarray, params)
    assert len(model.blocks) == 1 and len(model.blocks[0].layers) == 2
    np.testing.assert_array_equal(
        model.blocks[0].layers[1].attn.wk.w.detach().numpy(),
        tree["blocks"]["layers"][1]["attn"]["wk"]["w"][0])
    assert model.lm_head.w.shape == (api.cfg.d_model, api.cfg.padded_vocab)
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    del bad["blocks"]["layers"][0]["ln1_post"]
    with pytest.raises(KeyError):
        transformer_from_jax(bad, api.cfg, device="cpu")
    with pytest.raises(ValueError, match="groups"):   # 4 layers = 2 groups
        transformer_from_jax(tree, api.cfg.replace(n_layers=4), device="cpu")


def test_init_on_device_in_dtype_from_seed():
    cfg = get_config("gemma2-9b").reduced().replace(dtype="bfloat16")
    api = registry.get_model(cfg)
    a, b = api.init(seed=3, device="cpu"), api.init(seed=3, device="cpu")
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert p.dtype == torch.bfloat16 and p.device.type == "cpu", name
        assert torch.equal(p, q), name
    w = a.blocks[0].layers[0].mlp.w_up.w
    assert tuple(w.shape) == (cfg.d_model, cfg.d_ff)          # (in, out)
    assert w.float().abs().max() <= (1.0 / cfg.d_model) ** 0.5
    assert not api.init(seed=4, device="cpu").embed.table.equal(a.embed.table)


def test_gelu_is_jax_tanh_approximation():
    x = np.linspace(-8.0, 8.0, 4001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = ACTS["gelu"](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
