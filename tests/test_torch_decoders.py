"""The port's decoders on the CPU against ``repro.models.transformer``, for
the six head_dim-128 configs, reduced: granite-3-8b, starcoder2-15b,
yi-34b (dense), deepseek-moe-16b (a dense first layer, shared experts),
qwen3-moe-30b-a3b (MoE, QK-norm) and pixtral-12b (the vision prefix).

JAX params (``PRNGKey(i)``) are carried over by ``transformer_from_jax``;
tokens and patch embeddings are made with numpy from a seed. Logits and
caches are held to 1e-5 (f32; matmul and softmax orders differ, and prefill
attention is the flash reference rather than ``_attend``). ``serve`` must
generate JAX's tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import SSMConfig as JSSMConfig
from repro.launch.serve import serve as jax_serve
from repro.models import registry as jregistry
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.launch.serve import serve
from repro_torch.models import registry, stacks
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import transformer_from_jax

TOL = 1e-5
B, S = 2, 20
ARCHS = ["granite-3-8b", "starcoder2-15b", "yi-34b", "deepseek-moe-16b",
         "qwen3-moe-30b-a3b", "pixtral-12b"]


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _batch(cfg, seed: int):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    size=(B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["prefix_embeds"] = rng.normal(
            size=(B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def pairs():
    """Per arch: the reduced configs, JAX's params, the port's model, one
    batch, and JAX's prefill of it (logits, cache) and its decode, each
    jitted once."""
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg = jax_get_config(arch).reduced()
        cfg = get_config(arch).reduced()
        japi = jregistry.get_model(jcfg)
        params = japi.init(jax.random.PRNGKey(i))
        batch = _batch(cfg, seed=i)
        out[arch] = dict(
            jcfg=jcfg, cfg=cfg, params=params, api=registry.get_model(cfg),
            model=transformer_from_jax(_tree(params), cfg, device="cpu"),
            batch=batch, decode=jax.jit(japi.decode),
            jax_prefill=jax.jit(japi.prefill)(
                params, {k: jnp.asarray(v) for k, v in batch.items()}))
    return out


def _jax_cache(cache) -> dict:
    """JAX's ``{'blocks': {k, v}, 'first': {k, v}}`` in the port's keys."""
    out = {n: np.asarray(cache["blocks"][n]) for n in ("k", "v")}
    for n in ("k", "v"):
        if "first" in cache:
            out[f"first_{n}"] = np.asarray(cache["first"][n])
    return out


def _drop_last_slot(a: np.ndarray) -> np.ndarray:
    """A cache with its last sequence slot (axis -3) zeroed."""
    a = a.copy()
    a[..., -1, :, :] = 0
    return a


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch):
    """Every field the port keeps equals the JAX config's, full and
    reduced (MoE fields compared field by field)."""
    for reduce in (False, True):
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        if reduce:
            jcfg, cfg = jcfg.reduced(), cfg.reduced()
        for f in dataclasses.fields(ModelConfig):
            got, want = getattr(cfg, f.name), getattr(jcfg, f.name)
            if f.name == "moe" and want is not None:
                got, want = dataclasses.asdict(got), dataclasses.asdict(want)
            assert got == want, (arch, reduce, f.name)
        assert cfg.resolved_head_dim == jcfg.resolved_head_dim == \
            (32 if reduce else 128)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(pairs, arch):
    p = pairs[arch]
    jl, jc = p["jax_prefill"]
    tl, tc = p["api"].prefill(p["model"],
                              {k: torch.from_numpy(v)
                               for k, v in p["batch"].items()})
    n_prefix = p["cfg"].n_frontend_tokens
    assert tl.shape == (B, n_prefix + S, p["cfg"].padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    want = _jax_cache(jc)
    assert sorted(tc) == sorted(want)
    assert ("first_k" in tc) == (arch == "deepseek-moe-16b")
    for name, w in want.items():
        assert tuple(tc[name].shape) == w.shape, name
        np.testing.assert_allclose(tc[name].numpy(), w, rtol=TOL, atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax(pairs, arch):
    """Decode the last token at its position, each package from its own
    cache of the tokens before it: the prefill cache of the whole batch
    with the last slot zeroed (causal: K and V at a position depend only on
    the tokens up to it), in f32."""
    p = pairs[arch]
    last = p["batch"]["tokens"][:, -1:]
    n = p["cfg"].n_frontend_tokens + S
    jcache = jax.tree_util.tree_map(
        lambda a: jnp.asarray(_drop_last_slot(np.asarray(a))),
        p["jax_prefill"][1])
    jl, _ = p["decode"](p["params"], jcache, {"tokens": jnp.asarray(last)},
                        jnp.asarray(n - 1, jnp.int32))
    _, tc = p["api"].prefill(p["model"], {k: torch.from_numpy(v)
                                          for k, v in p["batch"].items()})
    tcache = {k: torch.from_numpy(_drop_last_slot(t.numpy()))
              for k, t in tc.items()}
    tl, out = p["api"].decode(p["model"], tcache,
                              {"tokens": torch.from_numpy(last)}, n - 1)
    assert out is tcache                            # updated in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "pixtral-12b"])
def test_serve_matches_jax_serve(arch):
    """``serve`` generates JAX's tokens from JAX's serve params
    (``PRNGKey(0)``), with pixtral's zero patch embeddings before the
    prompt and the cache and positions offset by them."""
    jcfg = jax_get_config(arch).reduced()
    params = jregistry.get_model(jcfg).init(jax.random.PRNGKey(0))
    model = transformer_from_jax(_tree(params), get_config(arch).reduced(),
                                 device="cpu")
    want = jax_serve(arch, True, 2, 12, 6)
    got = serve(arch, True, 2, 12, 6, device="cpu", params=model)
    assert got["generated"].shape == (2, 6)
    np.testing.assert_array_equal(got["generated"], want["generated"])


def test_param_counts_match_jax():
    """``param_count`` and ``active_param_count`` (counted on the meta
    device) equal JAX's (``eval_shape``) at full width."""
    for arch in ARCHS:
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        assert registry.param_count(cfg) == jregistry.param_count(jcfg), arch
        assert registry.active_param_count(cfg) == \
            jregistry.active_param_count(jcfg), arch


def test_other_families_raise():
    """Dispatch follows the config's fields, as JAX's ``get_model``, not its
    family name: a decoder given Mamba2 blocks and ``attn_every`` is the
    hybrid stack (tests/test_torch_zamba2.py), its count JAX's; a family
    name alone changes nothing; a config name neither package has
    raises."""
    hybrid = get_config("yi-34b").replace(
        family="hybrid", ssm=SSMConfig(kind="mamba2"), attn_every=6)
    jhybrid = jax_get_config("yi-34b").replace(
        family="hybrid", ssm=JSSMConfig(kind="mamba2"), attn_every=6)
    assert isinstance(registry.meta_model(hybrid), stacks.Hybrid)
    assert registry.param_count(hybrid) == jregistry.param_count(jhybrid)
    named = get_config("yi-34b").replace(family="hybrid")
    assert isinstance(registry.meta_model(named), tfm.Transformer)
    with pytest.raises(KeyError, match="repro.configs"):
        get_config("zamba2-7b")
