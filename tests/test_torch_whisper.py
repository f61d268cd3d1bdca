"""The port's whisper (``models.whisper``) on the CPU against
``repro.models.whisper``, reduced (hd 32, 2 encoder and 2 decoder layers,
16 frames, GQA 4 / 2).

JAX's params (``PRNGKey(0)``) are carried over by ``whisper_from_jax``;
tokens and audio embeddings are made with numpy from a seed. The encoder's
output, the prefill logits and cache, and 3 greedy decode steps after
``pad_cache_to`` (which casts the cross K/V to bf16, as JAX's does) are
held to 1e-5 (f32; the matmul and softmax orders differ, and prefill
attention is the flash reference rather than ``_attend``). ``serve`` must
generate JAX's tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import pad_cache_to as jax_pad_cache_to
from repro.launch.serve import serve as jax_serve
from repro.models import registry as jregistry
from repro.models import whisper as jwhisper
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.serve import pad_cache_to, serve
from repro_torch.models import registry, whisper
from repro_torch.models.convert import whisper_from_jax

TOL = 1e-5
ARCH = "whisper-large-v3"
B, S, STEPS = 2, 12, 3


@pytest.fixture(scope="module")
def pair():
    """The reduced configs, JAX's params and the port's model, one batch
    (tokens and seeded audio embeddings), JAX's encoder output and prefill
    of it, and STEPS greedy decode steps after JAX's ``pad_cache_to``
    (tokens and logits), each jitted once."""
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    japi = jregistry.get_model(jcfg)
    params = japi.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    size=(B, S)).astype(np.int32),
             "audio_embeds": rng.normal(size=(
                 B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    enc = jax.jit(lambda p, a: jwhisper.encode(p, jcfg, a))(
        params, jbatch["audio_embeds"])
    jl, jc = jax.jit(japi.prefill)(params, jbatch)
    cache = jax_pad_cache_to(jc, jax.eval_shape(
        lambda: japi.empty_cache(B, S + STEPS)))
    decode = jax.jit(japi.decode)
    toks, dec = [np.asarray(jnp.argmax(jl[:, -1], -1))], []
    for step in range(STEPS):
        logits, cache = decode(params, cache,
                               {"tokens": jnp.asarray(toks[-1][:, None])},
                               jnp.asarray(S + step, jnp.int32))
        dec.append(np.asarray(logits))
        toks.append(np.asarray(jnp.argmax(logits[:, -1], -1)))
    return dict(cfg=cfg, api=registry.get_model(cfg),
                model=whisper_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              params),
                                       cfg, device="cpu"),
                batch={k: torch.from_numpy(v) for k, v in batch.items()},
                enc=np.asarray(enc), prefill=(np.asarray(jl), jc), dec=dec,
                toks=np.stack(toks, 1))


def test_config_matches_jax():
    """Every field the port keeps equals the JAX config's, full and
    reduced."""
    for reduce in (False, True):
        jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
        if reduce:
            jcfg, cfg = jcfg.reduced(), cfg.reduced()
        for f in dataclasses.fields(ModelConfig):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), \
                (reduce, f.name)
        assert cfg.resolved_head_dim == jcfg.resolved_head_dim == \
            (32 if reduce else 64)


@pytest.mark.parametrize("length,channels", [(16, 128), (1500, 1280)])
def test_sinusoids_match_jax(length, channels):
    """The first 16 positions (the reduced tests' frames) within 1e-5. The
    f32 frequencies exp(-c i) of XLA and PyTorch may differ by an ulp
    (6e-8 relative), which the angle pos * freq carries to 1.2e-4 at
    position 1,499 (measured); the whole table is held to two relative
    roundings (2^-23 each) of the largest angle, 2 * 1,499 * 2^-23 =
    3.6e-4."""
    got = whisper.sinusoids(length, channels).numpy()
    want = np.asarray(jwhisper.sinusoids(length, channels))
    np.testing.assert_allclose(got[:16], want[:16], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * (length - 1) * 2.0 ** -23)


def test_encode_matches_jax(pair):
    with torch.no_grad():
        got = pair["model"].encode(pair["batch"]["audio_embeds"])
    assert got.shape == pair["enc"].shape
    np.testing.assert_allclose(got.numpy(), pair["enc"], rtol=TOL, atol=TOL)


def test_prefill_matches_jax(pair):
    """Logits, and the self (k, v: the prompt) and cross (xk, xv: the
    frames) caches."""
    tl, tc = pair["api"].prefill(pair["model"], pair["batch"])
    jl, jc = pair["prefill"]
    cfg = pair["cfg"]
    assert tl.shape == (B, S, cfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=TOL, atol=TOL)
    assert sorted(tc) == sorted(jc) == ["k", "v", "xk", "xv"]
    for name, want in jc.items():
        want = np.asarray(want)
        assert tuple(tc[name].shape) == want.shape, name
        np.testing.assert_allclose(tc[name].numpy(), want, rtol=TOL,
                                   atol=TOL, err_msg=name)
    assert tc["xk"].shape[2] == cfg.n_frontend_tokens


def test_decode_matches_jax(pair):
    """STEPS greedy steps after ``pad_cache_to``: the self cache padded to
    S + STEPS slots in bf16, the cross K/V cast to bf16 at their size; each
    step's logits within 1e-5 of JAX's, the same tokens."""
    api, model = pair["api"], pair["model"]
    logits, cache = api.prefill(model, pair["batch"])
    cache = pad_cache_to(cache, api.empty_cache(B, S + STEPS, device="cpu"))
    assert all(t.dtype == torch.bfloat16 for t in cache.values())
    assert cache["k"].shape[2] == S + STEPS
    toks = [logits[:, -1].argmax(-1)]
    for step in range(STEPS):
        logits, out = api.decode(model, cache, {"tokens": toks[-1][:, None]},
                                 S + step)
        assert out is cache                         # updated in place
        np.testing.assert_allclose(logits.numpy(), pair["dec"][step],
                                   rtol=TOL, atol=TOL)
        toks.append(logits[:, -1].argmax(-1))
    np.testing.assert_array_equal(torch.stack(toks, 1).numpy(), pair["toks"])


def test_serve_matches_jax_serve():
    """``serve`` generates JAX's tokens from JAX's serve params
    (``PRNGKey(0)``), with zero audio embeddings."""
    jcfg = jax_get_config(ARCH).reduced()
    params = jregistry.get_model(jcfg).init(jax.random.PRNGKey(0))
    model = whisper_from_jax(jax.tree_util.tree_map(np.asarray, params),
                             get_config(ARCH).reduced(), device="cpu")
    want = jax_serve(ARCH, True, 2, 12, 6)
    got = serve(ARCH, True, 2, 12, 6, device="cpu", params=model)
    assert got["generated"].shape == (2, 6)
    np.testing.assert_array_equal(got["generated"], want["generated"])


def test_param_count_matches_jax():
    """``param_count`` (meta device) equals JAX's (``eval_shape``) at full
    width."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    assert registry.param_count(cfg) == jregistry.param_count(jcfg)
    assert registry.active_param_count(cfg) == registry.param_count(cfg)
