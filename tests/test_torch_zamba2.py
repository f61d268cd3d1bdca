"""The port's zamba2-style hybrid (``models.ssm.Mamba2``, ``models.stacks.
Hybrid``) on the CPU against ``repro.models.ssm`` and
``repro.models.stacks``, at the reduced config (2 layers, ``attn_every``
2, d 128, hd 32, SSM heads 2, d_state 16, chunk 16, f32).

Inputs are made with numpy from a seed; JAX's params (``PRNGKey(i)``) are
carried over by ``hybrid_from_jax`` or by name, with Mamba2's ``A_log``,
``dt_bias``, ``D`` and ``conv_b`` drawn anew from numpy so that none is
its trivial init. The Mamba2 block (train; prefill with T a multiple of
the chunk and a ragged T that takes the gcd chunk; decode step by step,
conv and S states included) and the whole stack (train logits, prefill
logits and state, 3 decode steps through ``pad_cache_to``) are held to
JAX within 1e-5 (f32; the einsums sum in other orders). JAX's references
are jitted once per module fixture. ``serve`` must generate JAX's
tokens."""
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
from repro.models import ssm as jssm
from repro.models import stacks as jstacks
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.serve import pad_cache_to, serve
from repro_torch.models import registry, ssm, stacks
from repro_torch.models.convert import hybrid_from_jax

TOL = 1e-5
ARCH = "zamba2-2.7b"
B, S = 2, 20
# the Mamba2 leaves JAX initialises to constants, drawn anew for the tests
_F32_LEAVES = ("A_log", "dt_bias", "D")


def _np(x):
    return np.array(x, np.float32)


def _perturb(p, rng):
    """JAX Mamba2 params with ``A_log``, ``dt_bias``, ``D`` and ``conv_b``
    drawn from ``rng`` (numpy), the rest as JAX drew them."""
    p = dict(p)
    for name in _F32_LEAVES + ("conv_b",):
        p[name] = jnp.asarray(rng.normal(size=p[name].shape).astype(
            np.float32) * 0.5, p[name].dtype)
    return p


@pytest.fixture(scope="module")
def block():
    """One reduced Mamba2 block with (perturbed) JAX weights in both
    packages, and JAX's ``mamba2_apply`` jitted once."""
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    p = jax.jit(jssm.mamba2_init, static_argnums=(1, 2))(
        jax.random.PRNGKey(5), jcfg, jnp.float32)
    p = _perturb(p, np.random.default_rng(5))
    flat = {}
    for key, val in p.items():
        if isinstance(val, dict):
            flat.update({f"{key}.{k}": torch.from_numpy(_np(v))
                         for k, v in val.items()})
        else:
            flat[key] = torch.from_numpy(_np(val))
    mod = ssm.Mamba2(cfg, device="meta")
    mod.load_state_dict(flat, strict=True, assign=True)
    apply = jax.jit(jssm.mamba2_apply, static_argnums=1)
    return dict(cfg=cfg, jcfg=jcfg, p=p, mod=mod, apply=apply)


def _state_close(got, want, what):
    assert sorted(got) == sorted(want), what
    for key, w in want.items():
        assert tuple(got[key].shape) == np.shape(w), (what, key)
        np.testing.assert_allclose(got[key].float().numpy(), _np(w),
                                   rtol=TOL, atol=TOL, err_msg=f"{what} {key}")


@pytest.mark.parametrize("mode,T", [("train", 32), ("prefill", 32),
                                    ("prefill", 20)])
def test_mamba2_matches_jax(block, mode, T):
    """The block without a state (train) and from the zero state (prefill):
    the output and the new conv and S states within 1e-5 of JAX's; T = 20
    runs the chunked core at gcd(20, 16) = 4."""
    cfg, jcfg = block["cfg"], block["jcfg"]
    x = np.random.default_rng(T).normal(size=(B, T, cfg.d_model)).astype(
        np.float32)
    with torch.no_grad():
        st = None if mode == "train" else ssm.mamba2_empty_state(cfg, B)
        y, new = block["mod"](torch.from_numpy(x), st)
    jst = None if mode == "train" else jssm.mamba2_empty_state(jcfg, B)
    wy, wnew = block["apply"](block["p"], jcfg, jnp.asarray(x), jst)
    np.testing.assert_allclose(y.numpy(), _np(wy), rtol=TOL, atol=TOL)
    _state_close(new, dict(wnew), f"{mode} T={T}")


def test_mamba2_decode_steps_match_jax(block):
    """A prefill of 12 steps, then 4 decode steps (T = 1 with a state: the
    one-step recurrence and the conv window): every step's output and
    state within 1e-5 of JAX's."""
    cfg, jcfg = block["cfg"], block["jcfg"]
    x = np.random.default_rng(9).normal(size=(B, 16, cfg.d_model)).astype(
        np.float32)
    with torch.no_grad():
        _, st = block["mod"](torch.from_numpy(x[:, :12]),
                             ssm.mamba2_empty_state(cfg, B))
    _, jst = block["apply"](block["p"], jcfg, jnp.asarray(x[:, :12]),
                            jssm.mamba2_empty_state(jcfg, B))
    for t in range(12, 16):
        with torch.no_grad():
            y, st = block["mod"](torch.from_numpy(x[:, t:t + 1]), st)
        wy, jst = block["apply"](block["p"], jcfg, jnp.asarray(x[:, t:t + 1]),
                                 jst)
        np.testing.assert_allclose(y.numpy(), _np(wy), rtol=TOL, atol=TOL,
                                   err_msg=f"step {t}")
        _state_close(st, dict(jst), f"step {t}")


def _jax_state(jc, leaf=np.asarray) -> dict:
    """JAX's ``{'mamba': [...], 'attn_kv': {k, v}}`` (stacked over groups)
    in the port's flat keys."""
    out = {f"mamba.{i}.{k}": leaf(t)
           for i, blk in enumerate(jc["mamba"]) for k, t in blk.items()}
    out.update({f"attn_kv.{k}": leaf(t) for k, t in jc["attn_kv"].items()})
    return out


def _perturb_tree(params):
    rng = np.random.default_rng(3)
    blocks = dict(params["blocks"])
    blocks["mamba"] = [_perturb(p, rng) for p in blocks["mamba"]]
    return {**params, "blocks": blocks}


@pytest.fixture(scope="module")
def pair():
    """The reduced configs, JAX's params (perturbed) and the port's model,
    one batch, JAX's train logits and prefill of it, and 3 greedy decode
    steps after JAX's ``pad_cache_to`` (tokens and logits), each jitted
    once."""
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    japi = jregistry.get_model(jcfg)
    params = _perturb_tree(japi.init(jax.random.PRNGKey(3)))
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    jtrain, _ = jax.jit(lambda p, t: jstacks.hybrid_forward(
        p, jcfg, t, mode="train"))(params, jnp.asarray(tokens))
    jl, jc = jax.jit(japi.prefill)(params, {"tokens": jnp.asarray(tokens)})
    target = jax.eval_shape(lambda: japi.empty_cache(B, S + 3))
    cache = jax_pad_cache_to(jc, target)
    decode = jax.jit(japi.decode)
    toks, dec = [np.asarray(jnp.argmax(jl[:, -1], -1))], []
    for step in range(3):
        logits, cache = decode(params, cache,
                               {"tokens": jnp.asarray(toks[-1][:, None])},
                               jnp.asarray(S + step, jnp.int32))
        dec.append(np.asarray(logits))
        toks.append(np.asarray(jnp.argmax(logits[:, -1], -1)))
    return dict(cfg=cfg, api=registry.get_model(cfg),
                model=hybrid_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             params),
                                      cfg, device="cpu"),
                tokens=tokens, train=np.asarray(jtrain),
                prefill=(np.asarray(jl), jc), dec=dec,
                toks=np.stack(toks, 1))


def test_config_matches_jax():
    """Every field the port keeps equals the JAX config's, full and
    reduced (``ssm`` field by field)."""
    for reduce in (False, True):
        jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
        if reduce:
            jcfg, cfg = jcfg.reduced(), cfg.reduced()
        for f in dataclasses.fields(ModelConfig):
            got, want = getattr(cfg, f.name), getattr(jcfg, f.name)
            if f.name == "ssm":
                got, want = dataclasses.asdict(got), dataclasses.asdict(want)
            assert got == want, (reduce, f.name)


def test_train_logits_match_jax(pair):
    """``mode='train'`` (no state): the logits within 1e-5 of JAX's."""
    with torch.no_grad():
        got, state = pair["model"](torch.from_numpy(pair["tokens"]))
    assert state is None
    np.testing.assert_allclose(got.numpy(), pair["train"], rtol=TOL,
                               atol=TOL)


def test_prefill_matches_jax(pair):
    """Logits and every state tensor of the prefill within 1e-5 of JAX's:
    the Mamba2 states (S = 20 with chunk 16: gcd, 4) and each occurrence's
    fresh K and V, in the model's dtype (f32 here), as JAX returns them."""
    tl, tc = pair["api"].prefill(pair["model"],
                                 {"tokens": torch.from_numpy(pair["tokens"])})
    jl, jc = pair["prefill"]
    assert tl.shape == (B, S, pair["cfg"].padded_vocab)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=TOL, atol=TOL)
    want = _jax_state(jc)
    for key, w in want.items():
        assert str(tc[key].dtype).split(".")[-1] == str(w.dtype), key
    _state_close(tc, want, "prefill")


def test_decode_matches_jax(pair):
    """3 greedy decode steps after ``pad_cache_to`` (the Mamba2 states pass
    through, the KV caches are padded along their sequence axis and cast
    to bf16): the tokens and every step's logits of JAX's."""
    api, model = pair["api"], pair["model"]
    logits, state = api.prefill(model,
                                {"tokens": torch.from_numpy(pair["tokens"])})
    target = api.empty_cache(B, S + 3, device="cpu")
    padded = pad_cache_to(state, target)
    for key in state:
        assert (padded[key] is state[key]) == key.startswith("mamba."), key
    k = padded["attn_kv.k"]
    assert k.dtype == torch.bfloat16 and k.shape[2] == S + 3
    assert torch.equal(k[:, :, :S], state["attn_kv.k"].to(torch.bfloat16))
    assert not k[:, :, S:].any()
    toks = [logits[:, -1].argmax(-1)]
    for step in range(3):
        logits, out = api.decode(model, padded, {"tokens": toks[-1][:, None]},
                                 S + step)
        assert out is padded                        # updated in place
        np.testing.assert_allclose(logits.numpy(), pair["dec"][step],
                                   rtol=TOL, atol=TOL)
        toks.append(logits[:, -1].argmax(-1))
    np.testing.assert_array_equal(torch.stack(toks, 1).numpy(), pair["toks"])


def test_serve_matches_jax_serve():
    """``serve`` generates JAX's tokens from JAX's serve params
    (``PRNGKey(0)``)."""
    jcfg = jax_get_config(ARCH).reduced()
    params = jregistry.get_model(jcfg).init(jax.random.PRNGKey(0))
    model = hybrid_from_jax(jax.tree_util.tree_map(np.asarray, params),
                            get_config(ARCH).reduced(), device="cpu")
    want = jax_serve(ARCH, True, 2, 12, 6)
    got = serve(ARCH, True, 2, 12, 6, device="cpu", params=model)
    assert got["generated"].shape == (2, 6)
    np.testing.assert_array_equal(got["generated"], want["generated"])


def test_param_count_and_state_match_jax():
    """``param_count`` (meta device) equals JAX's 2,063,676,080 at full
    width; Mamba2's ``A_log``, ``dt_bias`` and ``D`` are float32 in the
    bf16 model and every other leaf bf16; the empty state has JAX's shapes
    and dtypes (the KV caches bf16)."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    assert registry.param_count(cfg) == jregistry.param_count(jcfg) \
        == 2_063_676_080
    assert registry.active_param_count(cfg) == registry.param_count(cfg)
    for name, p in stacks.Hybrid(cfg, device="meta").named_parameters():
        want = torch.float32 if name.split(".")[-1] in _F32_LEAVES \
            else torch.bfloat16
        assert p.dtype == want, name
    shapes = jax.eval_shape(
        lambda: jregistry.get_model(jcfg).empty_cache(2, 64))
    want = _jax_state(shapes, leaf=lambda t: t)
    got = stacks.hybrid_empty_state(cfg, 2, 64, device="meta")
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype).split(".")[-1] == str(w.dtype), key
