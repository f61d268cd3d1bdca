"""The port's xLSTM (``models.ssm``, ``models.stacks``) on the CPU against
``repro.models.ssm`` and ``repro.models.stacks``, reduced.

Inputs are made with numpy from a seed; JAX's params (``PRNGKey(i)``) are
carried over by ``xlstm_from_jax`` or by name. The GLA core, the
stabiliser scan, the causal conv, the mLSTM and sLSTM blocks and the whole
stack's prefill and decode logits are held to JAX within 1e-5 (f32; the
einsums sum in other orders). The port's own properties, as
``tests/test_ssm.py`` states them for JAX (chunked == one step at a time,
decode steps == one parallel pass), are held to that file's tolerances.
``serve`` must generate JAX's tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import SSMConfig as JSSMConfig
from repro.launch.serve import pad_cache_to as jax_pad_cache_to
from repro.launch.serve import serve as jax_serve
from repro.models import registry as jregistry
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.launch.serve import pad_cache_to, serve
from repro_torch.models import registry, ssm, stacks
from repro_torch.models.convert import xlstm_from_jax

TOL = 1e-5
ARCH = "xlstm-350m"
B, S = 2, 20
_jax_gla = jax.jit(jssm.gla_chunked, static_argnames=("chunk",))
_jax_stabilizer = jax.jit(jssm.stabilizer_scan)


def _np(x):
    return np.array(x, np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _gla_inputs(seed, T=32, track_n=True):
    rng = np.random.default_rng(seed)
    Bq, H, dk, dv = 2, 3, 8, 16
    f = lambda *s: rng.normal(size=s).astype(np.float32)   # noqa: E731
    return (f(Bq, T, H, dk), f(Bq, T, H, dk), f(Bq, T, H, dv),
            -np.abs(f(Bq, T, H)) * 0.3, f(Bq, T, H) * 0.3, f(Bq, H, dk, dv),
            np.abs(f(Bq, H, dk)) if track_n else None)


@pytest.mark.parametrize("track_n", [False, True])
@pytest.mark.parametrize("chunk", [4, 16])
def test_gla_chunked_matches_reference_and_jax(chunk, track_n):
    """``gla_chunked`` against the port's ``gla_scan_reference`` (the
    tolerance of tests/test_ssm.py) and JAX's ``gla_chunked`` (1e-5), with
    and without the normaliser n."""
    args = _gla_inputs(chunk + 2 * track_n, track_n=track_n)
    targs = [None if a is None else torch.from_numpy(a) for a in args]
    got = ssm.gla_chunked(*targs, chunk=chunk)
    ref = ssm.gla_scan_reference(*targs)
    want = _jax_gla(*[None if a is None else jnp.asarray(a)
                      for a in args], chunk=chunk)
    for g, r, w in zip(got, ref, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=TOL, atol=TOL)


def test_gla_reference_and_decode_match_jax():
    """The one-step recurrence and ``gla_decode_step`` against JAX's."""
    args = _gla_inputs(5, T=12)
    got = ssm.gla_scan_reference(*_t(*args))
    want = jssm.gla_scan_reference(*[jnp.asarray(a) for a in args])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=TOL, atol=TOL)
    q, k, v, la, lb, S0, n0 = args
    got = ssm.gla_decode_step(*_t(q[:, 3], k[:, 3], v[:, 3], la[:, 3],
                                  lb[:, 3], S0, n0))
    want = jssm.gla_decode_step(*[jnp.asarray(a) for a in (
        q[:, 3], k[:, 3], v[:, 3], la[:, 3], lb[:, 3], S0, n0)])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("m0", [0.0, -1e30])
@pytest.mark.parametrize("T", [1, 20, 64])
def test_stabilizer_scan_matches_jax_and_loop(T, m0):
    """The doubling max-plus scan against JAX's associative scan (1e-5)
    and the plain loop m_t = max(m_{t-1} + log_f_t, log_i_t) (1e-6: the
    sums of log_f round in another order)."""
    rng = np.random.default_rng(T)
    lf = -np.abs(rng.normal(size=(2, T, 3))).astype(np.float32)
    li = rng.normal(size=(2, T, 3)).astype(np.float32)
    m0a = np.full((2, 3), m0, np.float32)
    m, m_prev = ssm.stabilizer_scan(*_t(lf, li, m0a))
    jm, jm_prev = _jax_stabilizer(jnp.asarray(lf), jnp.asarray(li),
                                  jnp.asarray(m0a))
    np.testing.assert_allclose(m.numpy(), _np(jm), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(m_prev.numpy(), _np(jm_prev), rtol=TOL,
                               atol=TOL)
    cur, loop = m0a, []
    for t in range(T):
        cur = np.maximum(lf[:, t] + cur, li[:, t])
        loop.append(cur)
    np.testing.assert_allclose(m.numpy(), np.stack(loop, 1), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 7, 5)).astype(np.float32)
    w = rng.normal(size=(4, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    st = rng.normal(size=(2, 3, 5)).astype(np.float32) if with_state \
        else None
    got = ssm.causal_conv(*_t(x, w, b), None if st is None
                          else torch.from_numpy(st))
    want = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             None if st is None else jnp.asarray(st))
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(wt), rtol=TOL, atol=TOL)


def _block_cfgs():
    """tests/test_ssm.py's small SSM config, in both packages."""
    kw = dict(name="t", family="ssm", n_layers=4, d_model=32, n_heads=2,
              n_kv_heads=2, d_ff=0, vocab_size=128, vocab_pad_to=16,
              dtype="float32")
    sk = dict(kind="xlstm", d_state=8, d_conv=4, expand=2, chunk_size=4,
              n_ssm_heads=4, slstm_every=2)
    return (ModelConfig(**kw, ssm=SSMConfig(**sk)),
            JModelConfig(**kw, remat="none", ssm=JSSMConfig(**sk)))


def _block(kind: str, seed: int):
    """(port block, JAX params, JAX apply, JAX empty state, port empty
    state, configs) of one mLSTM or sLSTM block with JAX's weights."""
    cfg, jcfg = _block_cfgs()
    init, apply, empty = {
        "mlstm": (jssm.mlstm_init, jssm.mlstm_apply,
                  jssm.mlstm_empty_state),
        "slstm": (jssm.slstm_init, jssm.slstm_apply,
                  jssm.slstm_empty_state)}[kind]
    p = jax.jit(init, static_argnums=(1, 2))(jax.random.PRNGKey(seed), jcfg,
                                            jnp.float32)
    apply = jax.jit(apply, static_argnums=1)
    flat = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}.")
            else:
                flat[f"{prefix}{key}"] = torch.from_numpy(_np(val))
    walk(p, "")
    block = (ssm.MLSTM if kind == "mlstm" else ssm.SLSTM)(cfg, device="meta")
    block.load_state_dict(flat, strict=True, assign=True)
    port_empty = ssm.mlstm_empty_state if kind == "mlstm" \
        else ssm.slstm_empty_state
    return block, p, apply, empty, port_empty, cfg, jcfg


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_matches_jax_and_decode_matches_parallel(kind):
    """One block, JAX's weights: the parallel pass from the zero state and
    that state within 1e-5 of JAX's, the pass without a state equal to it;
    and T decode steps from the empty state match the parallel pass
    (tests/test_ssm.py's property, 2e-3 and 2e-4)."""
    block, p, apply, jempty, empty, cfg, jcfg = _block(kind, 7)
    rng = np.random.default_rng(11)
    T = 8
    x = rng.normal(size=(B, T, cfg.d_model)).astype(np.float32)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        y_par, _ = block(tx)
        y_st, st = block(tx, empty(cfg, B))
        wy, wst = apply(p, jcfg, jnp.asarray(x), jempty(jcfg, B))
        np.testing.assert_array_equal(y_par.numpy(), y_st.numpy())
        np.testing.assert_allclose(y_st.numpy(), _np(wy), rtol=TOL, atol=TOL)
        for key, val in wst.items():
            np.testing.assert_allclose(st[key].numpy(), _np(val), rtol=TOL,
                                       atol=TOL, err_msg=key)
        st, ys = empty(cfg, B), []
        for t in range(T):
            y, st = block(tx[:, t:t + 1], st)
            ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_par.numpy(),
                               rtol=2e-3, atol=2e-4)


@pytest.fixture(scope="module")
def pair():
    """The reduced configs, JAX's params and the port's model, one batch,
    JAX's prefill of it, and 3 greedy decode steps after JAX's
    ``pad_cache_to`` (tokens and logits), each jitted once."""
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    japi = jregistry.get_model(jcfg)
    params = japi.init(jax.random.PRNGKey(3))
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
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
    return dict(cfg=cfg, jcfg=jcfg, api=registry.get_model(cfg),
                model=xlstm_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            params),
                                     cfg, device="cpu"),
                tokens=tokens, prefill=(np.asarray(jl), jc), dec=dec,
                toks=np.stack(toks, 1))


def _jax_state(jc) -> dict:
    """JAX's ``{'mlstm': [...], 'slstm': {...}}`` (stacked over groups) in
    the port's flat keys."""
    out = {f"mlstm.{i}.{k}": np.asarray(t)
           for i, blk in enumerate(jc["mlstm"]) for k, t in blk.items()}
    out.update({f"slstm.{k}": np.asarray(t) for k, t in jc["slstm"].items()})
    return out


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


def test_prefill_matches_jax(pair):
    """Logits and every state tensor of the prefill within 1e-5 of JAX's
    (the state of a 20-token prompt with chunk 16: gcd, 4)."""
    tl, tc = pair["api"].prefill(pair["model"],
                                 {"tokens": torch.from_numpy(pair["tokens"])})
    jl, jc = pair["prefill"]
    assert tl.shape == (B, S, pair["cfg"].padded_vocab)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=TOL, atol=TOL)
    want = _jax_state(jc)
    assert sorted(tc) == sorted(want)
    for key, w in want.items():
        assert tuple(tc[key].shape) == w.shape, key
        np.testing.assert_allclose(tc[key].float().numpy(), w, rtol=TOL,
                                   atol=TOL, err_msg=key)


def test_decode_matches_jax(pair):
    """3 greedy decode steps after ``pad_cache_to`` (the state passes
    through): the tokens and every step's logits of JAX's."""
    api, model = pair["api"], pair["model"]
    logits, state = api.prefill(model,
                                {"tokens": torch.from_numpy(pair["tokens"])})
    target = api.empty_cache(B, S + 3, device="cpu")
    padded = pad_cache_to(state, target)
    assert all(padded[k] is state[k] for k in state)
    toks = [logits[:, -1].argmax(-1)]
    for step in range(3):
        logits, out = api.decode(model, padded, {"tokens": toks[-1][:, None]},
                                 S + step)
        assert out is padded                        # updated in place
        np.testing.assert_allclose(logits.numpy(), pair["dec"][step],
                                   rtol=TOL, atol=TOL)
        toks.append(logits[:, -1].argmax(-1))
    np.testing.assert_array_equal(torch.stack(toks, 1).numpy(), pair["toks"])


def test_prefill_then_decode_matches_one_pass(pair):
    """The stack's state carries: a prefill of the first S - 4 tokens and
    4 decode steps give the logits of one pass over all S (the tolerance of
    tests/test_ssm.py)."""
    api, model = pair["api"], pair["model"]
    toks = torch.from_numpy(pair["tokens"])
    full, _ = api.prefill(model, {"tokens": toks})
    head, state = api.prefill(model, {"tokens": toks[:, :S - 4]})
    steps = [head]
    for t in range(S - 4, S):
        logits, state = api.decode(model, state, {"tokens": toks[:, t:t + 1]},
                                   t)
        steps.append(logits)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-4)


def test_serve_matches_jax_serve():
    """``serve`` generates JAX's tokens from JAX's serve params
    (``PRNGKey(0)``); the recurrent state passes through ``pad_cache_to``."""
    jcfg = jax_get_config(ARCH).reduced()
    params = jregistry.get_model(jcfg).init(jax.random.PRNGKey(0))
    model = xlstm_from_jax(jax.tree_util.tree_map(np.asarray, params),
                           get_config(ARCH).reduced(), device="cpu")
    want = jax_serve(ARCH, True, 2, 12, 6)
    got = serve(ARCH, True, 2, 12, 6, device="cpu", params=model)
    assert got["generated"].shape == (2, 6)
    np.testing.assert_array_equal(got["generated"], want["generated"])


def test_param_count_matches_jax():
    """``param_count`` (meta device) equals JAX's (``eval_shape``) at full
    width; the empty state has JAX's shapes and dtypes."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    assert registry.param_count(cfg) == jregistry.param_count(jcfg)
    assert registry.active_param_count(cfg) == registry.param_count(cfg)
    shapes = jax.eval_shape(
        lambda: jregistry.get_model(jcfg).empty_cache(2, 64))
    want = {f"mlstm.{i}.{k}": t for i, blk in enumerate(shapes["mlstm"])
            for k, t in blk.items()}
    want.update({f"slstm.{k}": t for k, t in shapes["slstm"].items()})
    got = stacks.xlstm_empty_state(cfg, 2, device="meta")
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype).split(".")[-1] == str(w.dtype), key
