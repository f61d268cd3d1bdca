"""The LLM trainer's parts on the CPU against the JAX package:
``token_batches``, ``ASSIGNED_ARCHS``, ``cross_entropy``, remat ("full"
and "dots"), Adam on mixed bf16 and f32 leaves, the CLI, and training's
attention, which never reaches the flash kernel. The families' losses, gradients and trajectories
are in ``test_torch_train_llm_decoders.py`` and
``test_torch_train_llm_recurrent.py``."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch.utils._python_dispatch import TorchDispatchMode

from _torch_llm_common import (_one_torch_thread,  # noqa: F401
                               assert_matches_jax, configs, named_leaves,
                               port_loss_and_grads, port_model, train_batch)
from repro import configs as jconfigs
from repro.data.tokens import token_batches as jax_token_batches
from repro.models import registry as jregistry
from repro.models import transformer as jtfm
from repro.optim import adam as jadam
from repro_torch import configs as pconfigs
from repro_torch.data.tokens import token_batches
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import train as ptrain
from repro_torch.models import convert, registry
from repro_torch.models import transformer as tfm
from repro_torch.optim import adam as padam


@pytest.mark.parametrize("vocab,batch,seq,n,seed", [
    (512, 4, 64, 3, 0), (32000, 2, 17, 2, 1), (256_000, 3, 128, 1, 7),
    (7, 1, 1, 4, 123)])
def test_token_batches_match_jax(vocab, batch, seq, n, seed):
    got = list(token_batches(vocab, batch, seq, n, seed))
    want = list(jax_token_batches(vocab, batch, seq, n, seed))
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["labels", "tokens"]
        for k in g:
            assert g[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])


def test_assigned_archs_match_jax():
    assert pconfigs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    for arch in pconfigs.ASSIGNED_ARCHS:
        assert pconfigs.get_config(arch).remat == \
            jconfigs.get_config(arch).remat == "full"
        assert pconfigs.get_config(arch).reduced().remat == "none"


def test_cross_entropy_matches_jax():
    """A padded vocabulary (the pad columns large, so that they would show
    if read) and labels of -1 masked out: within 1e-6 of JAX's, and the
    gradient too."""
    rng = np.random.default_rng(0)
    vocab, padded = 50, 64
    logits = rng.normal(size=(3, 9, padded)).astype(np.float32) * 4
    logits[..., vocab:] = 30.0
    labels = rng.integers(0, vocab, size=(3, 9)).astype(np.int32)
    labels[0, :4] = -1
    labels[2, -1] = -1
    want, jgrad = jax.value_and_grad(jtfm.cross_entropy)(
        jnp.asarray(logits), jnp.asarray(labels), vocab)
    t = torch.from_numpy(logits).requires_grad_()
    got = tfm.cross_entropy(t, torch.from_numpy(labels), vocab)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), atol=1e-6)
    # every label masked: JAX's max(count, 1) denominator gives 0
    none = np.full_like(labels, -1)
    assert float(tfm.cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(none), vocab)) == 0.0


@pytest.mark.parametrize("arch", ["gemma2-9b", "qwen3-moe-30b-a3b",
                                  "whisper-large-v3", "xlstm-350m",
                                  "zamba2-2.7b"])
def test_remat_full_equals_none(arch):
    """``remat="full"`` recomputes each group's forward in the backward
    pass: the loss and every gradient bit-equal to ``remat="none"``."""
    _, cfg = configs(arch)
    batch = train_batch(cfg)
    out = []
    for remat in ("none", "full"):
        c = cfg.replace(remat=remat)
        out.append(port_loss_and_grads(
            registry.get_model(c).init(seed=0, device="cpu"), c, batch))
    assert out[0][0] == out[1][0]
    assert sorted(out[0][1]) == sorted(out[1][1])
    for name, g in out[0][1].items():
        np.testing.assert_array_equal(out[1][1][name], g, err_msg=name)


def test_remat_dots_raises():
    """``remat="dots"`` no longer raises (it is ported: see
    ``test_remat_dots_matches_jax_and_full``); a policy neither package
    knows does."""
    _, cfg = configs("granite-3-8b")
    model = registry.get_model(cfg).init(seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in train_batch(cfg).items()}
    model.cfg = cfg.replace(remat="dots")
    assert torch.isfinite(registry.get_model(model.cfg).train_loss(
        model, batch))
    model.cfg = cfg.replace(remat="all")
    with pytest.raises(ValueError, match="unknown remat policy"):
        registry.get_model(model.cfg).train_loss(model, batch)


class _CountMM(TorchDispatchMode):
    """Counts ``aten.mm`` calls (the weights' products) while active."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        return func(*args, **(kwargs or {}))


def test_remat_dots_matches_jax_and_full():
    """``remat="dots"`` (JAX's ``checkpoint_dots_with_no_batch_dims``): a
    reduced decoder's loss and gradients within the trainer's tolerances of
    ``jax.value_and_grad`` at "dots", bit-equal to the port's own at
    "full", and its backward runs fewer ``aten.mm`` than "full"'s, whose
    recompute runs the forward's products again."""
    jcfg, cfg = configs("granite-3-8b")
    jcfg, cfg = jcfg.replace(remat="dots"), cfg.replace(remat="dots")
    api = jregistry.get_model(jcfg)
    params = api.init(jax.random.PRNGKey(0))
    batch = train_batch(cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(api.train_loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    ref = dict(cfg=cfg, params=params, batch=batch, loss=float(jloss),
               grads=named_leaves(jgrads, cfg))
    assert_matches_jax(ref)
    out, mms = [], []
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for remat in ("dots", "full"):
        c = cfg.replace(remat=remat)
        model = port_model(params, c)
        loss = registry.get_model(c).train_loss(model, tbatch)
        with _CountMM() as count:
            loss.backward()
        mms.append(count.mm)
        out.append((float(loss.detach()),
                    {n: p.grad.numpy() for n, p in convert.llm_leaves(model)}))
    assert out[0][0] == out[1][0]
    for name, g in out[0][1].items():
        np.testing.assert_array_equal(out[1][1][name], g, err_msg=name)
    assert 0 < mms[0] < mms[1], mms


@pytest.mark.parametrize("steps", [1, 2])
def test_adam_mixed_bf16_f32_matches_jax(steps):
    """``adam_update`` on bf16 and f32 leaves (f32 moments; gradients past
    the clip norm) against JAX's: parameters and moments within 1e-6
    relative after each step."""
    rng = np.random.default_rng(0)
    leaves = [((3, 4), "bfloat16"), ((5,), "float32"), ((2, 2, 2),
              "bfloat16"), ((7,), "float32")]
    init = [rng.normal(size=s).astype(np.float32) for s, _ in leaves]
    jp = {f"l{i}": jnp.asarray(p, dt)
          for i, (p, (_, dt)) in enumerate(zip(init, leaves))}
    tp = [torch.from_numpy(p).to(getattr(torch, dt))
          for p, (_, dt) in zip(init, leaves)]
    jcfg = jadam.AdamConfig(lr_max=3e-4, total_steps=3)
    pcfg = padam.AdamConfig(lr_max=3e-4, total_steps=3)
    jo, po = jadam.adam_init(jp), padam.adam_init(tp)
    update = jax.jit(lambda g, o, p: jadam.adam_update(jcfg, g, o, p))
    for _ in range(steps):
        gs = [rng.normal(size=s).astype(np.float32) * 20 for s, _ in leaves]
        jg = {f"l{i}": jnp.asarray(g, dt)
              for i, (g, (_, dt)) in enumerate(zip(gs, leaves))}
        tg = [torch.from_numpy(g).to(getattr(torch, dt))
              for g, (_, dt) in zip(gs, leaves)]
        jp, jo, jm = update(jg, jo, jp)
        tp, po, pm = padam.adam_update(pcfg, tg, po, tp)
        assert float(jm["grad_norm"]) > pcfg.clip_norm
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    for i, (_, dt) in enumerate(leaves):
        key = f"l{i}"
        assert tp[i].dtype == getattr(torch, dt)
        assert po.mu[i].dtype == po.nu[i].dtype == torch.float32
        np.testing.assert_allclose(
            tp[i].float().numpy(), np.asarray(jp[key]).astype(np.float32),
            rtol=1e-6)
        np.testing.assert_allclose(po.mu[i].numpy(), np.asarray(jo.mu[key]),
                                   rtol=1e-6)
        np.testing.assert_allclose(po.nu[i].numpy(), np.asarray(jo.nu[key]),
                                   rtol=1e-6)
    assert int(po.step) == int(jo.step) == steps


@pytest.mark.parametrize("arch", pconfigs.ASSIGNED_ARCHS)
def test_main_trains_an_llm_on_the_cpu(capsys, monkeypatch, arch):
    """``python -m repro_torch.launch.train --arch <arch> --reduced --steps
    2 --device cpu``, every arch: ``train_llm(arch, True, 2,
    device="cpu")``, JAX's log line and ``final loss X (from Y)`` of its
    losses."""
    calls = []
    train_llm = ptrain.train_llm

    def spy(*args, **kwargs):
        calls.append((args, kwargs, train_llm(*args, **kwargs)[1]))
        return None, calls[-1][2]
    monkeypatch.setattr(ptrain, "train_llm", spy)
    ptrain.main(["--arch", arch, "--reduced", "--steps", "2", "--device",
                 "cpu"])
    [(args, kwargs, losses)] = calls
    assert args == (arch, True, 2) and kwargs == {"device": "cpu"}
    assert len(losses) == 2 and np.isfinite(losses).all()
    out = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"step    0 loss \d+\.\d{4}", out[0])
    assert out[-1] == f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})"


def test_main_without_device_needs_the_card():
    """Without ``--device`` the trainer asks for the card: here, where there
    is none, it raises instead of using the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ptrain.main(["--arch", "gemma2-9b", "--reduced", "--steps", "1"])


@pytest.mark.parametrize("arch", ["gemma2-9b", "whisper-large-v3",
                                  "zamba2-2.7b"])
def test_training_never_calls_the_flash_kernel(monkeypatch, arch):
    """Training attends through the plain ``transformer.attend`` (JAX's
    ``_attend``): a ``train_loss`` and its backward never reach
    ``fa_ops.mha``, which has no backward on the card."""
    def refuse(*a, **k):
        raise AssertionError("training reached the flash kernel")
    monkeypatch.setattr(fa_ops, "mha", refuse)
    _, cfg = configs(arch)
    loss, grads = port_loss_and_grads(
        registry.get_model(cfg).init(seed=0, device="cpu"), cfg,
        train_batch(cfg))
    assert np.isfinite(loss)
    assert all(np.isfinite(g).all() for g in grads.values())


def test_attend_chunks_long_queries_exactly():
    """``attend`` runs queries past 2,048 in chunks (JAX's
    ``_pick_q_chunk``): the same result as one chunk, causal with a window
    and a softcap, and JAX's ``_attend``."""
    rng = np.random.default_rng(0)
    b, s, h, kv, hd = 1, 4096, 2, 1, 8
    q, k, v = (rng.normal(size=(b, s, n, hd)).astype(np.float32)
               for n in (h, kv, kv))
    pos = np.arange(s)[None]
    assert tfm._pick_q_chunk(s) == 2048 and tfm._pick_q_chunk(2048) == 2048
    assert tfm._pick_q_chunk(4100) == 4100
    got = tfm.attend(*(torch.from_numpy(x) for x in (q, k, v)),
                     torch.from_numpy(pos), torch.from_numpy(pos),
                     window=300, cap=20.0, causal=True)
    want = jtfm._attend(*(jnp.asarray(x) for x in (q, k, v)),
                        jnp.asarray(pos, jnp.int32),
                        jnp.asarray(pos, jnp.int32), causal=True,
                        window=300, softcap=20.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
