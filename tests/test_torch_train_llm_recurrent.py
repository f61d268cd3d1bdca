"""The LLM trainer on the CPU against the JAX package, for the families
beyond the decoders, reduced: whisper-large-v3 (the encoder-decoder on zero
frames), xlstm-350m (mLSTM and sLSTM blocks) and zamba2-2.7b (Mamba2 blocks
and the shared attention block).

Each config's ``train_loss`` and gradients on ``train_llm``'s first batch,
from JAX's params, against ``jax.value_and_grad(api.train_loss)``; 3 steps
of ``train_llm`` against JAX's. Set-up and tolerances in
``_torch_llm_common.py``; JAX's references are jitted once per module."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_llm_common import (LOSS_RTOL, _one_torch_thread,  # noqa: F401
                               assert_matches_jax,
                               assert_trajectory_matches_jax, configs,
                               jax_loss_and_grads, port_model, train_batch)
from repro.models import registry as jregistry
from repro_torch.models import registry

ARCHS = ["whisper-large-v3", "xlstm-350m", "zamba2-2.7b"]


@pytest.fixture(scope="module")
def refs():
    return {arch: jax_loss_and_grads(arch) for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_jax(refs, arch):
    """The loss within 1e-5 relative, every gradient within 1e-5 of its JAX
    leaf's largest element (the sLSTM's input-gate bias, whose exact
    gradient is zero, as ``_torch_llm_common.ZERO_GRAD`` says), the leaves
    in JAX's ``tree_leaves`` order."""
    assert_matches_jax(refs[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_llm_trajectory_matches_jax(arch):
    """3 steps of ``train_llm`` from JAX's init: losses within 1e-5
    relative, parameters within 1e-6 (2 lr a step where a gradient fell
    under 1e-6)."""
    assert_trajectory_matches_jax(arch)


def test_slstm_input_gate_bias_leaves_the_loss_unchanged(refs):
    """Why the sLSTM's input-gate bias has a zero gradient: shifting it by
    1.0 changes neither package's loss beyond f32 rounding."""
    ref = refs["xlstm-350m"]
    jcfg, cfg = configs("xlstm-350m")
    batch = train_batch(cfg)
    shifted = jax.tree_util.tree_map(np.asarray, ref["params"])
    shifted["blocks"]["slstm"]["w_i"]["b"] = \
        shifted["blocks"]["slstm"]["w_i"]["b"] + 1.0
    jloss = float(jregistry.get_model(jcfg).train_loss(
        shifted, {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        loss = float(registry.get_model(cfg).train_loss(
            port_model(shifted, cfg),
            {k: torch.from_numpy(v) for k, v in batch.items()}))
    np.testing.assert_allclose([jloss, loss], ref["loss"], rtol=LOSS_RTOL)


def test_gla_chunked_gradient_stays_finite_under_strong_decay():
    """A chunk whose log-decays sum past ~88 (Mamba2's dt after a few bf16
    training steps): ``gla_chunked`` and its gradient equal the step-by-step
    recurrence's, finite, within 1e-5 of each output's largest element (the
    chunked form sums in another order). The entries above the diagonal are
    masked before the exp; JAX's ``where(mask, exp(dmat), 0)`` overflows
    there and its gradient is NaN (tested alongside)."""
    from repro.models import ssm as jssm
    from repro_torch.models import ssm

    rng = np.random.default_rng(0)
    b, t, h, d = 2, 64, 2, 8
    q, k, v = (rng.normal(size=(b, t, h, d)).astype(np.float32)
               for _ in range(3))
    log_a = -rng.uniform(2.0, 4.0, size=(b, t, h)).astype(np.float32)
    log_b = rng.normal(size=(b, t, h)).astype(np.float32) * 0.1
    outs = []
    for fn in (ssm.gla_chunked, ssm.gla_scan_reference):
        args = [torch.from_numpy(x).requires_grad_()
                for x in (q, k, v, log_a, log_b)]
        y = fn(*args, torch.zeros((b, h, d, d)))[0]
        y.square().sum().backward()
        outs.append([y.detach().numpy()] + [a.grad.numpy() for a in args])
    for got, want in zip(*outs):
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    def jax_loss(la):
        y = jssm.gla_chunked(q, k, v, la, log_b, jnp.zeros((b, h, d, d)),
                             chunk=t)[0]
        return jnp.square(y).sum()
    assert not np.isfinite(np.asarray(jax.grad(jax_loss)(log_a))).all()
