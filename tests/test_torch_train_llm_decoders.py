"""The LLM trainer on the CPU against the JAX package, for the seven
decoders, reduced: granite-3-8b, starcoder2-15b, yi-34b (dense), gemma2-9b
(softcaps, a window, tied embeddings), deepseek-moe-16b and qwen3-moe-30b-a3b
(MoE with the aux loss) and pixtral-12b (its zero vision prefix).

Each config's ``train_loss`` and gradients on ``train_llm``'s first batch,
from JAX's params, against ``jax.value_and_grad(api.train_loss)``; then
3 steps of ``train_llm`` for gemma2-9b and qwen3-moe. Set-up and
tolerances in ``_torch_llm_common.py``; JAX's references are jitted once
per module."""
import pytest

from _torch_llm_common import (_one_torch_thread,  # noqa: F401
                               assert_matches_jax,
                               assert_trajectory_matches_jax,
                               jax_loss_and_grads)
from repro_torch.configs import ASSIGNED_ARCHS, get_config

ARCHS = [a for a in ASSIGNED_ARCHS
         if get_config(a).ssm is None and not get_config(a).is_encoder_decoder]


@pytest.fixture(scope="module")
def refs():
    return {arch: jax_loss_and_grads(arch) for arch in ARCHS}


def test_the_seven_decoders():
    assert sorted(ARCHS) == sorted(
        ["starcoder2-15b", "pixtral-12b", "granite-3-8b", "deepseek-moe-16b",
         "yi-34b", "gemma2-9b", "qwen3-moe-30b-a3b"])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_jax(refs, arch):
    """The loss (MoE: with ``router_aux_weight`` times the aux loss) within
    1e-5 relative, every gradient within 1e-5 of its JAX leaf's largest
    element, the leaves in JAX's ``tree_leaves`` order."""
    assert_matches_jax(refs[arch])


@pytest.mark.parametrize("arch", ["gemma2-9b", "qwen3-moe-30b-a3b"])
def test_train_llm_trajectory_matches_jax(arch):
    """3 steps of ``train_llm`` from JAX's init: losses within 1e-5
    relative, parameters within 1e-6 (2 lr a step where a gradient fell
    under 1e-6)."""
    assert_trajectory_matches_jax(arch)
