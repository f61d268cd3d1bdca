"""The port's LLM serving on the CPU against ``repro.launch.serve``:
reduced gemma2, the JAX serve's params (``PRNGKey(0)``) converted, the same
prompts from the same seed. The 24-token prompt exceeds the reduced window
of 16, so the local layer masks real keys. Generated tokens must be equal."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import serve as jax_serve
from repro.models import registry as jregistry
from repro_torch.configs import get_config
from repro_torch.launch.serve import pad_cache_to, serve
from repro_torch.models.convert import transformer_from_jax


def test_serve_matches_jax_serve():
    jcfg = jax_get_config("gemma2-9b").reduced()
    params = jregistry.get_model(jcfg).init(jax.random.PRNGKey(0))
    model = transformer_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 get_config("gemma2-9b").reduced(),
                                 device="cpu")
    want = jax_serve("gemma2-9b", True, 2, 24, 8)
    got = serve("gemma2-9b", True, 2, 24, 8, device="cpu", params=model)
    assert got["generated"].shape == (2, 8)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert set(got) == set(want)
    assert got["prefill_s"] > 0 and got["tokens_per_s"] > 0


def test_serve_draws_params_from_seed():
    a = serve("gemma2-9b", True, 1, 8, 3, seed=5, device="cpu")
    b = serve("gemma2-9b", True, 1, 8, 3, seed=5, device="cpu")
    np.testing.assert_array_equal(a["generated"], b["generated"])
    assert ((0 <= a["generated"]) & (a["generated"] < 512)).all()


def test_pad_cache_to_casts_into_the_front():
    cache = {"k": torch.full((1, 2, 1, 3, 1, 4), 1.001),
             "v": torch.full((1, 2, 1, 3, 1, 4), -2.0)}
    target = {n: torch.zeros((1, 2, 1, 5, 1, 4), dtype=torch.bfloat16)
              for n in cache}
    out = pad_cache_to(cache, target)
    assert out is target and out["k"].dtype == torch.bfloat16
    assert torch.equal(out["k"][:, :, :, :3],
                       torch.full((1, 2, 1, 3, 1, 4), 1.001).bfloat16())
    assert not out["k"][:, :, :, 3:].any()
    with pytest.raises(ValueError, match="does not fit"):
        pad_cache_to({"k": torch.zeros(1, 2, 1, 6, 1, 4)}, {"k": target["k"]})
