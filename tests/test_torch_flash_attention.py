"""The port's flash-attention wrapper on the CPU (its plain version) against
the JAX package's reference and its interpret-mode Pallas kernel.

Inputs are made with numpy from a seed. Tolerances are those of
``tests/test_kernels.py``: 2e-5 in float32 (the sums run in another order)
and 2e-2 in bfloat16 (one rounding of the output, plus the two frameworks'
bf16 matmul inputs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention import ref as jfa_ref
from repro_torch.kernels.flash_attention import ops as fa_ops

CASES = [
    # (B, Sq, Skv, H, KV, hd, causal, window, softcap), tests/test_kernels.py
    (1, 128, 128, 2, 2, 64, True, None, None),
    (2, 256, 256, 4, 2, 64, True, None, None),        # GQA
    (1, 256, 256, 2, 1, 128, True, 64, None),         # sliding window
    (1, 128, 128, 2, 2, 64, True, None, 50.0),        # softcap (gemma2)
    (1, 256, 256, 2, 2, 32, False, None, None),       # bidirectional
    (2, 384, 384, 8, 8, 64, True, 128, 30.0),         # everything at once
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# The card's f32 kernel is built for hd = 256 and 128, with 64-row blocks
# and 64-key tiles: its plain version at those widths, over the edges of
# that tiling (the card tests hold the kernel to the plain version there).
EDGE_CASES = [
    (1, 1, 1, 2, 1, 256, True, None, 50.0),        # S = 1
    (2, 17, 17, 4, 2, 256, True, None, 50.0),      # under one tile
    (1, 65, 65, 2, 1, 256, True, None, 50.0),      # one row past 64
    (1, 129, 129, 4, 2, 256, True, 100, 50.0),     # one row past 128
    (1, 200, 200, 2, 1, 256, True, 1, 50.0),       # each row sees itself
    (1, 160, 160, 2, 1, 256, True, 40, 50.0),      # window under 64 rows
    (1, 150, 150, 2, 1, 256, False, 40, 50.0),     # non-causal window
    (1, 96, 96, 8, 1, 256, True, None, 50.0),      # group 8
]
# The same kernels at hd = 128 (the decoders of granite, starcoder2, yi,
# deepseek-moe, qwen3-moe and pixtral): their GQA groups, ragged S, and the
# window and softcap the kernels take at either width.
EDGE_CASES_128 = [
    (1, 200, 200, 7, 1, 128, True, None, None),    # yi: 56 / 8
    (1, 130, 130, 12, 1, 128, True, None, None),   # starcoder2: 48 / 4
    (2, 300, 300, 8, 1, 128, True, None, None),    # qwen3-moe: 32 / 4
    (1, 1, 1, 2, 1, 128, True, None, None),        # S = 1
    (1, 160, 160, 4, 2, 128, True, 40, 50.0),      # window and softcap
    (1, 150, 150, 2, 2, 128, False, None, None),   # non-causal (deepseek MHA)
]


def _inputs(case, seed):
    b, sq, skv, h, kvh, hd = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, hd)).astype(np.float32),
            rng.normal(size=(b, skv, kvh, hd)).astype(np.float32),
            rng.normal(size=(b, skv, kvh, hd)).astype(np.float32))


_jit_ref = jax.jit(jfa_ref.attention, static_argnames=(
    "group_size", "causal", "window", "softcap"))


def _jax_ref(q, k, v, case, dtype):
    b, sq, skv, h, kvh, hd, causal, window, cap = case
    qj, kj, vj = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    want = _jit_ref(
        qj.transpose(0, 2, 1, 3).reshape(b * h, sq, hd),
        kj.transpose(0, 2, 1, 3).reshape(b * kvh, skv, hd),
        vj.transpose(0, 2, 1, 3).reshape(b * kvh, skv, hd),
        group_size=h // kvh, causal=causal, window=window, softcap=cap)
    return np.asarray(want.reshape(b, h, sq, hd).transpose(0, 2, 1, 3),
                      np.float32)


def _port(q, k, v, case, dtype):
    *_, causal, window, cap = case
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    out = fa_ops.mha(tq, tk, tv, causal=causal, window=window, softcap=cap)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    return out.float().numpy()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_matches_jax_ref(case, dtype):
    q, k, v = _inputs(case, CASES.index(case))
    np.testing.assert_allclose(_port(q, k, v, case, dtype),
                               _jax_ref(q, k, v, case, getattr(jnp, dtype)),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("case", [CASES[1], CASES[5]],
                         ids=["gqa", "everything"])
def test_mha_matches_jax_pallas_interpret(case):
    q, k, v = _inputs(case, 10 + CASES.index(case))
    *_, causal, window, cap = case
    want = np.asarray(jfa_ops.mha(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window, softcap=cap,
                                  interpret=True))
    np.testing.assert_allclose(_port(q, k, v, case, "float32"), want,
                               rtol=TOL["float32"], atol=TOL["float32"])


@pytest.mark.parametrize("case", EDGE_CASES,
                         ids=["s1", "s17", "s65", "s129", "window1",
                              "window40", "noncausal_window", "group8"])
def test_mha_matches_jax_ref_at_kernel_width(case):
    q, k, v = _inputs(case, 20 + EDGE_CASES.index(case))
    np.testing.assert_allclose(_port(q, k, v, case, "float32"),
                               _jax_ref(q, k, v, case, jnp.float32),
                               rtol=TOL["float32"], atol=TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", EDGE_CASES_128,
                         ids=["group7", "group12", "group8", "s1",
                              "window_softcap", "noncausal"])
def test_mha_matches_jax_ref_at_hd128(case, dtype):
    q, k, v = _inputs(case, 40 + EDGE_CASES_128.index(case))
    np.testing.assert_allclose(_port(q, k, v, case, dtype),
                               _jax_ref(q, k, v, case, getattr(jnp, dtype)),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("case", [(1, 128, 128, 7, 1, 128, True, None, None),
                                  (1, 256, 256, 12, 1, 128, True, 64, 30.0)],
                         ids=["group7", "group12_window_softcap"])
def test_mha_matches_jax_pallas_interpret_at_hd128(case):
    """Odd GQA groups at hd = 128 against the Pallas kernel in interpret
    mode (S a multiple of its 128-row blocks)."""
    q, k, v = _inputs(case, 50)
    *_, causal, window, cap = case
    want = np.asarray(jfa_ops.mha(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window, softcap=cap,
                                  interpret=True))
    np.testing.assert_allclose(_port(q, k, v, case, "float32"), want,
                               rtol=TOL["float32"], atol=TOL["float32"])


def test_mha_matches_jax_pallas_interpret_at_kernel_width():
    """Group 8 at hd = 256 against the Pallas kernel in interpret mode (S =
    96 is one of its blocks)."""
    case = EDGE_CASES[-1]
    q, k, v = _inputs(case, 30)
    *_, causal, window, cap = case
    want = np.asarray(jfa_ops.mha(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window, softcap=cap,
                                  interpret=True))
    np.testing.assert_allclose(_port(q, k, v, case, "float32"), want,
                               rtol=TOL["float32"], atol=TOL["float32"])


def test_causal_first_row_attends_self_only():
    """Causal row 0 is v[0] (softmax over one key)."""
    q, k, v = _inputs((1, 128, 128, 1, 1, 64), 3)
    out = _port(q, k, v, (1, 128, 128, 1, 1, 64, True, None, None),
                "float32")
    np.testing.assert_allclose(out[0, 0, 0], v[0, 0, 0], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("window", [None, 48])
def test_ragged_length_matches_jax_ref(window):
    """S = 200 is no multiple of any block: the port masks the tail itself
    (the JAX reference takes any length; its Pallas kernel does not)."""
    case = (2, 200, 200, 4, 2, 64, True, window, 50.0)
    q, k, v = _inputs(case, 7)
    np.testing.assert_allclose(_port(q, k, v, case, "float32"),
                               _jax_ref(q, k, v, case, jnp.float32),
                               rtol=TOL["float32"], atol=TOL["float32"])


def test_cpu_path_launches_no_kernel():
    case = CASES[0]
    before = fa_ops.mha.launches
    _port(*_inputs(case, 0), case, "float32")
    assert fa_ops.mha.launches == before
