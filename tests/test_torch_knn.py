"""The port's kNN top-k (plain PyTorch path, CPU) against the JAX reference
(``lax.top_k``) and the Pallas kernel in interpret mode.

Indices must be equal, ties included: every version puts the lower
candidate slot first among equal distances. Distances agree to 1e-6 (all
compute dx*dx + dy*dy + dz*dz in f32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.knn import ops as jops
from repro.kernels.knn import ref as jref
from repro_torch.kernels.knn import ops, ref


def _case(kind: str, seed: int, n: int = 150, c: int = 40):
    rng = np.random.default_rng(seed)
    if kind == "random":
        pts = rng.normal(size=(n, 3)).astype(np.float32)
    elif kind == "ties":
        # few distinct positions: most candidate distances are tied
        base = rng.normal(size=(5, 3)).astype(np.float32)
        pts = base[rng.integers(0, 5, n)]
    elif kind == "lattice":
        # integer lattice: exact ties in d2 at every shell
        pts = rng.integers(-2, 3, size=(n, 3)).astype(np.float32)
    else:
        raise ValueError(kind)
    ci = rng.integers(0, n, size=(n, c)).astype(np.int32)
    cv = rng.random((n, c)) < 0.8
    cv[:3, :] = False          # queries with no valid candidate
    cv[3:6, 2:] = False        # queries with fewer valid candidates than k
    return pts, pts[ci], ci, cv


CASES = [("random", 0), ("ties", 1), ("lattice", 2)]


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("kind,seed", CASES)
@pytest.mark.parametrize("k", [1, 6])
def test_plain_topk_matches_jax_ref(kind, seed, k):
    q, cp, ci, cv = _case(kind, seed)
    ji, jd, jm = map(np.asarray, jref.topk_neighbors(
        jnp.asarray(q), jnp.asarray(cp), jnp.asarray(ci), jnp.asarray(cv), k))
    ti, td, tm = ref.topk_neighbors(*_torch(q, cp, ci, cv), k)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_allclose(td.numpy(), jd, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind,seed", CASES)
def test_plain_topk_matches_pallas_interpret(kind, seed):
    q, cp, ci, cv = _case(kind, seed, n=128, c=128)
    ji, jd, _ = map(np.asarray, jops.topk_neighbors(
        jnp.asarray(q), jnp.asarray(cp), jnp.asarray(ci), jnp.asarray(cv), 6,
        impl="pallas", interpret=True))
    ti, td, _ = ops.topk_neighbors(*_torch(q, cp, ci, cv), 6)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(td.numpy(), jd, atol=1e-6, rtol=0)


def test_ties_go_to_lower_slot():
    """All candidates at the same distance: the first k valid slots win."""
    q = np.zeros((1, 3), np.float32)
    cp = np.ones((1, 10, 3), np.float32)
    ci = np.arange(100, 110, dtype=np.int32)[None]
    cv = np.ones((1, 10), bool)
    cv[0, 1] = False
    idx, _, _ = ref.topk_neighbors(*_torch(q, cp, ci, cv), 4)
    assert idx.tolist() == [[100, 102, 103, 104]]

