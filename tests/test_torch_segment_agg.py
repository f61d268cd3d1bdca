"""The port's segment-sum (plain PyTorch path, CPU) against the JAX
reference ``jax.ops.segment_sum`` and the Pallas kernel in interpret mode,
forward and backward.

Tolerance 1e-5 forward: every path sums in f32; only the summation order
differs (the port sums each receiver's run in edge order). The backward is a
row copy on both sides, so it is held bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_agg import ops as jops
from repro.kernels.segment_agg import ref as jref
from repro_torch.kernels.segment_agg import ops, ref

TOL = 1e-5


def _case(kind: str, seed: int):
    """(messages (E, D), receivers (E,), mask (E,) or None, n_segments)."""
    rng = np.random.default_rng(seed)
    if kind == "empty_segments":
        # receivers drawn from a few nodes only: most segments stay empty
        n, e, d = 97, 300, 8
        recv = rng.choice(np.arange(0, n, 7), size=e).astype(np.int32)
        mask = None
    elif kind == "duplicates":
        # heavy fan-in: many edges per receiver, same receivers repeated
        n, e, d = 16, 500, 5
        recv = rng.integers(0, n, e).astype(np.int32)
        mask = None
    elif kind == "masked_on_zero":
        # the fixed-shape edge union: padding slots all carry receiver 0
        n, e, d = 64, 800, 12
        recv = rng.integers(0, n, e).astype(np.int32)
        mask = rng.random(e) > 0.4
        recv = np.where(mask, recv, 0).astype(np.int32)
    else:
        raise ValueError(kind)
    msg = rng.normal(size=(e, d)).astype(np.float32)
    if mask is not None:
        msg = msg * mask[:, None]
    return msg, recv, mask, n


KINDS = ["empty_segments", "duplicates", "masked_on_zero"]


@pytest.mark.parametrize("kind", KINDS)
def test_plain_segment_sum_matches_jax(kind):
    msg, recv, mask, n = _case(kind, 0)
    want = np.asarray(jref.segment_sum(jnp.asarray(msg), jnp.asarray(recv), n))
    # without the caller's CSR prep (one-shot)
    got = ref.segment_sum(torch.from_numpy(msg), torch.from_numpy(recv), n)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    # with the CSR prep, masked edges left out, through the device wrapper
    m = None if mask is None else torch.from_numpy(mask)
    prep = ops.prepare(torch.from_numpy(recv), n, m)
    got = ops.segment_sum_prepared(prep, torch.from_numpy(msg))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_segment_sum_matches_pallas_interpret(kind):
    msg, recv, mask, n = _case(kind, 1)
    prep_j = jops.prepare(recv, n)
    want = np.asarray(jops.segment_sum_prepared(prep_j, jnp.asarray(msg),
                                                interpret=True))
    m = None if mask is None else torch.from_numpy(mask)
    prep = ops.prepare(torch.from_numpy(recv), n, m)
    got = ref.segment_sum_csr(torch.from_numpy(msg), prep.perm, prep.row_ptr)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_csr_prep_leaves_masked_edges_out():
    """Masked slots go to the sentinel segment: node 0's run holds only its
    real edges, and no run covers a masked edge."""
    msg, recv, mask, n = _case("masked_on_zero", 2)
    prep = ops.prepare(torch.from_numpy(recv), n, torch.from_numpy(mask))
    row_ptr = prep.row_ptr.numpy()
    assert row_ptr[0] == 0 and row_ptr[-1] == mask.sum()
    assert (row_ptr[1] - row_ptr[0]) == np.sum(mask & (recv == 0))
    covered = prep.perm.numpy()[:row_ptr[-1]]
    assert mask[covered].all()
    # stable: within a run, edges keep their original order
    for i in range(n):
        run = prep.perm.numpy()[row_ptr[i]:row_ptr[i + 1]]
        assert (np.diff(run) > 0).all()


def test_wrapper_dispatches_cpu_without_launch():
    msg, recv, _, n = _case("duplicates", 3)
    before = ops.segment_sum_prepared.launches
    ops.segment_sum_prepared(ops.prepare(torch.from_numpy(recv), n),
                             torch.from_numpy(msg))
    assert ops.segment_sum_prepared.launches == before



@pytest.mark.parametrize("kind", KINDS)
def test_segment_sum_gradient_matches_jax(kind):
    """The gradient through segment_sum_prepared (autograd, SegmentSum)
    equals JAX's VJP of jax.ops.segment_sum, grad_out[recv], and the plain
    backward; masked edges, which the CSR leaves out, get zero rows (JAX
    gives them grad_out[0], which the model's edge mask zeroes)."""
    msg, recv, mask, n = _case(kind, 4)
    g_out = np.random.default_rng(5).normal(
        size=(n, msg.shape[1])).astype(np.float32)
    _, vjp = jax.vjp(lambda m: jax.ops.segment_sum(m, jnp.asarray(recv),
                                                   num_segments=n),
                     jnp.asarray(msg))
    want = np.asarray(vjp(jnp.asarray(g_out))[0])
    if mask is not None:
        want = want * mask[:, None]
    m = None if mask is None else torch.from_numpy(mask)
    prep = ops.prepare(torch.from_numpy(recv), n, m)
    x = torch.from_numpy(msg).requires_grad_()
    out = ops.segment_sum_prepared(prep, x)
    out.backward(torch.from_numpy(g_out))
    np.testing.assert_array_equal(x.grad.numpy(), want)
    direct = ref.segment_sum_csr_backward(torch.from_numpy(g_out), prep.perm,
                                          prep.row_ptr, msg.shape[0])
    assert torch.equal(x.grad, direct)
    if mask is not None:
        assert not x.grad[torch.from_numpy(~mask)].any()
    if kind == "empty_segments":
        # an empty segment's gradient goes nowhere
        empty = np.setdiff1d(np.arange(n), recv)
        assert len(empty) and not np.isin(recv, empty).any()


def test_segment_sum_saves_only_the_csr():
    """The backward keeps perm and row_ptr, never the (E, D) messages."""
    msg, recv, mask, n = _case("masked_on_zero", 6)
    prep = ops.prepare(torch.from_numpy(recv), n, torch.from_numpy(mask))
    out = ops.segment_sum_prepared(
        prep, torch.from_numpy(msg).requires_grad_())
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 2
    assert saved[0] is prep.perm and saved[1] is prep.row_ptr


def test_backward_dispatches_cpu_without_launch():
    msg, recv, _, n = _case("duplicates", 7)
    prep = ops.prepare(torch.from_numpy(recv), n)
    before = ops.segment_sum_backward.launches
    x = torch.from_numpy(msg).requires_grad_()
    ops.segment_sum_prepared(prep, x).sum().backward()
    assert ops.segment_sum_backward.launches == before
    assert torch.equal(x.grad, torch.ones_like(x))


def test_fake_tensors_take_the_shape_only_form_in_the_dry_run_only():
    """A fake tensor has no values to sum: inside ``_build.dry_run`` the
    references give results of the right shapes; outside it they raise
    rather than return something that is not a segment sum."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import _build
    with FakeTensorMode():
        recv = torch.empty(10, dtype=torch.int32)
        msg = torch.empty(10, 4)
        with pytest.raises(RuntimeError, match="dry_run"):
            ref.prepare(recv, 5)
        with _build.dry_run():
            prep = ref.prepare(recv, 5)
            out = ref.segment_sum_csr(msg, prep.perm, prep.row_ptr)
            grad = ref.segment_sum_csr_backward(out, prep.perm,
                                                prep.row_ptr, 10)
        with pytest.raises(RuntimeError, match="dry_run"):
            ref.segment_sum_csr(msg, prep.perm, prep.row_ptr)
        with pytest.raises(RuntimeError, match="dry_run"):
            ref.segment_sum_csr_backward(out, prep.perm, prep.row_ptr, 10)
    assert not _build.in_dry_run()
    assert prep.row_ptr.shape == (6,) and out.shape == (5, 4)
    assert grad.shape == (10, 4)


def test_plain_dispatch_refuses_a_fake_card_tensor_outside_the_dry_run():
    """A fake tensor on the card has no memory: outside ``_build.dry_run``
    the wrappers' dispatch raises rather than launch a kernel on it (a meta
    tensor stands in for the card's device here: any device but the
    CPU's)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import _build
    with FakeTensorMode(allow_non_fake_inputs=True):
        t = torch.empty(4, 3, device="meta")
    assert t.device.type == "meta"
    with pytest.raises(RuntimeError, match="dry_run"):
        _build.plain(t)
    with _build.dry_run():
        assert _build.plain(t)
    assert not _build.plain(torch.empty(4, 3, device="meta"))
