"""The port's ``make_gnn_step_fn`` for 5 steps against JAX's
``make_gnn_step_fn(mesh=None)`` on the CPU: losses, gradient norms and the
parameters after each step (split from ``test_torch_train.py``; size and
set-up in ``_torch_train_common.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_train_common import (LOSS_RTOL, _model, _np, _torch_batch,
                                 build_data)
from repro.launch import train as jtrain
from repro.optim import adam as jadam
from repro_torch.launch import train as ptrain
from repro_torch.models.convert import params_to_jax
from repro_torch.optim import adam as padam


@pytest.fixture(scope="module")
def data():
    return build_data()


# Parameters after each of 5 Adam steps: 1e-6 (f32 on both sides, gradients
# agree to 3.3e-7 absolute). Adam divides each gradient element by its own
# running RMS plus eps = 1e-8, so an element whose gradient is near eps
# turns the gradient's rounding into an update error of up to the learning
# rate: at this size one element of proc_node's second weight has a
# gradient of 5.3e-9 (JAX) against 4.9e-9 (port), the leftover of a
# cancellation, and its update differs by 1.45e-5. Elements whose gradient
# fell below NEAR_ZERO at any step so far (0.16 % of them after 5 steps)
# are held only to that bound, 2 lr_max a step, and may be at most
# MAX_NEAR_ZERO of all elements; the rest differ by at most 2.2e-7.
TRAJ_ATOL = 1e-6
NEAR_ZERO = 1e-7
MAX_NEAR_ZERO = 0.01


def test_five_step_trajectory_matches_jax(data):
    """5 steps of make_gnn_step_fn against JAX make_gnn_step_fn(mesh=None):
    the losses, the gradient norms, and the parameters after each step."""
    jcfg, cfg = data["jcfg"], data["cfg"]
    opt_cfg = padam.AdamConfig(total_steps=5)
    jstep = jtrain.make_gnn_step_fn(jcfg, jadam.AdamConfig(total_steps=5),
                                    mesh=None)
    pstep = ptrain.make_gnn_step_fn(cfg, opt_cfg)
    params = data["params"]
    jopt = jadam.adam_init(params)
    model = _model(data)
    popt = padam.adam_init([p for _, p in model.leaves()])
    near_zero = None
    for it in range(5):
        jps, pps = data["jps"][it % 2], data["pps"][it % 2]
        params, jopt, jloss, jgn, jskip = jstep(
            params, jopt, jax.tree_util.tree_map(jnp.asarray, jps.stacked),
            jnp.asarray(jps.denom))
        popt, ploss, pgn, pskip = pstep(model, popt, *_torch_batch(pps))
        assert not bool(jskip) and not pskip
        np.testing.assert_allclose(float(ploss), float(jloss),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(pgn), float(jgn), rtol=LOSS_RTOL)
        small = [np.abs(g) < NEAR_ZERO for g in jax.tree_util.tree_leaves(
            params_to_jax(model, grads=True))]
        near_zero = small if near_zero is None else [
            a | b for a, b in zip(near_zero, small)]
        n_near = sum(int(m.sum()) for m in near_zero)
        assert n_near <= MAX_NEAR_ZERO * sum(m.size for m in near_zero)
        bound = 2 * opt_cfg.lr_max * (it + 1)
        for g, w, nz in zip(jax.tree_util.tree_leaves(params_to_jax(model)),
                            jax.tree_util.tree_leaves(_np(params)),
                            near_zero):
            diff = np.abs(g - w)
            assert diff[~nz].max(initial=0.0) <= TRAJ_ATOL, \
                f"params after step {it}: {diff[~nz].max()}"
            assert diff[nz].max(initial=0.0) <= bound
