"""X-UNet3D (paper SVI) in the port against the JAX package, on the CPU.

The same params (a JAX-layout tree drawn with numpy, loaded by
``models.convert.xunet_from_jax``) and the same inputs go through
``repro.models.xunet3d`` and ``repro_torch.models.xunet3d`` at the reduced
config (depth 2) and at a narrow depth-3 config with and without attention
gates (only depth 3 has two pooling levels and the full config's receptive
field of 26): forward and ``train_loss`` with the continuity term within
1e-5, gradients within 1e-5 of each leaf's largest element (see
``test_forward_loss_and_grads_match_jax`` for the reference). The halo
partitioning (``core.unet_halo``) against JAX's, and the launch twin of
``examples/xunet_volume.py`` against that example's Adam loop. Each JAX
reference is computed once (module-scoped), each through one ``jax.jit``.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import UNetConfig as JUNetConfig
from repro.core import unet_halo as junet_halo
from repro.models import xunet3d as jxunet
from repro.optim import adam as jadam
from repro_torch.configs import get_config
from repro_torch.configs.base import UNetConfig
from repro_torch.core import unet_halo
from repro_torch.launch import xunet_volume
from repro_torch.models import xunet3d
from repro_torch.models.convert import xunet_from_jax, xunet_to_jax
from repro_torch.optim.adam import AdamConfig

ATOL = 1e-5          # forward outputs, partitioned against full
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5     # of each leaf's largest |element|
CONTINUITY = 0.05

# name -> (config overrides, grid); the reduced config is depth 2, base 8
CASES = {
    "depth2": ({}, (32, 16, 16)),
    "depth3": (dict(base_channels=4, depth=3), (16, 8, 8)),
    "depth3_no_gates": (dict(base_channels=4, depth=3,
                             attention_gates=False), (16, 8, 8)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """Deterministic CPU sums (PyTorch's intra-op threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name, grid=None):
    kw, g = CASES[name]
    g = grid or g
    return (JUNetConfig().reduced().replace(grid=g, **kw),
            UNetConfig().reduced().replace(grid=g, **kw))


def _jax_tree(jcfg, seed=0):
    """A JAX-layout param tree (numpy), shaped as ``jxunet.init`` shapes it
    (read from ``jax.eval_shape``, nothing compiled): weights uniform in
    the init's limits, biases small and nonzero."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jxunet.init(k, jcfg),
                            jax.random.PRNGKey(0))

    def draw(s):
        if len(s.shape) == 5:
            lim = (1.0 / (s.shape[3] * s.shape[0] ** 3)) ** 0.5
            return rng.uniform(-lim, lim, s.shape).astype(np.float32)
        return rng.normal(0.0, 0.01, s.shape).astype(np.float32)
    return jax.tree_util.tree_map(draw, shapes)


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(1, *cfg.grid, cfg.in_channels)).astype(np.float32),
            rng.normal(size=(1, *cfg.grid, cfg.out_channels)).astype(
                np.float32))


@pytest.fixture(scope="module")
def jax_ref():
    """name -> (tree, x, y, JAX forward, JAX loss, JAX f32 grads, JAX f64
    grads), computed on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            jcfg, _ = _cfgs(name)
            tree = _jax_tree(jcfg)
            x, y = _inputs(jcfg)
            out = np.asarray(jax.jit(
                lambda p, x: jxunet.apply(p, jcfg, x))(tree, x))
            vg = jax.value_and_grad(
                lambda p, b: jxunet.train_loss(p, jcfg, b, CONTINUITY))
            loss, grads = jax.jit(vg)(tree, {"inputs": x, "targets": y})
            with jax.enable_x64(True):
                f64 = jax.tree_util.tree_map(
                    lambda a: np.asarray(a, np.float64), tree)
                _, grads64 = jax.jit(vg)(
                    f64, {"inputs": x.astype(np.float64),
                          "targets": y.astype(np.float64)})
                grads64 = jax.tree_util.tree_map(np.asarray, grads64)
            cache[name] = (tree, x, y, out, float(loss),
                           jax.tree_util.tree_map(np.asarray, grads), grads64)
        return cache[name]
    return get


def _model(name, tree):
    return xunet_from_jax(tree, _cfgs(name)[1], device="cpu")


@pytest.mark.parametrize("name", list(CASES))
def test_forward_loss_and_grads_match_jax(jax_ref, name):
    """Forward and loss against JAX in f32. Gradients against JAX's exact
    gradient, the same function in f64: each leaf within 1e-5 of its
    largest element. A gate's leaves at depth 3 get gradients about 100x
    below the tree's, the residue of a cancellation, which f32 computes to
    only a few 1e-5 of themselves: JAX's own f32 gradient of the depth-3
    ``psi`` bias is 4.6e-5 off the f64 one (the port's 2.0e-5). Such a leaf
    may be as far from the f64 gradient as JAX's own f32 gradient is."""
    tree, x, y, want, jloss, jgrads, jgrads64 = jax_ref(name)
    model = _model(name, tree)
    got = model.apply(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=ATOL)
    loss = xunet3d.train_loss(model, {"inputs": torch.from_numpy(x),
                                      "targets": torch.from_numpy(y)},
                              CONTINUITY)
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=LOSS_RTOL)
    loss.backward()
    got_g = jax.tree_util.tree_leaves(xunet_to_jax(model, grads=True))
    want_g = jax.tree_util.tree_leaves(jgrads64)
    jax_g = jax.tree_util.tree_leaves(jgrads)
    assert len(got_g) == len(want_g) == len(jax_g)
    for g, w, j in zip(got_g, want_g, jax_g):
        scale = float(np.abs(w).max())
        assert scale > 0
        bound = max(GRAD_RTOL * scale, float(np.abs(j - w).max()))
        assert float(np.abs(g - w).max()) <= bound


@pytest.mark.parametrize("name", list(CASES))
def test_param_tree_round_trips_in_the_jax_layout(name):
    """``init`` draws the JAX init's tree (every key and shape; ``gates``
    entries ``None`` without gates), and ``xunet_from_jax`` of it gives
    back the same model."""
    jcfg, cfg = _cfgs(name)
    model = xunet3d.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tree = xunet_to_jax(model)
    want = jax.eval_shape(lambda k: jxunet.init(k, jcfg),
                          jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(want)
    for a, s in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(want)):
        assert a.shape == s.shape
    if not cfg.attention_gates:
        assert tree["gates"] == [None] * (cfg.depth - 1)
    back = xunet_from_jax(tree, cfg, device="cpu")
    for (n1, p1), (n2, p2) in zip(model.leaves(), back.leaves()):
        assert n1 == n2 and torch.equal(p1, p2)


@pytest.mark.parametrize("extent,n_parts,halo,align", [
    (32, 2, 10, 2), (32, 4, 8, 2), (64, 4, 28, 4), (800, 10, 40, 4),
    (240, 3, 40, 4), (240, 3, 4, 4), (96, 2, 26, 4), (44, 4, 3, 4),
    (20, 3, 0, 1), (16, 4, 5, 1)])
def test_slab_partitions_equal_jax(extent, n_parts, halo, align):
    assert unet_halo.slab_partitions(extent, n_parts, halo, align) == \
        junet_halo.slab_partitions(extent, n_parts, halo, align)


def test_receptive_field_equals_jax():
    for name in CASES:
        jcfg, cfg = _cfgs(name)
        assert xunet3d.receptive_field(cfg) == jxunet.receptive_field(jcfg)
    assert xunet3d.receptive_field(get_config("xunet3d-drivaer")) == 26


def _partition_case(name, x_extent):
    jcfg, cfg = _cfgs(name, (x_extent,) + CASES[name][1][1:])
    model = _model(name, _jax_tree(jcfg))
    x = torch.from_numpy(_inputs(cfg)[0])
    return cfg, model, x


@pytest.mark.parametrize("name,x_extent", [("depth2", 32), ("depth3", 96)])
@pytest.mark.parametrize("n_parts", [2, 4])
def test_partitioned_equals_full(name, x_extent, n_parts):
    """The paper's core equivalence, voxel edition: the halo rounded up to
    the alignment covers the receptive field."""
    cfg, model, x = _partition_case(name, x_extent)
    align = 2 ** (cfg.depth - 1)
    halo = -(-xunet3d.receptive_field(cfg) // align) * align
    with torch.no_grad():
        full = model.apply(x)
        part = unet_halo.apply_partitioned(model.apply, x, n_parts, halo,
                                           axis=1, align=align)
    assert part.shape == full.shape
    assert float((part - full).abs().max()) <= ATOL


@pytest.mark.parametrize("name,x_extent", [("depth2", 32), ("depth3", 96)])
def test_insufficient_halo_differs(name, x_extent):
    cfg, model, x = _partition_case(name, x_extent)
    align = 2 ** (cfg.depth - 1)
    with torch.no_grad():
        full = model.apply(x)
        part = unet_halo.apply_partitioned(model.apply, x, 2, align, axis=1,
                                           align=align)
    assert float((part - full).abs().max()) > 1e-4


def test_find_receptive_halo_equals_jax():
    """The empirical finder, port and JAX, on the same depth-3 model and
    input (X long enough for every halo up to the analytic 26, rounded to
    28): the same halo, within the analytic bound and above one
    alignment unit."""
    jcfg, cfg = _cfgs("depth3", (64, 4, 4))
    tree = _jax_tree(jcfg)
    x = _inputs(cfg)[0]
    model = xunet_from_jax(tree, cfg, device="cpu")
    align = 2 ** (cfg.depth - 1)
    bound = -(-xunet3d.receptive_field(cfg) // align) * align
    with torch.no_grad():
        got = unet_halo.find_receptive_halo(
            model.apply, torch.from_numpy(x), axis=1, n_parts=2, align=align,
            max_halo=bound + 2 * align)
    japply = jax.jit(lambda x: jxunet.apply(tree, jcfg, x))
    want = junet_halo.find_receptive_halo(
        japply, jnp.asarray(x), axis=1, n_parts=2, align=align,
        max_halo=bound + 2 * align)
    assert got == want
    assert align <= got <= bound


@pytest.mark.parametrize("shape", [(5, 4, 3), (2, 7, 2, 5), (1, 2, 3, 4)])
def test_gradient_matches_jnp_at_the_edges(shape):
    """``divergence`` differentiates as ``jnp.gradient``: central inside,
    one-sided first order on the domain's faces."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=shape).astype(np.float32)
    for axis in range(len(shape)):
        if shape[axis] < 2:
            continue
        got = torch.gradient(torch.from_numpy(a), dim=axis,
                             edge_order=1)[0].numpy()
        want = np.asarray(jnp.gradient(jnp.asarray(a), axis=axis))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        first = np.take(a, 1, axis) - np.take(a, 0, axis)
        np.testing.assert_allclose(np.take(got, 0, axis), first, atol=1e-6)
    u = rng.normal(size=(1, 4, 3, 2, 3)).astype(np.float32)
    want = sum(jnp.gradient(jnp.asarray(u[..., i]), axis=i + 1)
               for i in range(3))
    np.testing.assert_allclose(
        xunet3d.divergence(torch.from_numpy(u)).numpy(), np.asarray(want),
        rtol=0, atol=1e-6)


def _jax_example():
    path = Path(__file__).resolve().parents[1] / "examples" / "xunet_volume.py"
    spec = importlib.util.spec_from_file_location("_jax_xunet_volume", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TRAJ_STEPS = 5


def test_twin_trajectory_matches_the_jax_example():
    """``launch.xunet_volume``'s batches equal the JAX example's bit for bit,
    and 5 steps of its loop (the example's Adam, continuity 0.05, batch
    ``it % 3``) follow the example's jitted step: losses within 1e-5
    relative, parameters after the last step within 1e-5 of each leaf's
    largest element."""
    ex = _jax_example()
    cfg = get_config("xunet3d-drivaer").reduced()
    jcfg = JUNetConfig().reduced()
    jbatches = [ex.make_batch(jcfg, i) for i in range(3)]
    batches = [xunet_volume.make_batch(cfg, i, "cpu") for i in range(3)]
    for jb, b in zip(jbatches, batches):
        for k in ("inputs", "targets"):
            assert np.array_equal(np.asarray(jb[k]), b[k].numpy())
    tree = _jax_tree(jcfg)
    model = xunet_from_jax(tree, cfg, device="cpu")

    opt_cfg = jadam.AdamConfig(lr_max=1.5e-4, lr_min=5e-7, total_steps=30)

    @jax.jit
    def step(params, opt, batch):
        loss, g = jax.value_and_grad(
            lambda p: jxunet.train_loss(p, jcfg, batch, 0.05))(params)
        params, opt, _ = jadam.adam_update(opt_cfg, g, opt, params)
        return params, opt, loss

    params, opt = tree, jadam.adam_init(tree)
    want = []
    for it in range(TRAJ_STEPS):
        params, opt, loss = step(params, opt, jbatches[it % 3])
        want.append(float(loss))
    assert xunet_volume.OPT == AdamConfig(lr_max=1.5e-4, lr_min=5e-7,
                                          total_steps=30)
    got = xunet_volume.train(model, batches, steps=TRAJ_STEPS, log_every=0)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    for g, w in zip(jax.tree_util.tree_leaves(xunet_to_jax(model)),
                    jax.tree_util.tree_leaves(params)):
        w = np.asarray(w)
        assert float(np.abs(g - w).max()) <= GRAD_RTOL * float(
            np.abs(w).max())


def test_twin_main_runs_on_the_cpu(capsys):
    xunet_volume.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "step 20: loss" in out
    diff = float(out.rsplit("max diff:", 1)[1].split()[0])
    assert diff <= ATOL
