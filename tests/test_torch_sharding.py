"""The port's LLM sharding rules (``repro_torch.launch.sharding``) against
the JAX package's, on the CPU, for every arch of ``ASSIGNED_ARCHS`` on the
(16, 16), (2, 16, 16) and (4, 2) mesh shapes: ``param_specs`` (modes
``tp``, ``fsdp_tp`` and ``dp``), ``optimizer_state_specs``, ``batch_specs``
(every shape), ``cache_seq_axes`` and ``cache_specs`` (both packages'
decode caches at ``decode_32k`` and ``long_500k``).

JAX's rules read only a mesh's ``.shape`` and ``.axis_names``, so both
packages get the same ``MeshShape`` stand-in. Parameter shapes come from
``jax.eval_shape`` and the port's meta model; caches from ``eval_shape``
and the port's factories under ``FakeTensorMode`` (no memory). A port
tensor that is one group of a stacked JAX leaf takes JAX's spec without its
leading group entry."""
import functools

import jax
import pytest
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.launch import sharding as jshd
from repro.models import registry as jregistry
from repro_torch import configs as pconfigs
from repro_torch.launch import sharding as shd
from repro_torch.models import registry as pregistry

ARCHS = pconfigs.ASSIGNED_ARCHS
MESHES = {"16x16": shd.MeshShape(("data", "model"), (16, 16)),
          "2x16x16": shd.MeshShape(("pod", "data", "model"), (2, 16, 16)),
          "4x2": shd.MeshShape(("data", "model"), (4, 2))}
MODES = ("tp", "fsdp_tp", "dp")


@functools.lru_cache(None)
def jax_params(arch):
    api = jregistry.get_model(jconfigs.get_config(arch))
    return jax.eval_shape(api.init, jax.random.PRNGKey(0))


@functools.lru_cache(None)
def port_model(arch):
    return pregistry.meta_model(pconfigs.get_config(arch))


def _is_spec(x) -> bool:
    return isinstance(x, jax.sharding.PartitionSpec)


def _by_key(specs) -> dict:
    """JAX's specs by key string, each as a tuple."""
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=_is_spec)[0]
    return {jax.tree_util.keystr(path): tuple(s) for path, s in flat}


def _expected(jspecs: dict, name: str) -> tuple:
    key, per_group = shd.jax_key(name)
    want = jspecs[key]
    return want[1:] if per_group and want else want


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_optimizer_specs_match_jax(arch, mesh_name):
    mesh = MESHES[mesh_name]
    jcfg, pcfg = jconfigs.get_config(arch), pconfigs.get_config(arch)
    params = jax_params(arch)
    model = port_model(arch)
    names = [n for n, _ in model.named_parameters()]
    assert sorted({shd.jax_key(n)[0] for n in names}) == sorted(
        jax.tree_util.keystr(p) for p, _ in
        jax.tree_util.tree_flatten_with_path(params)[0])
    dsize = mesh.shape.get("data", 0)
    for mode in MODES:
        jspecs = jshd.param_specs(params, jcfg, mesh, mode=mode)
        want = _by_key(jspecs)
        got = shd.param_specs(model, pcfg, mesh, mode=mode)
        for n in names:
            assert tuple(got[n]) == _expected(want, n), (mode, n, got[n])
        jopt = _by_key(jshd.optimizer_state_specs(params, jspecs, mesh))
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        popt = shd.optimizer_state_specs(shapes, got, mesh)
        for n in names:
            key, per_group = shd.jax_key(n)
            w = jopt[key]
            if per_group and w and w[0] == "data":
                # JAX shards the stacked leaf's group axis on 'data'; the
                # port's group tensor takes it on its first free dimension
                # that divides (the same bytes a device), or keeps its spec
                dims = list(got[n]) + [None] * (len(shapes[n]) - len(got[n]))
                for i, d in enumerate(shapes[n]):
                    if dims[i] is None and d % dsize == 0 and d >= dsize:
                        dims[i] = "data"
                        break
                want_n = tuple(dims) if "data" in dims else tuple(got[n])
            else:
                want_n = w[1:] if per_group and w else w
            assert tuple(popt[n]) == want_n, (mode, n, popt[n], w)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_specs_and_cache_seq_axes_match_jax(mesh_name):
    mesh = MESHES[mesh_name]
    for arch in ARCHS:
        jcfg, pcfg = jconfigs.get_config(arch), pconfigs.get_config(arch)
        for name, shape in pconfigs.SHAPES.items():
            jshape = jconfigs.SHAPES[name]
            for mode in (None,) + MODES:
                got = shd.batch_specs(pcfg, shape, mesh, mode=mode)
                want = jshd.batch_specs(jcfg, jshape, mesh, mode=mode)
                assert {k: tuple(v) for k, v in got.items()} == \
                    {k: tuple(v) for k, v in want.items()}, (arch, name, mode)
            assert shd.cache_seq_axes(shape, mesh) == \
                jshd.cache_seq_axes(jshape, mesh)
    assert shd.data_axes(mesh) == jshd.data_axes(mesh)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_jax(arch, mesh_name):
    """The port's decode caches have JAX's leaf shapes (as multisets), and
    each leaf the spec JAX gives a leaf of its shape."""
    mesh = MESHES[mesh_name]
    jcfg, pcfg = jconfigs.get_config(arch), pconfigs.get_config(arch)
    japi, papi = jregistry.get_model(jcfg), pregistry.get_model(pcfg)
    for name in ("decode_32k", "long_500k"):
        shape, jshape = pconfigs.SHAPES[name], jconfigs.SHAPES[name]
        b, s = shape.global_batch, shape.seq_len
        jcache = jax.eval_shape(lambda: japi.empty_cache(b, s))
        jspecs = jshd.cache_specs(jcfg, jshape, mesh, jcache)
        want = {}
        for leaf, spec in zip(jax.tree_util.tree_leaves(jcache),
                              jax.tree_util.tree_leaves(jspecs,
                                                        is_leaf=_is_spec)):
            want.setdefault(tuple(leaf.shape), set()).add(tuple(spec))
        with FakeTensorMode():
            cache = papi.empty_cache(b, s, device="cpu")
        assert sorted(tuple(t.shape) for t in cache.values()) == sorted(
            tuple(x.shape) for x in jax.tree_util.tree_leaves(jcache))
        got = shd.cache_specs(pcfg, shape, mesh, cache)
        for k, t in cache.items():
            assert want[tuple(t.shape)] == {tuple(got[k])}, (name, k)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = MESHES["2x16x16"]
    assert shd.placements(shd.Spec(("pod", "data"), None, "model"), mesh) \
        == [Shard(0), Shard(0), Shard(2)]
    assert shd.placements(shd.Spec(), mesh) == [Replicate()] * 3
    assert shd.placements(shd.Spec(None, "data"), MESHES["4x2"]) == \
        [Shard(1), Replicate()]
    assert shd._fit(shd.Spec("model", "data"), (24, 4), MESHES["16x16"]) \
        == shd.Spec(None, None)
    assert shd.jax_key("blocks.3.layers.1.attn.wq.w") == (
        "['blocks']['layers'][1]['attn']['wq']['w']", True)
    assert shd.jax_key("first_layers.0.mlp.w_up.w") == (
        "['first_layers'][0]['mlp']['w_up']['w']", False)
