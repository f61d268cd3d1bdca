"""The port's analytic cost model (``repro_torch.launch.costmodel``) and the
configs it reads (``ShapeConfig``, ``SHAPES``, ``HardwareSpec`` and the
``ModelConfig`` systems knobs) against the JAX package's, on the CPU:
``step_cost`` equal to JAX's to 1e-12 relative for every arch of
``ASSIGNED_ARCHS`` x ``SHAPES``, on equal parameter counts (the port counts
on the meta device, JAX by ``eval_shape``)."""
import dataclasses
import functools

import pytest

from repro import configs as jconfigs
from repro.launch import costmodel as jcost
from repro.models import registry as jregistry
from repro_torch import configs as pconfigs
from repro_torch.configs.base import HW, HardwareSpec, ShapeConfig
from repro_torch.launch import costmodel as pcost
from repro_torch.models import registry as pregistry

ARCHS = pconfigs.ASSIGNED_ARCHS
KNOBS = ("param_sharding", "serve_param_sharding", "decode_param_sharding",
         "grad_accum", "supports_long_context", "remat", "dtype")
RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _jax_counts_once():
    """JAX's ``param_count`` traces the full-size init each call: memoized
    per config for this module (restored after it)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jregistry, "param_count",
                   functools.lru_cache(None)(jregistry.param_count))
        yield


def test_shapes_match_jax():
    assert list(pconfigs.SHAPES) == list(jconfigs.SHAPES)
    for name, shape in pconfigs.SHAPES.items():
        assert isinstance(shape, ShapeConfig)
        assert dataclasses.asdict(shape) == \
            dataclasses.asdict(jconfigs.SHAPES[name])
    assert [f.name for f in dataclasses.fields(ShapeConfig)] == \
        [f.name for f in dataclasses.fields(jconfigs.ShapeConfig)]


def test_hardware_spec_is_the_cards():
    """The H100's constants, under JAX's field names (and f32's peak)."""
    assert HW == HardwareSpec()
    assert (HW.peak_flops, HW.hbm_bw, HW.ici_bw, HW.peak_flops_f32) == \
        (989e12, 3.35e12, 450e9, 67e12)
    assert {f.name for f in dataclasses.fields(jconfigs.HardwareSpec)} <= \
        {f.name for f in dataclasses.fields(HardwareSpec)}


@pytest.mark.parametrize("arch", ARCHS)
def test_model_config_knobs_match_jax(arch):
    p, j = pconfigs.get_config(arch), jconfigs.get_config(arch)
    for knob in KNOBS:
        assert getattr(p, knob) == getattr(j, knob), knob
        assert getattr(p.reduced(), knob) == getattr(j.reduced(), knob), knob


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_jax(arch):
    p, j = pconfigs.get_config(arch), jconfigs.get_config(arch)
    assert pregistry.param_count(p) == jregistry.param_count(j)
    assert pregistry.active_param_count(p) == jregistry.active_param_count(j)


@pytest.mark.parametrize("arch", ARCHS)
def test_step_cost_matches_jax(arch):
    p, j = pconfigs.get_config(arch), jconfigs.get_config(arch)
    for name in pconfigs.SHAPES:
        got = pcost.step_cost(p, pconfigs.SHAPES[name])
        want = jcost.step_cost(j, jconfigs.SHAPES[name])
        for field in ("flops", "hbm_bytes", "fwd_flops"):
            g, w = getattr(got, field), getattr(want, field)
            assert w > 0 and abs(g - w) <= RTOL * abs(w), (name, field, g, w)


@pytest.mark.parametrize("arch", ["granite-3-8b", "gemma2-9b",
                                  "deepseek-moe-16b", "zamba2-2.7b"])
def test_step_cost_of_reduced_and_odd_shapes_match_jax(arch):
    """The shapes ``chip_smoke.py`` phase 23 (c) prices (its measured
    steps), and the reduced configs: remat 'none' takes the x3 train
    multiplier."""
    p, j = pconfigs.get_config(arch), jconfigs.get_config(arch)
    for cfg_p, cfg_j in ((p, j), (p.reduced(), j.reduced())):
        for seq, batch, kind in ((4608, 2, "prefill"), (4640, 2, "decode"),
                                 (4096, 2, "train"), (17, 3, "train")):
            got = pcost.step_cost(cfg_p, ShapeConfig("x", seq, batch, kind))
            want = jcost.step_cost(cfg_j, jconfigs.ShapeConfig(
                "x", seq, batch, kind))
            for field in ("flops", "hbm_bytes", "fwd_flops"):
                g, w = getattr(got, field), getattr(want, field)
                assert abs(g - w) <= RTOL * abs(w), (seq, kind, field, g, w)
