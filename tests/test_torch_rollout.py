"""The port's transient-rollout engine (``repro_torch.launch.rollout``) on the
CPU, held against its own single-shot serving and against the JAX engine
(``repro.launch.rollout.RolloutEngine``).

Size: ``GNNConfig().reduced()`` (hidden 64, 3 layers) with levels (64, 128,
256); weights from the JAX init, carried by ``params_from_jax``; traffic the
demo cars, clouds sampled with numpy from a seed. Within the port, a
one-step rollout is bit-equal to ``serve()``, interleaved rollouts to their
solo runs, and a partial flush to chained single steps (the same operations
on the same values, one lane at a time). Against JAX, request ids are
equal, sampled points bit-equal, and fields agree to ``ATOL`` (stated
below). The chaos cases arm both packages' ``FAULTS`` the same way and
require the same outcome: the same errors, ``steps_done`` and counters.
"""
import functools
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import GNNConfig as JaxGNNConfig
from repro.launch import rollout as jrollout
from repro.launch.serve_gnn import GNNServer as JaxGNNServer
from repro.models import meshgraphnet as jmgn
from repro.resilience import FAULTS as JFAULTS
from repro_torch.configs.base import GNNConfig
from repro_torch.core.graph_build import sample_surface
from repro_torch.data import geometry as geo
from repro_torch.launch import rollout as prollout
from repro_torch.launch import serve_gnn
from repro_torch.launch.rollout import ROLLOUT_STAGES
from repro_torch.launch.serve_gnn import GNNServer
from repro_torch.models.convert import params_from_jax
from repro_torch.resilience import FAULTS

LEVELS = (64, 128, 256)
# Fields against JAX: the serving parity's tolerance (f32 on both sides,
# matmuls and reductions summed in other orders; sin/cos of the features
# from other math libraries).
ATOL = 1e-4
# The 20-step residual rollout with state feedback, against JAX: each step
# feeds the state back into the node features, so rounding differences
# carry from step to step. Held to 1e-4 of the state's largest element (the
# JAX engine's own scan-vs-chained check is 1e-5 absolute, within JAX).
# Measured on the CPU: 3.3e-7 after one step, 1.9e-6 at step 20, where
# the largest element is 9.8 (1.9e-7 of it).
STATE_RTOL = 1e-4
COUNTERS = ("rollout_steps_total", "rollouts_completed_total",
            "rollouts_aborted_total", "rollouts_timed_out_total",
            "rollouts_rejected_total")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors through many small ops: a pool of intra-op threads only
    slows them when test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.reset()
    JFAULTS.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield
    FAULTS.reset()
    JFAULTS.reset()


@functools.lru_cache(maxsize=None)
def _weights(state_feats: bool):
    """The JAX init for the reduced config (28 node inputs with state
    feedback), made once per width."""
    jcfg = JaxGNNConfig().reduced().replace(
        levels=LEVELS, rollout_state_feats=state_feats)
    return jax.tree_util.tree_map(
        np.asarray, jmgn.init(jax.random.PRNGKey(0), jcfg))


def _cfgs(**kw):
    return (JaxGNNConfig().reduced().replace(levels=LEVELS, **kw),
            GNNConfig().reduced().replace(levels=LEVELS, **kw))


def _port(buckets=(128,), server_kw=None, **cfg_kw):
    """A port server of ``cfg_kw``; its model is built with the base config
    (only the width follows ``rollout_state_feats``): the server's config,
    not the model's, decides the integrator, as in JAX."""
    _, cfg = _cfgs(**cfg_kw)
    model = params_from_jax(
        _weights(cfg.rollout_state_feats),
        _cfgs(rollout_state_feats=cfg.rollout_state_feats)[1], device="cpu")
    return GNNServer(cfg, buckets, params=model, max_batch=2, seed=0,
                     device="cpu", **(server_kw or {}))


def _jax(buckets=(128,), server_kw=None, **cfg_kw):
    jcfg, _ = _cfgs(**cfg_kw)
    return JaxGNNServer(jcfg, buckets,
                        params=_weights(jcfg.rollout_state_feats),
                        max_batch=2, seed=0, **(server_kw or {}))


def _car(i=0):
    return geo.car_surface(geo.sample_params(i))


def _cloud(n, seed=0):
    verts, faces = _car(seed)
    return sample_surface(verts, faces, n, np.random.default_rng(seed))


def _bit_equal(got, want):
    assert got.error is None and want.error is None, (got.error, want.error)
    assert got.steps_done == want.steps_done
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.fields, want.fields)


def _close_to_jax(got, want, atol=ATOL):
    assert got.rollout_id == want.rollout_id
    assert got.bucket == want.bucket
    assert (got.steps, got.steps_done) == (want.steps, want.steps_done)
    assert got.error is None and want.error is None, (got.error, want.error)
    np.testing.assert_array_equal(got.points, np.asarray(want.points))
    np.testing.assert_allclose(got.fields, np.asarray(want.fields),
                               rtol=0, atol=atol)


def _counters(eng):
    """The five rollout counters, read by name from the server's registry."""
    m = eng.server.telemetry.metrics
    return tuple(m.counter(name).value for name in COUNTERS)


def _count_lane_steps(srv):
    """Count the model's forward calls: one per lane-step advanced."""
    model = srv.params
    calls = [0]
    apply = model.apply

    def counted(*a, **kw):
        calls[0] += 1
        return apply(*a, **kw)

    model.apply = counted
    return calls


# ---------------------------------------------------------------------------
# single shot, one rollout, and the slot table
# ---------------------------------------------------------------------------

def test_t1_rollout_is_bit_equal_to_serve():
    """The serving forward is featurize + one step from a zero state, and
    rollout ids share the request-id space: a fresh server's one-step
    rollout reproduces ``serve()`` bit for bit."""
    verts, faces = _car(0)
    [want] = _port().serve([(verts, faces, 128)])
    got = _port().rollout(verts, faces, 128, steps=1)
    assert got.rollout_id == want.request_id == 0
    assert got.steps_done == 1 and got.bucket == 128
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.fields, want.fields)


def test_default_config_three_steps_matches_jax():
    verts, faces = _car(2)
    jsrv, srv = _jax(), _port()
    lane_steps = _count_lane_steps(srv)
    want = jsrv.rollout(verts, faces, 128, steps=3)
    got = srv.rollout(verts, faces, 128, steps=3)
    _close_to_jax(got, want)
    eng = srv.rollout_engine()
    assert lane_steps[0] == eng._c_steps.value == 3
    assert _counters(eng) == _counters(jsrv.rollout_engine())


def test_slot_table_stays_on_the_device_in_the_jax_layout():
    """The table is created on the first insert as zeros of the prefilled
    graph's shapes and dtypes, one leading slot axis, senders/receivers
    int32 as in JAX; its bytes are what the shapes give."""
    slots = 3
    srv = _port(rollout_slots=slots)
    jsrv = _jax(rollout_slots=slots)
    verts, faces = _car(0)
    eng, jeng = srv.rollout_engine(), jsrv.rollout_engine()
    eng.submit(verts, faces, 128, steps=2)
    jeng.submit(verts, faces, 128, steps=2)
    eng.generate()
    jeng.generate()
    t, jt = eng._tables[128], jeng._tables[128]
    cfg = srv.cfg
    n, e = 128, sum(2 * m * cfg.k_neighbors for m in (32, 64, 128))
    assert t.state.shape == (slots, n, cfg.node_out)
    assert t.state.device == srv.device
    want = {"node_feats": ((slots, n, cfg.node_in), torch.float32),
            "edge_feats": ((slots, e, cfg.edge_in), torch.float32),
            "senders": ((slots, e), torch.int32),
            "receivers": ((slots, e), torch.int32),
            "emask": ((slots, e), torch.bool)}
    assert {k: (tuple(v.shape), v.dtype) for k, v in t.graph.items()} == want
    for k, v in t.graph.items():
        assert tuple(v.shape) == tuple(jt.graph[k].shape), k
        assert str(v.dtype).split(".")[-1] == str(jt.graph[k].dtype), k
        # the free lanes are zeros, as in JAX
        assert not v[1:].any()
    per_slot = 4 * (n * cfg.node_in + e * cfg.edge_in + 2 * e
                    + n * cfg.node_out) + e
    assert eng.table_bytes() == {128: slots * per_slot}
    np.testing.assert_array_equal(t.rem, jt.rem)


# ---------------------------------------------------------------------------
# state dynamics: flushes, chaining, interleaving
# ---------------------------------------------------------------------------

def test_residual_state_feedback_twenty_steps_matches_jax():
    """Residual integration with the state fed back into the node features,
    20 steps in flushes of 4, against the JAX engine: every step depends on
    the last."""
    kw = dict(rollout_state_feats=True, rollout_integrator="residual",
              rollout_steps_per_flush=4)
    verts, faces = _car(0)
    jsrv, srv = _jax(**kw), _port(**kw)
    want = jsrv.rollout(verts, faces, 128, steps=20)
    got = srv.rollout(verts, faces, 128, steps=20)
    scale = float(np.abs(np.asarray(want.fields)).max())
    assert scale > 1e-3                 # the state evolves
    _close_to_jax(got, want, atol=STATE_RTOL * scale)
    assert _counters(srv.rollout_engine()) == \
        _counters(jsrv.rollout_engine())


def test_partial_flush_tail_is_bit_equal_to_chained_steps():
    """T = 5 in flushes of 4: the second flush advances one step, and the
    rollout equals five one-step rollouts chained through ``init_state`` on
    the same cloud, bit for bit."""
    kw = dict(rollout_state_feats=True, rollout_integrator="residual",
              rollout_steps_per_flush=4)
    srv = _port(**kw)
    verts, faces = _car(1)
    cloud = _cloud(128, seed=1)
    got = srv.rollout(verts, faces, 128, steps=5, cloud=cloud)
    assert got.error is None and got.steps_done == 5
    state = np.zeros((128, srv.cfg.node_out), np.float32)
    for _ in range(5):
        res = srv.rollout(verts, faces, 128, steps=1, cloud=cloud,
                          init_state=state)
        assert res.error is None
        state = res.fields
    np.testing.assert_array_equal(got.fields, state)
    assert not np.array_equal(state, srv.rollout(
        verts, faces, 128, steps=1, cloud=cloud).fields)


def _interleave(srv, lengths, clouds):
    """Two rollouts, one flush, then a mid-flight arrival; all to the end."""
    verts, faces = _car(0)
    eng = srv.rollout_engine()
    rids = [eng.submit(verts, faces, 128, steps=T, cloud=c)
            for T, c in zip(lengths[:2], clouds[:2])]
    eng.generate()
    rids.append(eng.submit(verts, faces, 128, steps=lengths[2],
                           cloud=clouds[2]))
    flushes = 1 + eng.run_until_complete()
    return [eng.result(rid) for rid in rids], flushes


def test_interleaved_rollouts_match_solo_and_jax():
    """Rollouts of 5, 12 and 20 steps sharing one slot table, the third
    arriving mid-flight: each bit-equal to its solo run in the port, and
    within ATOL of the JAX engine's interleaved run. Frozen lanes run no
    step: the model's calls equal the steps advanced."""
    kw = dict(rollout_integrator="residual")
    lengths = [5, 12, 20]
    clouds = [_cloud(128, seed=i) for i in range(3)]
    verts, faces = _car(0)
    solo = [_port(**kw).rollout(verts, faces, 128, steps=T, cloud=c)
            for T, c in zip(lengths, clouds)]
    srv = _port(**kw)
    lane_steps = _count_lane_steps(srv)
    got, flushes = _interleave(srv, lengths, clouds)
    want, jflushes = _interleave(_jax(**kw), lengths, clouds)
    assert flushes == jflushes == 6     # ceil((1 + 20) / 4): the third waits a flush
    for g, s, w in zip(got, solo, want):
        _bit_equal(g, s)
        _close_to_jax(g, w)
    eng = srv.rollout_engine()
    assert eng._c_done.value == 3
    assert lane_steps[0] == eng._c_steps.value == sum(lengths)


def test_rollouts_across_buckets_match_jax():
    """Rollouts route through the bucket ladder like single-shot requests:
    one slot table per bucket."""
    jsrv, srv = _jax((128, 256)), _port((128, 256))
    verts, faces = _car(0)
    for n_points, bucket in ((100, 128), (200, 256)):
        want = jsrv.rollout(verts, faces, n_points, steps=3)
        got = srv.rollout(verts, faces, n_points, steps=3)
        assert got.bucket == bucket
        assert got.fields.shape == (bucket, srv.cfg.node_out)
        _close_to_jax(got, want)
    assert sorted(srv.rollout_engine()._tables) == [128, 256]


# ---------------------------------------------------------------------------
# chaos: both packages armed the same way, the same outcome
# ---------------------------------------------------------------------------

class _Clock:
    """A perf_counter the test advances: deadlines expire at the same
    flush in both packages."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t


def _prefill_fault(eng, arm, clock):
    arm("rollout.prefill", nth=1, times=1)
    verts, faces = _car(0)
    rids = [eng.submit(verts, faces, 128, steps=3) for _ in range(2)]
    out = [eng.result(r) for r in rids]
    return out + [eng.server.rollout(verts, faces, 128, steps=2)]


def _generate_fault(eng, arm, clock):
    arm("rollout.generate", nth=1, times=1)
    verts, faces = _car(0)
    rids = [eng.submit(verts, faces, 128, steps=4),      # table 128: fails
            eng.submit(verts, faces, 200, steps=4)]      # table 256: clean
    out = [eng.result(r) for r in rids]
    return out + [eng.server.rollout(verts, faces, 128, steps=2)]


def _nan_insert(eng, arm, clock):
    arm("rollout.insert", mode="corrupt", nth=1, times=1)
    verts, faces = _car(0)
    rids = [eng.submit(verts, faces, 128, steps=6) for _ in range(2)]
    return [eng.result(r) for r in rids]


def _harvest_corrupt(eng, arm, clock):
    arm("rollout.harvest", mode="corrupt", nth=1, times=1)
    verts, faces = _car(0)
    return [eng.server.rollout(verts, faces, 128, steps=2),
            eng.server.rollout(verts, faces, 128, steps=2)]


def _deadline_queued(eng, arm, clock):
    verts, faces = _car(0)
    rid = eng.submit(verts, faces, 128, steps=100, timeout_s=0.5)
    clock.t += 1.0
    return [eng.result(rid)]


def _deadline_mid_flight(eng, arm, clock):
    verts, faces = _car(0)
    slow = eng.submit(verts, faces, 128, steps=50, timeout_s=3.5)
    ok = eng.submit(verts, faces, 128, steps=2)
    while eng.pending():
        eng.generate()
        clock.t += 1.0
    return [eng.result(slow), eng.result(ok)]


def _admission_reject(eng, arm, clock):
    verts, faces = _car(0)
    r1 = eng.submit(verts, faces, 128, steps=2)
    r2 = eng.submit(verts, faces, 128, steps=2)      # over the bound: shed
    return [eng.result(r2, drive=False), eng.result(r1)]


CHAOS = {
    "prefill_fault": (_prefill_fault, {}, {}),
    "generate_fault": (_generate_fault, {}, {}),
    "nan_insert": (_nan_insert, {"rollout_integrator": "residual"}, {}),
    "harvest_corrupt": (_harvest_corrupt, {}, {}),
    "deadline_queued": (_deadline_queued, {}, {}),
    "deadline_mid_flight": (_deadline_mid_flight,
                            {"rollout_steps_per_flush": 1}, {}),
    "admission_reject": (_admission_reject, {}, {"max_queue_depth": 1}),
}


def _outcome(results):
    return [(r.rollout_id, r.error, r.steps_done, r.bucket) for r in results]


@pytest.mark.parametrize("case", sorted(CHAOS))
def test_chaos_outcome_matches_jax(case, monkeypatch):
    drive, cfg_kw, server_kw = CHAOS[case]
    buckets = (128, 256) if case == "generate_fault" else (128,)
    outcomes, counters = [], []
    for module, make, faults in ((jrollout, _jax, JFAULTS),
                                 (prollout, _port, FAULTS)):
        srv = make(buckets, server_kw, **cfg_kw)
        clock = _Clock()
        monkeypatch.setattr(module, "time", clock)
        eng = srv.rollout_engine()
        results = drive(eng, faults.arm, clock)
        faults.reset()
        outcomes.append(_outcome(results))
        counters.append(_counters(eng))
        for r in results:
            if r.error is None:
                assert np.isfinite(r.fields).all()
    assert outcomes[1] == outcomes[0]
    assert counters[1] == counters[0]
    assert any(err for _, err, _, _ in outcomes[1])


# ---------------------------------------------------------------------------
# telemetry and the command line
# ---------------------------------------------------------------------------

def test_rollout_stages_spans_and_gauge():
    srv = _port(telemetry=True)
    verts, faces = _car(0)
    res = srv.rollout(verts, faces, 128, steps=3)
    assert res.error is None
    rep = srv.stats.report()
    for stage in ROLLOUT_STAGES:
        assert rep["stages"][stage]["count"] >= 1, stage
    spans = {(r.name, r.trace_id) for r in srv.telemetry.tracer.records()}
    for name in ("rollout_submit", "rollout_prefill", "rollout_insert",
                 "rollout"):
        assert (name, "roll-0") in spans, name
    assert any(name == "rollout_generate" for name, _ in spans)
    m = srv.telemetry.metrics
    assert m.counter("rollouts_completed_total").value == 1
    assert m.gauge("rollout_active_slots").value == 0


def test_serve_gnn_main_rollout_mode(capsys):
    serve_gnn.main(["--reduced", "--buckets", "128", "--device", "cpu",
                    "--requests", "2", "--rollout-steps", "3",
                    "--rollout-slots", "2", "--integrator", "residual"])
    out = capsys.readouterr().out
    assert "rolled out 2 geometries x 3 steps (6 total) on cpu" in out
    assert "| 0 errors" in out
    assert "rollout 1: bucket 128, steps 3/3" in out
