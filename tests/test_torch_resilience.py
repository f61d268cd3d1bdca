"""The port's fault injector (``repro_torch.resilience``) and the trainer
under injected faults, ported from ``tests/test_resilience.py`` (the
injector cases and the checkpoint/training cases; the serving cases wait
for the rest of the port's ``GNNServer``).

The injector is process-wide, so every test here starts and ends with it
reset. Training runs at ``tests/test_train_resume.py``'s size (hidden 16,
2 layers, levels (32, 64), 2 partitions) on the CPU.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.resilience import FAULTS as JAX_FAULTS
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import GNNConfig
from repro_torch.launch.train import train_gnn
from repro_torch.resilience import FAULTS, SITES, FaultError
from repro_torch.resilience import faults


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.reset()
    JAX_FAULTS.reset()
    yield
    FAULTS.reset()
    JAX_FAULTS.reset()


# ---------------------------------------------------------------------------
# fault injector
# ---------------------------------------------------------------------------

def test_sites_and_module_functions_match_jax():
    from repro.resilience import SITES as JAX_SITES
    assert SITES == JAX_SITES
    assert faults.fire == FAULTS.fire and faults.corrupt == FAULTS.corrupt


def test_fault_nth_times_window():
    FAULTS.arm("serve.dispatch", mode="raise", nth=2, times=2)
    FAULTS.fire("serve.dispatch")                     # hit 1: before window
    for _ in range(2):                                # hits 2, 3: fire
        with pytest.raises(FaultError, match="serve.dispatch"):
            FAULTS.fire("serve.dispatch")
    FAULTS.fire("serve.dispatch")                     # hit 4: past window
    assert FAULTS.hits("serve.dispatch") == 4
    assert FAULTS.fired("serve.dispatch") == 2


def test_fault_forever_and_unarmed_sites():
    FAULTS.arm("serve.worker", nth=1, times=-1)
    for _ in range(5):
        with pytest.raises(FaultError):
            FAULTS.fire("serve.worker")
    FAULTS.fire("serve.dispatch")                     # other sites untouched
    FAULTS.disarm("serve.worker")
    FAULTS.fire("serve.worker")
    assert not FAULTS.active()


def test_fault_custom_exception_and_delay():
    FAULTS.arm("serve.compile", exc=lambda site: MemoryError(site))
    with pytest.raises(MemoryError):
        FAULTS.fire("serve.compile")
    FAULTS.arm("serve.dispatch", mode="delay", delay_s=0.05, times=1)
    t0 = time.perf_counter()
    FAULTS.fire("serve.dispatch")
    assert time.perf_counter() - t0 >= 0.04


def test_fault_armed_context_manager():
    with FAULTS.armed("bucket.build"):
        assert FAULTS.active()
        with pytest.raises(FaultError):
            FAULTS.fire("bucket.build")
    assert not FAULTS.active()
    FAULTS.fire("bucket.build")


def test_corrupt_identity_when_not_firing():
    a = np.ones((4, 3), np.float32)
    assert FAULTS.corrupt("serve.harvest", a) is a    # unarmed: same object
    FAULTS.arm("serve.harvest", mode="corrupt", nth=2)
    assert FAULTS.corrupt("serve.harvest", a) is a    # hit 1: not yet
    out = FAULTS.corrupt("serve.harvest", a)          # hit 2: NaN copy
    assert out is not a
    assert np.isnan(out).all()
    assert np.isfinite(a).all()                       # input untouched


def test_corrupt_partial_mask_deterministic():
    a = np.zeros((64, 8), np.float32)
    masks = []
    for _ in range(2):
        FAULTS.arm("serve.harvest", mode="corrupt", frac=0.25, seed=3)
        masks.append(np.isnan(FAULTS.corrupt("serve.harvest", a)))
        FAULTS.reset()
    np.testing.assert_array_equal(masks[0], masks[1])  # bit-reproducible
    frac = masks[0].mean()
    assert 0.0 < frac < 1.0                            # genuinely partial


@pytest.mark.parametrize("seed,nth,frac", [(0, 1, 0.25), (3, 2, 0.5),
                                           (11, 3, 0.05)])
def test_corrupt_mask_equals_jax(seed, nth, frac):
    """The same armed spec corrupts the same entries, with the same fill,
    on the same hit, in both packages."""
    a = np.arange(96, dtype=np.float32).reshape(12, 8)
    outs = []
    for inj in (FAULTS, JAX_FAULTS):
        inj.arm("train.batch", mode="corrupt", nth=nth, frac=frac,
                seed=seed, fill=-7.0)
        hits = [inj.corrupt("train.batch", a) for _ in range(nth + 1)]
        assert [h is a for h in hits] == [True] * (nth - 1) + [False, True]
        outs.append(hits[nth - 1])
    np.testing.assert_array_equal(outs[0], outs[1])
    assert 0 < int((outs[0] == -7.0).sum()) < a.size


def test_fault_thread_safety_exact_fire_count():
    FAULTS.arm("ckpt.write", nth=10, times=3)
    errs = []

    def hammer():
        for _ in range(10):
            try:
                FAULTS.fire("ckpt.write")
            except FaultError:
                errs.append(1)

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert FAULTS.hits("ckpt.write") == 80
    assert len(errs) == 3 and FAULTS.fired("ckpt.write") == 3


def test_arm_rejects_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        FAULTS.arm("serve.dispatch", mode="explode")


# ---------------------------------------------------------------------------
# training: retention fallback on resume + nonfinite skip-step
# ---------------------------------------------------------------------------

def _tiny_cfg():
    return GNNConfig().reduced().replace(levels=(32, 64), n_partitions=2,
                                         hidden=16, n_mp_layers=2, halo=2)


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))


def test_train_resume_falls_back_past_corrupt_checkpoint(tmp_path, capsys):
    cfg = _tiny_cfg()
    p = str(tmp_path / "ck.msgpack")
    m_full, losses_full, _ = train_gnn(cfg, steps=4, n_samples=2,
                                       ckpt_path=p, ckpt_every=1,
                                       keep_ckpts=3, log_every=100,
                                       device="cpu")
    # periodic saves went to step-tagged siblings, window pruned to 3
    assert [s for s, _ in ckpt.retained_steps(p)] == [1, 2, 3]
    # corrupt the FINAL checkpoint (newest): resume must fall back to the
    # step-3 sibling and finish with the exact same params as the full run
    raw = open(p, "rb").read()
    with open(p, "wb") as f:
        f.write(raw[:len(raw) // 2])
    capsys.readouterr()
    m_res, losses_tail, _ = train_gnn(cfg, steps=4, n_samples=2, resume=p,
                                      log_every=100, device="cpu")
    out = capsys.readouterr().out
    assert "skipped corrupt checkpoint" in out and p in out
    assert "retained fallback" in out
    assert losses_tail == losses_full[3:]
    assert _same(m_full, m_res)


def test_train_skips_step_on_nonfinite_batch(capsys):
    FAULTS.arm("train.batch", mode="corrupt", nth=2, times=1)
    _, losses, _ = train_gnn(_tiny_cfg(), steps=3, n_samples=2,
                             log_every=100, device="cpu")
    out = capsys.readouterr().out
    assert len(losses) == 3
    assert np.isfinite(losses[0])
    assert not np.isfinite(losses[1])                 # the poisoned step
    assert np.isfinite(losses[2])                     # training recovered
    assert "SKIPPED: nonfinite" in out
    assert FAULTS.fired("train.batch") == 1


def test_skipped_step_leaves_params_and_adam_state_bit_equal(tmp_path):
    """A poisoned last step: the final parameters and the checkpointed
    Adam state are those of the run that stopped one step earlier, bit for
    bit (the optimizer's step count included)."""
    cfg = _tiny_cfg()
    before, after = str(tmp_path / "before"), str(tmp_path / "after")
    m_before, _, _ = train_gnn(cfg, steps=2, n_samples=2, ckpt_path=before,
                               opt_total_steps=3, log_every=100,
                               device="cpu")
    FAULTS.arm("train.batch", mode="corrupt", nth=3, times=1, frac=0.1,
               seed=1)
    m_after, losses, _ = train_gnn(cfg, steps=3, n_samples=2,
                                   ckpt_path=after, log_every=100,
                                   device="cpu")
    assert not np.isfinite(losses[2])
    assert _same(m_before, m_after)
    a, b = ckpt.restore(before)["opt"], ckpt.restore(after)["opt"]
    assert int(a["step"]) == int(b["step"]) == 2
    for k in ("mu", "nu"):
        for x, y in zip(torch.utils._pytree.tree_leaves(a[k]),
                        torch.utils._pytree.tree_leaves(b[k])):
            assert torch.equal(x, y)


def test_train_guard_is_bitwise_noop_when_finite():
    """nonfinite_guard on vs off: identical params on an all-finite run."""
    m_on, l_on, _ = train_gnn(_tiny_cfg(), steps=2, n_samples=2,
                              log_every=100, device="cpu")
    m_off, l_off, _ = train_gnn(
        _tiny_cfg().replace(nonfinite_guard=False), steps=2, n_samples=2,
        log_every=100, device="cpu")
    assert l_on == l_off
    assert _same(m_on, m_off)


def test_periodic_write_fault_surfaces_and_keeps_previous(tmp_path):
    """An armed ckpt.rename on the second periodic save: the run raises
    the fault when the writer is joined, and the first retained file is
    intact and resumable."""
    cfg = _tiny_cfg()
    p = str(tmp_path / "ck.msgpack")
    FAULTS.arm("ckpt.rename", nth=2, times=1)
    with pytest.raises(FaultError, match="ckpt.rename"):
        train_gnn(cfg, steps=4, n_samples=2, ckpt_path=p, ckpt_every=1,
                  keep_ckpts=2, log_every=100, device="cpu")
    FAULTS.reset()
    kept = [s for s, _ in ckpt.retained_steps(p)]
    assert 1 in kept and 2 not in kept
    assert sorted(f.name for f in tmp_path.iterdir()) == sorted(
        ckpt.retained_path("ck.msgpack", s) for s in kept)
    _, losses, _ = train_gnn(cfg, steps=2, n_samples=2, log_every=100,
                             resume=ckpt.retained_path(p, 1), device="cpu")
    assert len(losses) == 1 and np.isfinite(losses[0])
