"""A run with the timed path broken underneath comes out not correct, and
the controls read over the limits while the program reads under them: each
cell at a size a test run holds, on the CPU, with its limits as committed.

The faults are planted in the program: an answer altered where it is
produced; half of a batch left out, the mean of the rest in its place; in
training, a step that leaves the state unchanged. The controls put the
reference in the program's place, in TF32 (on the CPU its inputs rounded
to TF32), and for training also on half the nodes."""
import pytest
import torch

from perfbench import controls, harness


def run(cell, small, seconds=0.3):
    return harness.run_cell(cell, 2 ** 31 + 5, seconds, False, device="cpu",
                            overrides=small[cell])


def failed_checks(out):
    return [n for n, c in out["checks"].items() if c["value"] > c["limit"]]


def altered_answer(monkeypatch, cls):
    orig = cls.apply

    def apply(self, *a, **kw):
        out = orig(self, *a, **kw).contiguous().clone()
        out.view(-1)[0] += 0.05 * float(out.abs().max())
        return out
    monkeypatch.setattr(cls, "apply", apply)


def test_serving_with_an_altered_answer_is_not_correct(small, monkeypatch):
    from repro_torch.models.meshgraphnet import MeshGraphNet
    altered_answer(monkeypatch, MeshGraphNet)
    out = run("xmgn-serve-65k", small)
    assert not out["correct"] and failed_checks(out) == ["fields_err"]


def test_serving_half_a_batch_is_not_correct(small, monkeypatch):
    from repro_torch.launch import serve_gnn
    orig = serve_gnn.make_batched_infer_fn

    def half(cfg, ms, **kw):
        batched = orig(cfg, ms, **kw)

        def infer(model, points, normals, n_valid):
            k = (points.shape[0] + 1) // 2
            out = batched(model, points[:k], normals[:k], n_valid[:k])
            rest = out.mean(0, keepdim=True).expand(
                points.shape[0] - k, *out.shape[1:])
            return torch.cat([out, rest])
        return infer
    monkeypatch.setattr(serve_gnn, "make_batched_infer_fn", half)
    out = run("xmgn-serve-8k", small, seconds=0.5)
    assert not out["correct"] and "fields_err" in failed_checks(out)


def test_training_that_leaves_its_state_unchanged_is_not_correct(
        small, monkeypatch):
    from repro_torch.launch import train
    orig = train.adam_update

    def frozen(cfg, grads, state, params):
        _, new_state, metrics = orig(cfg, grads, state, params)
        return [p.detach().clone() for p in params], new_state, metrics
    monkeypatch.setattr(train, "adam_update", frozen)
    out = run("xmgn-train-8part", small)
    assert not out["correct"] and "update_gap" in failed_checks(out)


def test_training_on_half_the_partitions_is_not_correct(small, monkeypatch):
    from repro_torch.launch import train
    orig = train.aggregate_gradients

    def half(loss_fn, model, batches):
        kept = list(batches)
        kept = kept[:max(1, len(kept) // 2)]
        return orig(lambda m, b: 2.0 * loss_fn(m, b), model, kept)
    monkeypatch.setattr(train, "aggregate_gradients", half)
    out = run("xmgn-train-8part", small)
    assert not out["correct"]
    assert {"loss_gap", "grad_gap"} <= set(failed_checks(out))


def test_training_with_an_altered_loss_is_not_correct(small, monkeypatch):
    from repro_torch.launch import train
    orig = train.loss_fn
    monkeypatch.setattr(train, "loss_fn",
                        lambda m, b, denom=None: 1.01 * orig(m, b, denom))
    out = run("xmgn-train-8part", small)
    assert not out["correct"] and "loss_gap" in failed_checks(out)


def test_a_volume_with_an_altered_answer_is_not_correct(small, monkeypatch):
    from repro_torch.models.xunet3d import XUNet3D
    altered_answer(monkeypatch, XUNet3D)
    out = run("xunet3d-pass", small)
    assert not out["correct"] and failed_checks(out) == ["fields_err"]


def test_a_volume_missing_half_its_slabs_is_not_correct(small, monkeypatch):
    from repro_torch.core import unet_halo
    orig = unet_halo.apply_partitioned

    def half(apply_fn, x, n_parts, halo, axis=1, align=1):
        out = orig(apply_fn, x, n_parts, halo, axis, align)
        cut = out.shape[axis] // 2
        out = out.clone()
        out[:, cut:] = out[:, :cut].mean()
        return out
    monkeypatch.setattr(unet_halo, "apply_partitioned", half)
    out = run("xunet3d-pass", small)
    assert not out["correct"] and failed_checks(out) == ["fields_err"]


@pytest.mark.parametrize("cell,kinds", [
    ("xmgn-serve-65k", ["tf32"]),
    ("xmgn-train-8part", ["tf32", "half_batch"]),
    ("xunet3d-pass", ["tf32"]),
])
def test_the_controls_fail_and_the_program_passes(small, cell, kinds):
    manifest = harness.load_manifest()
    limits = harness.cell_files(cell, manifest)[1]["check"]["limits"]
    for r in controls.readings(cell, [2 ** 31 + 9], 0.3, kinds,
                               device="cpu", overrides=small[cell]):
        over = [n for n, v in r["checks"].items() if v > limits[n]]
        if r["reading"] == "program":
            assert over == [], r
        else:
            assert over, r
