"""The port's dry run (``repro_torch.launch.dryrun``, ``launch.mesh``,
``launch.report``) on the CPU. The machinery runs in a subprocess of its
own with a time limit (``tests/_torch_dryrun_check.py``: its fake process
group is process-wide), as ``tests/test_distributed.py`` runs JAX's
``_dryrun_check.py``: on a fake (4, 2) mesh a 5-trip loop of a
'model'-sharded product gives 5 x the one-trip collective bytes; a reduced
granite-3-8b at 2 layers takes a train step of 8 x 32 with temporaries and
collectives, and a prefill and a decode step; the reduced xmgn-drivaer
takes its DDP step with one all-reduce. In this process: the step inputs,
skips and depth helpers against JAX's, and ``report.render`` of an ok, a
skipped and an error record."""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro import configs as jconfigs
from repro.launch import dryrun as jdryrun
from repro_torch import configs as pconfigs
from repro_torch.launch import dryrun, report

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
TIMEOUT = 240


@pytest.fixture(scope="module")
def run():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_dryrun_check.py")],
        capture_output=True, text=True, timeout=TIMEOUT, env=env)
    assert proc.returncode == 0, \
        f"STDOUT:\n{proc.stdout[-3000:]}\nSTDERR:\n{proc.stderr[-6000:]}"
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_fake_world_and_meshes(run):
    assert run["world"] == 8
    assert run["mesh"] == {"data": 4, "model": 2}
    assert run["production_mesh_error"].startswith(
        "need 256 devices, have 8")


def test_collective_bytes_scale_with_trips(run):
    """Eager PyTorch runs every trip: 5 trips, 5 x the bytes and count."""
    one, five = run["loop"]["1"], run["loop"]["5"]
    assert one["total"] >= 8 * 128 * 4 // 2 > 0
    assert five["total"] == 5 * one["total"]
    assert five["count"] == 5 * one["count"]
    assert set(one) == set(dryrun.COLLECTIVE_KINDS) | {"count", "total"}


def test_small_train_step_has_temporaries_and_collectives(run):
    rec = run["granite"]["train"]
    mem = rec["memory"]
    assert mem["temp_bytes"] > 0
    assert rec["per_device"]["collective_breakdown"]["count"] > 0
    assert rec["per_device"]["collective_bytes"] > 0
    assert mem["argument_bytes"] > 0 and mem["alias_bytes"] > 0
    assert rec["per_device"]["hlo_raw"]["flops"] > 0
    assert rec["param_sharding"] == "tp" and rec["mesh"] == "4x2"
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    assert rec["n_params"] == rec["n_active_params"] > 0


def test_records_name_their_torch_and_largest_collectives(run):
    """Eager DTensor's plan changes with torch's version, so each record
    names the torch that made it, and the largest collectives by the op
    that issued them add up to no more than the total."""
    rec = run["granite"]["train"]
    assert rec["torch"] == run["xmgn"]["torch"] == torch.__version__
    top = rec["per_device"]["collective_top"]
    assert 0 < len(top) <= 8
    assert [b for _, b, _ in top] == sorted((b for _, b, _ in top),
                                            reverse=True)
    assert sum(b for _, b, _ in top) <= rec["per_device"]["collective_bytes"]
    assert all(" at aten." in what and c > 0 for what, _, c in top)


def test_small_prefill_and_decode_steps(run):
    pre, dec = run["granite"]["prefill"], run["granite"]["decode"]
    assert pre["memory"]["temp_bytes"] > 0
    assert pre["memory"]["alias_bytes"] == 0
    # decode writes its cache in place: the cache is an output and an input
    assert dec["memory"]["alias_bytes"] > 0
    assert dec["per_device"]["hlo_raw"]["flops"] < \
        pre["per_device"]["hlo_raw"]["flops"]


def test_grad_accum_microbatches(run):
    rec = run["accum"]
    assert rec["param_sharding"] == "fsdp_tp"
    assert rec["memory"]["temp_bytes"] > 0
    assert rec["per_device"]["collective_breakdown"]["count"] > 0


def test_xmgn_one_all_reduce_a_step(run):
    rec = run["xmgn"]
    coll = rec["per_device"]["collective_breakdown"]
    assert coll["count"] == 1 and coll["all-reduce"] > 0
    assert coll["all-gather"] == coll["reduce-scatter"] == 0
    # loss + every gradient in f32
    assert coll["all-reduce"] == 4 * (1 + rec["n_params"])
    assert rec["memory"]["temp_bytes"] > 0
    assert rec["local"]["pad_edges"] == rec["local"]["pad_nodes"] * 8


@pytest.mark.parametrize("arch", pconfigs.ASSIGNED_ARCHS)
def test_inputs_skips_and_depth_match_jax(arch):
    p, j = pconfigs.get_config(arch), jconfigs.get_config(arch)
    for name, shape in pconfigs.SHAPES.items():
        got = dryrun.input_specs(p, shape)
        want = jdryrun.input_specs(j, jconfigs.SHAPES[name])
        assert sorted(got) == sorted(want)
        for k, (size, dt) in got.items():
            assert size == tuple(want[k].shape), (name, k)
            assert str(dt).split(".")[-1] == str(want[k].dtype), (name, k)
        assert dryrun.skip_reason(p, shape) == \
            jdryrun.skip_reason(j, jconfigs.SHAPES[name])
    assert dryrun.n_groups_of(p) == jdryrun.n_groups_of(j)
    for ng in (1, 2):
        assert dryrun.with_groups(p, ng).n_layers == \
            jdryrun.with_groups(j, ng).n_layers


def test_xmgn_local_shapes_are_jaxs():
    from repro_torch.configs.base import GNNConfig
    assert dryrun.xmgn_local_shapes(GNNConfig(), 256) == dict(
        n_nodes_global=2_000_000, n_owned=7812, pad_nodes=23_436,
        pad_edges=187_488)
    assert dryrun.xmgn_local_shapes(GNNConfig(), 512)["pad_edges"] == 93_744


def test_report_renders_ok_skipped_and_error(tmp_path, capsys):
    ok = {"arch": "a", "shape": "train_4k", "mesh": "16x16",
          "memory": {"argument_bytes": 2 ** 31, "output_bytes": 0,
                     "temp_bytes": 2 ** 30, "alias_bytes": 0},
          "roofline": {"t_compute_s": 1.5, "t_memory_s": 0.25,
                       "t_collective_s": 2e-3, "dominant": "compute"},
          "useful_flops_ratio": 0.5,
          "per_device": {"collective_bytes": 2 ** 30}}
    skipped = {"arch": "b", "shape": "long_500k", "mesh": "16x16",
               "skipped": "pure full-attention"}
    error = {"arch": "c", "shape": "decode_32k", "mesh": "16x16",
             "error": "NotImplementedError: no sharding strategy"}
    for i, rec in enumerate((ok, skipped, error)):
        (tmp_path / f"{i}.json").write_text(json.dumps(rec))
    assert len(report.rows_of(str(tmp_path))) == 3
    report.main(["--dirs", str(tmp_path), str(tmp_path / "none")])
    out = capsys.readouterr().out
    rows = [line for line in out.splitlines() if line.startswith("| ")]
    assert len(rows) == 4                      # the header and 3 records
    assert "| a | train_4k | 16x16 | 3.00GiB | 1.50e+00 | 2.50e-01 | " \
        "2.00e-03 | compute | 0.500 | 1.00 |" in out
    assert "| b | long_500k | 16x16 | — |" in out and "SKIP" in out
    assert "| c | decode_32k | 16x16 | ERROR: NotImplementedError" in out
    assert report.fmt_bytes(3 * 2 ** 20) == "3.0MiB"


def test_collective_kinds_are_counted_by_name():
    """The c10d and functional collectives map to JAX's kinds."""
    kinds = {dryrun._KIND[op._overloadpacket.__name__] for op in (
        torch.ops._c10d_functional.all_gather_into_tensor.default,
        torch.ops._c10d_functional.all_reduce.default,
        torch.ops._c10d_functional.reduce_scatter_tensor.default,
        torch.ops._c10d_functional.all_to_all_single.default,
        torch.ops.c10d.allreduce_.default)}
    assert kinds == {"all-gather", "all-reduce", "reduce-scatter",
                     "all-to-all"}


def _patch_targets():
    from torch.distributed.tensor import placement_types as pt
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    return (ShardingPropagator.__dict__["_propagate_tensor_meta_non_cached"],
            pt._StridedShard.__dict__["local_shard_size_and_offset"])


def test_fake_dtensor_fixes_patch_both_targets_and_restore():
    before = _patch_targets()
    with dryrun.fake_dtensor_fixes():
        during = _patch_targets()
    assert all(d is not b for d, b in zip(during, before))
    assert _patch_targets() == before


def test_fake_dtensor_fixes_raise_on_a_missing_target(monkeypatch):
    """Without a patch a device's counts would silently take the global
    shapes' ops: a torch without the method stops the dry run instead."""
    from torch.distributed.tensor import placement_types as pt
    monkeypatch.delattr(pt._StridedShard, "local_shard_size_and_offset")
    with pytest.raises(RuntimeError, match="local_shard_size_and_offset"):
        with dryrun.fake_dtensor_fixes():
            pass
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    fn = ShardingPropagator.__dict__["_propagate_tensor_meta_non_cached"]
    assert not hasattr(fn, "__wrapped__")
