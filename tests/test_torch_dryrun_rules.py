"""The dry run's rules for the ops eager ``DTensor`` cannot run as JAX's
GSPMD does (``repro_torch.launch.dryrun``: ``DTensorRules``,
``DTensorViewRules``). In a subprocess of its own (the fake process group
is process-wide; ``tests/_torch_dryrun_check.py moe``): each rule against
the op it replaces on real values, bit-equal, MoE routing and dispatch
included; and the reduced configs of full-size pairs that stopped on an op
without a rule (qwen3-moe and deepseek-moe: the dispatch's
``searchsorted`` and trash-slot scatter; whisper-large-v3: heads that do
not split evenly over 'model') take a train, prefill and decode step (a
prefill for whisper) on a fake (4, 2) mesh with no error
(``tests/test_torch_dryrun_xlstm.py``: the xLSTM's). In this process:
which mesh dims a view gathers."""
import json
import os
import subprocess
import sys

import pytest
from torch.distributed.tensor import Replicate, Shard

from _torch_dryrun_check import check_record
from repro_torch.launch import dryrun

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
TIMEOUT = 240


@pytest.fixture(scope="module")
def run():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_dryrun_check.py"),
         "moe"], capture_output=True, text=True, timeout=TIMEOUT, env=env)
    assert proc.returncode == 0, \
        f"STDOUT:\n{proc.stdout[-3000:]}\nSTDERR:\n{proc.stderr[-6000:]}"
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_moe_routing_and_dispatch_are_the_ops(run):
    """Routing through the rules: the same stable sort (ties in the input),
    the same slots and trash slot, the same layer output."""
    rules = run["rules"]
    assert rules["moe_route"] and rules["moe_apply"]
    assert rules["moe_dispatch"] == [True] * 4


@pytest.mark.parametrize("rule", ["logsigmoid", "logsigmoid_grad",
                                  "scatter_", "rank0_rows", "laid_out"])
def test_rule_is_bit_equal_to_the_op(run, rule):
    assert run["rules"][rule] is True


def test_searchsorted_both_sides(run):
    assert run["rules"]["searchsorted"] == [True, True]


REPAIRED = [f"{a} {k}" for a in ("qwen3-moe-30b-a3b", "deepseek-moe-16b")
            for k in ("train", "prefill", "decode")] + \
    ["whisper-large-v3 prefill"]


@pytest.mark.parametrize("pair", REPAIRED)
def test_repaired_pair_has_its_record(run, pair):
    check_record(run["repaired"][pair])


@pytest.mark.parametrize("size, new, placements, mesh, want", [
    # whisper-large-v3 prefill_32k: 20 heads over 16 'model' shards merged
    ((32, 1500, 20, 64), (32, 1500, 1280), (Shard(0), Shard(2)), (16, 16),
     {1}),
    # the reduced case: 320 columns split into 5 heads over 2 shards
    ((8, 16, 320), (8, 16, 5, 64), (Shard(0), Shard(2)), (4, 2), {1}),
    # qwen3-moe: a batch of 64 x 4 KV heads on 'data' and 'model', split
    ((256, 16384, 4096), (64, 4, 2048, 8, 4096, 1), (Shard(0), Shard(0)),
     (16, 16), {1}),
    # even splits, merges, the last dim of a merge and a kept uneven dim
    ((256, 16384, 4096), (256, 4, 4096, 4096), (Shard(0), Shard(0)),
     (16, 16), set()),
    ((32, 1500, 16, 64), (32, 1500, 1024), (Shard(0), Shard(2)), (16, 16),
     set()),
    ((32, 20, 64), (640, 64), (Replicate(), Shard(1)), (16, 16), set()),
    ((32, 20, 64), (32, 20, 8, 8), (Shard(0), Shard(1)), (16, 16), set()),
])
def test_view_gathers(size, new, placements, mesh, want):
    assert dryrun.view_gathers(size, new, placements, mesh) == want
