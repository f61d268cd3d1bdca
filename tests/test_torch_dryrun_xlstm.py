"""The reduced xlstm-350m on the dry run's fake (4, 2) mesh: a train,
prefill and decode step with no error. Eager ``DTensor`` has no sharding
strategy for ``aten.log_sigmoid_forward`` (the mLSTM and sLSTM gates), so
every xlstm pair stopped there until ``launch.dryrun.DTensorRules`` ran it
on each device's shard. In a subprocess of its own
(``tests/_torch_dryrun_check.py xlstm``), apart from
``tests/test_torch_dryrun_rules.py`` so that the two spread over workers."""
import json
import os
import subprocess
import sys

import pytest

from _torch_dryrun_check import check_record

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
TIMEOUT = 240


@pytest.fixture(scope="module")
def run():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_dryrun_check.py"),
         "xlstm"], capture_output=True, text=True, timeout=TIMEOUT, env=env)
    assert proc.returncode == 0, \
        f"STDOUT:\n{proc.stdout[-3000:]}\nSTDERR:\n{proc.stderr[-6000:]}"
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_xlstm_pair_has_its_record(run, kind):
    check_record(run["repaired"][f"xlstm-350m {kind}"])
