"""The port stands alone: importing all of ``repro_torch`` loads neither JAX
nor the JAX package, nor ``msgpack`` or ``ml_dtypes`` (the card's machine
has neither), and no source line imports them."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack",
                                    "ml_dtypes"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_import_loads_no_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    res = json.loads(out.strip().splitlines()[-1])
    assert res["bad"] == []
    assert "repro_torch.launch.serve_gnn" in res["modules"]
    assert "repro_torch.kernels._build" in res["modules"]
    assert "repro_torch.launch.serve" in res["modules"]
    assert "repro_torch.kernels.flash_attention.ops" in res["modules"]
    for name in ("launch.train", "launch.rollout", "optim.adam", "data.pipeline", "core.halo",
                 "core.partitioning", "core.gradient_aggregation",
                 "core.distributed_mgn", "launch.sharding",
                 "ckpt.checkpoint", "ckpt._msgpack", "resilience.faults",
                 "telemetry.metrics", "telemetry.trace",
                 "telemetry.profiler", "ckpt.artifact", "ckpt.compile_cache",
                 "models.xunet3d", "core.unet_halo", "launch.xunet_volume",
                 "models.moe", "configs.qwen3_moe_30b_a3b",
                 "configs.deepseek_moe_16b", "configs.pixtral_12b",
                 "configs.granite_3_8b", "configs.starcoder2_15b",
                 "configs.yi_34b", "models.whisper", "models.ssm",
                 "models.stacks", "configs.whisper_large_v3",
                 "configs.xlstm_350m", "data.tokens",
                 "configs.zamba2_2_7b", "launch.costmodel", "launch.mesh",
                 "launch.dryrun", "launch.report", "graphx.hashgrid",
                 "core.graph_build"):
        assert f"repro_torch.{name}" in res["modules"]


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\.|from\s+repro\."
    r"|from\s+repro\s+import|import\s+repro\s*$"
    r"|import\s+(msgpack|ml_dtypes)\b|from\s+(msgpack|ml_dtypes)\b)",
    re.MULTILINE)


def test_sources_import_no_jax_or_repro():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 10
    hits = [f"{f.relative_to(SRC)}: {m.group(0).strip()}"
            for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert hits == []
