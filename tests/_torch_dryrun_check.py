"""Run by ``tests/test_torch_dryrun.py`` in a process of its own (the fake
process group of the dry run is process-wide): the port's dry-run machinery
on a fake (4, 2) mesh of 8 ranks on the CPU. With an argument instead,
the reduced configs whose full-size pairs eager DTensor could not run
before the dry run's rules, on that mesh: ``moe`` (run by
``tests/test_torch_dryrun_rules.py``) the MoE dispatch's and whisper's
uneven heads, with the rules on real values; ``xlstm``
(``tests/test_torch_dryrun_xlstm.py``) the xLSTM gates. Prints one JSON
object on its last line."""
import json
import sys

import torch


def check_record(rec):
    """A repaired pair's record (``tests/test_torch_dryrun_rules.py``,
    ``test_torch_dryrun_xlstm.py``): no error, FLOPs, memory and
    roofline."""
    assert "error" not in rec, rec.get("error")
    assert rec["per_device"]["hlo_raw"]["flops"] > 0
    assert rec["per_device"]["flops"] > 0
    assert rec["memory"]["temp_bytes"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    assert rec["mesh"] == "4x2"


def collective_loop(mesh, trips: int) -> dict:
    """A ``trips``-trip loop of a product whose contraction dim is sharded
    on 'model': each trip all-reduces its (8, 128) result."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding as shd
    counter = dryrun.StepCounter()
    with dryrun.fake_dtensor_fixes(), FakeTensorMode(), \
            implicit_replication():
        h = dryrun.fake_dtensor((8, 128), torch.float32,
                                shd.Spec(None, "model"), mesh, "cpu")
        w = [dryrun.fake_dtensor((128, 128), torch.float32,
                                 shd.Spec("model", None), mesh, "cpu")
             for _ in range(trips)]
        with counter:
            for wi in w:
                h = (h @ wi).redistribute(h.device_mesh, h.placements)
    return dryrun.collective_bytes(counter)


def rules_on_values() -> dict:
    """The dry run's rules on real values, each against the op it replaces
    on plain tensors (bit-equal): on a (1, 1) mesh, where a device holds
    every row, the MoE layer (routing, the dispatch's slots and the
    output), ``logsigmoid`` with its gradient, ``searchsorted`` and the
    trash-slot ``scatter_``; on the (4, 2) mesh, rank 0's rows of a
    row-local rule (:func:`dryrun.shardwise`); and ``laid_out`` of a shard
    laid out against its global strides."""
    import dataclasses
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.nn import functional as F
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe

    out = {}
    one = DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.int64),
                     mesh_dim_names=("data", "model"))
    gen = torch.Generator().manual_seed(0)
    mcfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced().moe,
                               n_experts=8, top_k=2)
    layer = moe.MoE(64, mcfg, generator=gen)
    # ties in the router's probabilities: the stable sort's order decides
    x = torch.randn((4, 24, 64), generator=gen).round(decimals=1)
    x[:, 12:] = x[:, :12]
    cap = moe.capacity(mcfg, x.shape[1])

    def split(t):
        return DTensor.from_local(t, one, [Shard(0), Replicate()],
                                  run_check=False)
    with torch.no_grad():
        w, idx, aux = moe.route(layer, x, mcfg)
        want = moe._dispatch_indices(idx, mcfg.n_experts, cap, w)
        y_want, aux_want = moe.apply(layer, x)
        with implicit_replication(), dryrun.DTensorRules(), \
                dryrun.DTensorViewRules():
            wd, idxd, auxd = moe.route(layer, split(x), mcfg)
            got = moe._dispatch_indices(idxd, mcfg.n_experts, cap, wd)
            y_got, aux_got = moe.apply(layer, split(x))
    out["moe_route"] = bool(torch.equal(idxd.to_local(), idx)
                            and torch.equal(wd.to_local(), w))
    out["moe_dispatch"] = [bool(torch.equal(
        g.full_tensor() if isinstance(g, DTensor) else g, h))
        for g, h in zip(got, want)]
    out["moe_apply"] = bool(torch.equal(y_got.full_tensor(), y_want)
                            and torch.equal(aux_got.full_tensor(), aux_want))

    z = torch.randn((4, 8, 6), generator=gen) * 30
    zd = split(z.clone()).requires_grad_()
    zp = z.clone().requires_grad_()
    with implicit_replication(), dryrun.DTensorRules():
        ld = F.logsigmoid(zd)
        (ld * ld).sum().backward()
    lp = F.logsigmoid(zp)
    (lp * lp).sum().backward()
    out["logsigmoid"] = bool(torch.equal(ld.full_tensor(), lp))
    out["logsigmoid_grad"] = bool(torch.equal(zd.grad.full_tensor(),
                                              zp.grad))

    seq = torch.sort(torch.randint(0, 9, (4, 30), generator=gen)).values
    vals = torch.arange(9).expand(4, -1).contiguous()
    index = torch.randint(0, 11, (4, 30), generator=gen)
    src = torch.randn((4, 30), generator=gen)
    with implicit_replication(), dryrun.DTensorRules():
        out["searchsorted"] = [bool(torch.equal(torch.searchsorted(
            split(seq), vals, side=side).full_tensor(),
            torch.searchsorted(seq, vals, side=side)))
            for side in ("left", "right")]
        buf = torch.zeros((4, 11))
        ret = buf.scatter_(1, split(index), split(src))
    out["scatter_"] = bool(ret is buf and torch.equal(
        buf, torch.zeros((4, 11)).scatter_(1, index, src)))

    # rank 0 of the (4, 2) mesh holds rows 0-1 of 8
    mesh = make_host_mesh(n_data=4, n_model=2)
    seq8 = torch.sort(torch.randint(0, 9, (8, 30), generator=gen)).values
    vals8 = torch.arange(9).expand(8, -1).contiguous()
    seqd = DTensor.from_local(seq8[:2], mesh, [Shard(0), Replicate()],
                              run_check=False, shape=seq8.shape,
                              stride=seq8.stride())
    with implicit_replication(), dryrun.DTensorRules():
        rows = torch.searchsorted(seqd, vals8)
    out["rank0_rows"] = bool(torch.equal(
        rows.to_local(), torch.searchsorted(seq8, vals8)[:2])
        and rows.shape == (8, 9))

    t = torch.randn((2, 3, 5), generator=gen)
    swapped = t.transpose(1, 2).contiguous().transpose(1, 2)
    td = DTensor.from_local(swapped, one, [Replicate(), Replicate()],
                            run_check=False, shape=t.shape, stride=t.stride())
    fixed = dryrun.laid_out(td)
    out["laid_out"] = bool(torch.equal(fixed.to_local(), t)
                           and fixed.to_local().is_contiguous()
                           and dryrun.laid_out(fixed) is fixed)
    return out


def repaired(mesh, which: str) -> dict:
    """``moe``: the reduced qwen3-moe and deepseek-moe at a train, prefill
    and decode step on the (4, 2) mesh, and the smallest whisper prefill
    that showed the full size's "Cannot flatten unevenly sharded tensor":
    5 heads of 64 (weights of 2**16 elements or more, which the rules
    shard) over the 2 'model' shards. ``xlstm``: the reduced xlstm's three
    steps."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    recs = {}
    archs = ("xlstm-350m",) if which == "xlstm" else \
        ("qwen3-moe-30b-a3b", "deepseek-moe-16b")
    for arch in archs:
        cfg = get_config(arch).reduced()
        # the xLSTM's sLSTM steps one token at a time: 8 tokens
        seq = 8 if arch == "xlstm-350m" else 32
        for kind in ("train", "prefill", "decode"):
            # qwen3-moe's 4 microbatches: 2 rows a device each
            batch = 32 if kind == "train" and arch.startswith("qwen3") \
                else 8
            shape = ShapeConfig(f"smoke_{kind}", seq_len=seq,
                                global_batch=batch, kind=kind)
            recs[f"{arch} {kind}"] = dryrun.run_pair(
                arch, shape, False, "cpu", cfg=cfg, mesh=mesh)
    if which == "xlstm":
        return recs
    cfg = get_config("whisper-large-v3").reduced().replace(
        n_heads=5, n_kv_heads=5, head_dim=64, d_model=320)
    shape = ShapeConfig("smoke_prefill", seq_len=32, global_batch=8,
                        kind="prefill")
    recs["whisper-large-v3 prefill"] = dryrun.run_pair(
        "whisper-large-v3", shape, False, "cpu", cfg=cfg, mesh=mesh)
    return recs


def main():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import GNNConfig, ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    torch.set_num_threads(1)
    out = {"world": dryrun.init_fake_world(8)}
    mesh = make_host_mesh(n_data=4, n_model=2)
    out["mesh"] = shd.mesh_shape(mesh).shape
    if sys.argv[1:] in (["moe"], ["xlstm"]):
        if sys.argv[1] == "moe":
            out["rules"] = rules_on_values()
        out["repaired"] = repaired(mesh, sys.argv[1])
        print(json.dumps(out, default=str))
        sys.stdout.flush()
        return
    try:
        make_production_mesh(device_type="cpu")
    except RuntimeError as e:
        out["production_mesh_error"] = str(e)
    out["loop"] = {t: collective_loop(mesh, t) for t in (1, 5)}

    cfg = get_config("granite-3-8b").reduced().replace(
        n_layers=2, param_sharding="tp")
    recs = {}
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig(f"smoke_{kind}", seq_len=32, global_batch=8,
                            kind=kind)
        recs[kind] = dryrun.run_pair("granite-3-8b", shape, False, "cpu",
                                     cfg=cfg, mesh=mesh)
    out["granite"] = recs
    # a reduced config with 'fsdp_tp' and grad_accum 2: microbatches
    shape = ShapeConfig("smoke_accum", seq_len=32, global_batch=8,
                        kind="train")
    out["accum"] = dryrun.run_pair(
        "granite-3-8b", shape, False, "cpu",
        cfg=cfg.replace(param_sharding="fsdp_tp", grad_accum=2), mesh=mesh)
    out["xmgn"] = dryrun.run_xmgn(False, "cpu", cfg=GNNConfig().reduced(),
                                  mesh=mesh)
    print(json.dumps(out, default=str))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
