"""Run by ``tests/test_torch_dryrun.py`` in a process of its own (the fake
process group of the dry run is process-wide): the port's dry-run machinery
on a fake (4, 2) mesh of 8 ranks on the CPU. Prints one JSON object on its
last line."""
import json
import sys

import torch


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
