"""Shared by the port's GNN training tests against the JAX package, which
are split over files so that ``--dist loadfile`` spreads them over the
workers: ``test_torch_train.py`` (partition loss and gradients, remat,
Adam, conversion, nonfinite steps, predict and eval),
``test_torch_train_trajectory.py`` (5 steps), ``test_torch_train_gnn.py``
and ``test_torch_train_gnn_reduced.py`` (``train_gnn`` at two sizes); and
by the checkpoint tests, ``test_torch_train_resume.py``,
``test_torch_train_cli.py`` and ``test_torch_serve_ckpt.py``.

Training size: ``GNNConfig().reduced()`` with hidden 32, 2 message-passing
layers, halo 2, levels (64, 128, 256), 4 partitions. Everything runs in
f32; the host data pipeline is the same numpy code in both packages, so its
arrays are bit-equal. Checkpoint size: ``tests/test_train_resume.py``'s
(hidden 16, 2 layers, levels (32, 64), 2 partitions).
"""
import jax
import numpy as np

from repro.configs.base import GNNConfig as JaxGNNConfig
from repro.data import pipeline as jpipe
from repro.launch import train as jtrain
from repro.models import meshgraphnet as jmgn
from repro_torch.configs.base import GNNConfig
from repro_torch.data import pipeline as pipe
from repro_torch.launch import train as ptrain
from repro_torch.models.convert import params_from_jax
from repro_torch.telemetry import Telemetry

# Loss and gradients of one sample, summed over its partitions: f32 on both
# sides, matmuls and reductions summed in other orders.
GRAD_TOL = 1e-5
# predict_gnn / eval_gnn: denormalized fields, as the JAX package's own
# eval parity test (1e-4).
EVAL_TOL = 1e-4
# Remat on against off: the forward values are recomputed bit for bit, but
# autograd adds the gradient contributions into each layer's node carry
# (gathers by sender and receiver, the node MLP, the residual) in another
# order when the layer is checkpointed: 7.5e-9 (one f32 ulp of 0.05) seen.
REMAT_TOL = 1e-6
SIZE = dict(levels=(64, 128, 256), hidden=32, n_mp_layers=2, halo=2,
            n_partitions=4)
# Losses of a trajectory or a ``train_gnn`` run, relative (f32 on both
# sides).
LOSS_RTOL = 1e-5


def _cfgs(**kw):
    return (JaxGNNConfig().reduced().replace(**SIZE, **kw),
            GNNConfig().reduced().replace(**SIZE, **kw))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, atol, rtol=0.0, what=""):
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=what)


def build_data():
    """Both packages' datasets and partitioned samples, 3 samples."""
    jcfg, cfg = _cfgs()
    jd = jpipe.build_dataset(jcfg, 3)
    pd = pipe.build_dataset(cfg, 3)
    jps = jpipe.partition_samples(jcfg, jd[0], jd[2], jd[3])
    pps = pipe.partition_samples(cfg, pd[0], pd[2], pd[3])
    params = _np(jmgn.init(jax.random.PRNGKey(0), jcfg))
    return dict(jcfg=jcfg, cfg=cfg, jd=jd, pd=pd, jps=jps, pps=pps,
                params=params)


def _model(data, **kw):
    cfg = data["cfg"].replace(**kw)
    return params_from_jax(data["params"], cfg, device="cpu")


def _torch_batch(ps):
    return ptrain.prepare_gnn_batch(ps, "cpu")


def check_train_gnn_losses(monkeypatch, size, noise_std, data=None):
    """train_gnn for 3 steps against the JAX train_gnn, from the JAX init
    (the port draws its own weights from a torch.Generator, so init is
    replaced by the converted JAX params), with and without training noise,
    at the training size (``size='small'``, from ``data``) and at
    ``GNNConfig().reduced()`` (hidden 64, 3 layers, levels (128, 256,
    512))."""
    if size == "small":
        jcfg, cfg, params = data["jcfg"], data["cfg"], data["params"]
    else:
        jcfg, cfg = JaxGNNConfig().reduced(), GNNConfig().reduced()
        params = _np(jmgn.init(jax.random.PRNGKey(0), jcfg))
    monkeypatch.setattr(
        ptrain.meshgraphnet, "init",
        lambda gen, c, device=None: params_from_jax(params, c, device))
    _, want, _ = jtrain.train_gnn(jcfg, steps=3, n_samples=3,
                                  log_every=100, shard_devices=1,
                                  noise_std=noise_std)
    tel = Telemetry(enabled=True)
    _, got, _ = ptrain.train_gnn(cfg, steps=3, n_samples=3, log_every=100,
                                 noise_std=noise_std, device="cpu",
                                 telemetry=tel)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    hist = tel.metrics.histogram
    assert hist("train_stage_step_seconds").count == 3
    assert hist("train_stage_data_seconds").sum > 0
    assert [r.attrs["it"] for r in tel.tracer.records()
            if r.name == "step"] == [0, 1, 2]


# ------------------------------------------------------------- checkpoints

RESUME_SIZE = dict(levels=(32, 64), n_partitions=2, hidden=16,
                   n_mp_layers=2, halo=2)
SERVE_TOL = 1e-4


def resume_cfg():
    return GNNConfig().reduced().replace(**RESUME_SIZE)


def resume_jcfg():
    return JaxGNNConfig().reduced().replace(**RESUME_SIZE)
