"""The port's ``train_gnn`` for 3 steps against JAX's at the training size
(``_torch_train_common.py``), with and without training noise (split from
``test_torch_train.py``; the ``GNNConfig().reduced()`` case is in
``test_torch_train_gnn_reduced.py``)."""
import pytest

from _torch_train_common import build_data, check_train_gnn_losses


@pytest.fixture(scope="module")
def data():
    return build_data()


@pytest.mark.parametrize("size,noise_std", [("small", 0.0), ("small", 0.1)])
def test_train_gnn_losses_match_jax(data, monkeypatch, size, noise_std):
    """train_gnn for 3 steps against the JAX train_gnn, from the JAX init
    (the port draws its own weights from a torch.Generator, so init is
    replaced by the converted JAX params), with and without training noise,
    at the training size."""
    check_train_gnn_losses(monkeypatch, size, noise_std, data)
