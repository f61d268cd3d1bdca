"""The port's ``train_gnn`` for 3 steps against JAX's at
``GNNConfig().reduced()`` (hidden 64, 3 layers, levels (128, 256, 512);
split from ``test_torch_train.py``, the training size's cases are in
``test_torch_train_gnn.py``)."""
import pytest

from _torch_train_common import check_train_gnn_losses


@pytest.mark.parametrize("size,noise_std", [("reduced", 0.0)])
def test_train_gnn_losses_match_jax(monkeypatch, size, noise_std):
    """train_gnn for 3 steps against the JAX train_gnn, from the JAX init
    (the port draws its own weights from a torch.Generator, so init is
    replaced by the converted JAX params), with and without training noise,
    at ``GNNConfig().reduced()``."""
    check_train_gnn_losses(monkeypatch, size, noise_std)
