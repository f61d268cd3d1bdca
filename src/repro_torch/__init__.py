"""PyTorch + CUDA port of the X-MeshGraphNet serving path.

A second package beside the JAX reference ``repro``: same sub-package layout
and function names, PyTorch idiom inside, hand-written CUDA kernels for the
two TPU kernels on the main path (``kernels.knn``, ``kernels.segment_agg``).
It imports neither ``jax`` nor anything of ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise (see :func:`repro_torch.device.resolve`).
"""
