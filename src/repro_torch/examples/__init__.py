"""The port's twins of the JAX package's examples (``examples/``), each
run as ``python -m repro_torch.examples.<name>`` and on the card unless
``--device cpu``:

* ``quickstart``: train X-MeshGraphNet on synthetic car aerodynamics, then
  the paper's Table-I metrics on held-out cars;
* ``realtime_inference``: a tessellated geometry in, surface fields out,
  through ``GNNServer`` (``--shard-devices P`` shards each request);
* ``partition_equivalence``: halo partitions with gradient aggregation
  against full-graph training, P = 2, 4 and 8;
* ``serve_llm``: batched prefill and decode of reduced gemma2-9b and
  xlstm-350m.

``examples/xunet_volume.py``'s twin is ``repro_torch.launch.xunet_volume``.
"""
