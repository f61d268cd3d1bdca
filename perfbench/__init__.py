"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line. Everything that belongs to one configuration, traffic mix
or per-layer metric is a file of its own, found by name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``drivers/<driver>.py`` and ``metrics/<metric>.py``. The yardstick (the
plain references, the counting functions, the table of peaks, the
comparisons that decide ``correct``) lives here too, so a change to the
program cannot move it.
"""
