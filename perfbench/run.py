"""Run one cell of ``BENCHMARK.json`` once and print its result line.

  python perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

Run from the root of a checkout. It puts the checkout and ``src`` on the
path itself, keeps the program's build and kernel caches in
``perfbench/.cache``, and exits with a code other than 0, printing no
result, without enough CUDA devices or when JAX or the JAX package is
loaded.
"""
import time

T_IMPORT = time.time()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# the script's own directory would shadow standard modules by its files
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    os.environ.update(harness.cache_env())
    t0 = harness.process_start_s() or T_IMPORT
    sys.exit(harness.main(t_start=t0))
