"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with the cards the cell asks for.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared with its limit);
the last lines of standard error repeat the checks.  See ``PERF.md``.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmark", ".cache")
# build and kernel caches at fixed paths inside the checkout, so that only a
# cell's first run in a checkout builds; the port builds its CUDA and host
# libraries into head_detector_tpu_torch/_build/, also inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)

from benchmark.harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
