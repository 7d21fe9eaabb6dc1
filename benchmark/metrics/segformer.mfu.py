"""The whole training step's share (%) of the card's dense bfloat16 peak:
the reference network's forward and backward FLOPs an image
(``harness/work_mit.py``) times the window's images/s.  Read by
``train.mfu.py``'s ``read``, loaded from that file."""

import os

from benchmark.harness.core import load_module

read = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "train.mfu.py"),
                   "bench_metric_train_mfu").read
