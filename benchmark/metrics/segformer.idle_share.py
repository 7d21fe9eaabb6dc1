"""Share of the traced burst (%) in which no operation ran on the card:
1 - busy / window.  Read by ``train.idle_share.py``'s ``read``, loaded from
that file."""

import os

from benchmark.harness.core import load_module

read = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "train.idle_share.py"), "bench_metric_train_idle_share").read
