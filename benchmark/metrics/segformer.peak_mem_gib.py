"""Peak memory the allocator held for tensors over the window (GiB).  Read
by ``train.peak_mem_gib.py``'s ``read``, loaded from that file."""

import os

from benchmark.harness.core import load_module

read = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "train.peak_mem_gib.py"), "bench_metric_train_peak_mem_gib").read
