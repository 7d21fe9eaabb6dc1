"""Median latency of the window's detection requests (ms), from the same
requests as ``detect_p95_ms``."""

import numpy as np


def read(run):
    lat = run.window.facts.get("latencies_ms")
    return float(np.median(lat)) if lat is not None and len(lat) else None
