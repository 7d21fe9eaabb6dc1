"""Suppression sweeps an NMS call in the traced burst, from the port's
registry (``profiling.snapshot``): ``nms.sweeps`` over ``nms.calls``; each
sweep is compared on the host, a wait on the card."""

from head_detector_tpu_torch import profiling


def read(run):
    snapshot = getattr(profiling, "snapshot", None)  # None: a port without the registry
    counters = snapshot()["counters"] if snapshot else {}
    per = counters.get("nms.calls", 0)
    return counters.get("nms.sweeps", 0) / per if per else None
