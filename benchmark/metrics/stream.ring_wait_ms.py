"""The stream's producer's ms a batch waiting for a free slot set of the
pinned ring, over the sets it took in the traced burst, from the port's
registry (``profiling.snapshot``): ``pipeline.ring_wait_ns`` over
``pipeline.ring_fills``.  Well above 0 while ``stream.feed_wait_ms`` is near
0: the card sets the pace; the reverse: the letterbox does."""

from head_detector_tpu_torch import profiling


def read(run):
    snapshot = getattr(profiling, "snapshot", None)  # None: a port without the registry
    counters = snapshot()["counters"] if snapshot else {}
    fills = counters.get("pipeline.ring_fills", 0)
    return 1e-6 * counters.get("pipeline.ring_wait_ns", 0) / fills if fills else None
