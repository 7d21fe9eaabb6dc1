"""Mean ms of ``run()``'s ``pipeline.feed_wait`` span in the traced burst,
from the port's registry (``profiling.snapshot``): the wait on the
producer's queue for the next letterboxed batch."""

from head_detector_tpu_torch import profiling


def read(run):
    snapshot = getattr(profiling, "snapshot", None)  # None: a port without the registry
    span = snapshot()["spans"].get("pipeline.feed_wait") if snapshot else None
    return 1e3 * span["seconds"] / span["count"] if span else None
