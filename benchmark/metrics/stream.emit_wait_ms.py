"""Mean ms of ``run()``'s ``pipeline.emit_wait`` span in the traced burst,
from the port's registry (``profiling.snapshot``): the host's wait for one
batch's outputs in their pinned buffers."""

from head_detector_tpu_torch import profiling


def read(run):
    snapshot = getattr(profiling, "snapshot", None)  # None: a port without the registry
    span = snapshot()["spans"].get("pipeline.emit_wait") if snapshot else None
    return 1e3 * span["seconds"] / span["count"] if span else None
