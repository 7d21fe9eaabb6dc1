"""Mean ms of ``run()``'s ``pipeline.step`` span in the traced burst, from
the port's registry (``profiling.snapshot``): the enqueue of one batch's
step, NMS's host syncs included."""

from head_detector_tpu_torch import profiling


def read(run):
    snapshot = getattr(profiling, "snapshot", None)  # None: a port without the registry
    span = snapshot()["spans"].get("pipeline.step") if snapshot else None
    return 1e3 * span["seconds"] / span["count"] if span else None
