"""Mean ms of ``run()``'s ``pipeline.upload`` span in the traced burst, from
the port's registry (``profiling.snapshot``): one batch's wait for its
pinned slot, the fill of the slot on the host and the copy's enqueue."""

from head_detector_tpu_torch import profiling


def read(run):
    snapshot = getattr(profiling, "snapshot", None)  # None: a port without the registry
    span = snapshot()["spans"].get("pipeline.upload") if snapshot else None
    return 1e3 * span["seconds"] / span["count"] if span else None
