"""Mean ms of ``predict_batch``'s ``detector.build_heads`` span in the
traced burst, from the port's registry (``profiling.snapshot``): the host's
``HeadMetadata`` of a request's results."""

from head_detector_tpu_torch import profiling


def read(run):
    snapshot = getattr(profiling, "snapshot", None)  # None: a port without the registry
    span = snapshot()["spans"].get("detector.build_heads") if snapshot else None
    return 1e3 * span["seconds"] / span["count"] if span else None
