"""Mean ms of ``predict_batch``'s ``detector.letterbox`` span in the traced
burst, from the port's registry (``profiling.snapshot``): the images'
conversion, stacks, pageable uploads and device letterbox."""

from head_detector_tpu_torch import profiling


def read(run):
    snapshot = getattr(profiling, "snapshot", None)  # None: a port without the registry
    span = snapshot()["spans"].get("detector.letterbox") if snapshot else None
    return 1e3 * span["seconds"] / span["count"] if span else None
