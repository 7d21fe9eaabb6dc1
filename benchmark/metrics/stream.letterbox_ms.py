"""The letterbox workers' ms an image, over the batches ``run()`` took in
the traced burst, from the port's registry (``profiling.snapshot``):
``pipeline.letterbox_ns`` over ``pipeline.letterbox_images``."""

from head_detector_tpu_torch import profiling


def read(run):
    snapshot = getattr(profiling, "snapshot", None)  # None: a port without the registry
    counters = snapshot()["counters"] if snapshot else {}
    per = counters.get("pipeline.letterbox_images", 0)
    return 1e-6 * counters.get("pipeline.letterbox_ns", 0) / per if per else None
