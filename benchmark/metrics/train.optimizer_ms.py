"""Mean ms of the training step's ``trainer.optimizer`` span in the traced
burst, from the port's registry (``profiling.snapshot``): the all-reduce,
the clip and AdamW's enqueue on the host."""

from head_detector_tpu_torch import profiling


def read(run):
    snapshot = getattr(profiling, "snapshot", None)  # None: a port without the registry
    span = snapshot()["spans"].get("trainer.optimizer") if snapshot else None
    return 1e3 * span["seconds"] / span["count"] if span else None
