"""Mean ms of the training step's ``trainer.ema`` span in the traced burst,
from the port's registry (``profiling.snapshot``): the EMA's enqueue on the
host."""

from head_detector_tpu_torch import profiling


def read(run):
    snapshot = getattr(profiling, "snapshot", None)  # None: a port without the registry
    span = snapshot()["spans"].get("trainer.ema") if snapshot else None
    return 1e3 * span["seconds"] / span["count"] if span else None
