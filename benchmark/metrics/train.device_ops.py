"""Device operations a training step in the traced burst: every kernel, copy
and set in the device trace (``run.profile.kernels``, their counts summed)
over the ``trainer.step`` spans in the port's registry
(``profiling.snapshot``)."""

from head_detector_tpu_torch import profiling


def read(run):
    snapshot = getattr(profiling, "snapshot", None)  # None: a port without the registry
    steps = snapshot()["spans"].get("trainer.step") if snapshot else None
    ops = sum(n for _, n in run.profile.kernels.values())
    return ops / steps["count"] if steps and ops else None
