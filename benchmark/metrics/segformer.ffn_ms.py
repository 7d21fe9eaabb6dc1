"""Host ms a training step in the spans ``mit.ffn`` of the traced burst, summed
over the blocks and divided by the ``trainer.step`` spans, from the port's
registry (``profiling.snapshot``): the enqueue of each MiT block's Mix-FFN
forward (two Linears around the depthwise 3x3 and the GELU)."""

from head_detector_tpu_torch import profiling


def read(run):
    snapshot = getattr(profiling, "snapshot", None)  # None: a port without the registry
    spans = snapshot()["spans"] if snapshot else {}
    part, steps = spans.get("mit.ffn"), spans.get("trainer.step")
    return 1e3 * part["seconds"] / steps["count"] if part and steps else None
