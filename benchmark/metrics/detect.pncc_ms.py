"""Mean ms of one ``get_pncc`` (the ``pncc.render`` span) in the traced
burst, from the port's registry (``profiling.snapshot``): an image's PNCC
map, host checks, launches and the map's read."""

from head_detector_tpu_torch import profiling


def read(run):
    snapshot = getattr(profiling, "snapshot", None)  # None: a port without the registry
    span = snapshot()["spans"].get("pncc.render") if snapshot else None
    return 1e3 * span["seconds"] / span["count"] if span else None
