"""The whole request's share (%) of the card's float32 peak (the path
computes in float32 with TF32 off): the deploy forward's FLOPs an image,
counted from the configuration's shapes, times the images the window's
requests served over the seconds they were being served (from each send
to its last PNCC map), not over the window: the client offers requests at
a fixed rate, so the window's own rate is the traffic's, whatever the
program does."""


def read(run):
    if run.peaks is None:
        return None
    rate = run.window.facts["images"] / run.window.facts["service_seconds"]
    return 100.0 * run.work["flops_per_image"] * rate / run.peaks["fp32_flops"]
