"""The whole step's share (%) of the card's dense bfloat16 peak: the deploy
forward's FLOPs an image, counted from the configuration's shapes, times the
window's images/s."""


def read(run):
    if run.peaks is None:
        return None
    rate = run.window.facts["images"] / run.window.facts["seconds"]
    return 100.0 * run.work["flops_per_image"] * rate / run.peaks["bf16_flops"]
