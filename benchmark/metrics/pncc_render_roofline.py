"""``pncc_render``'s share (%) of its roofline in the traced burst: the
least time the card could take for the calls' bytes (each input read once,
the uint8 canvas written once, counted from the shapes by the benchmark)
at the HBM peak, over the device time of the entry point's two kernels
(``setup_kernel``, ``pncc_render_kernel``).  Its operations are not counted,
so the bound is the bytes'; the share is a lower bound."""


def read(run):
    p = run.profile
    seconds = p.kernel_seconds("setup_kernel", "pncc_render_kernel")
    if run.peaks is None or seconds <= 0 or run.work.get("pncc_render_bytes", 0) <= 0:
        return None
    return 100.0 * run.work["pncc_render_bytes"] / run.peaks["hbm_bytes_per_s"] / seconds
