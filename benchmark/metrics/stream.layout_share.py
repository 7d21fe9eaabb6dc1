"""Share of the traced window's device time (%) in cuDNN's layout
transposes between NCHW and NHWC, from the profiler's kernel names."""

FRAGMENTS = ("nchwToNhwc", "nhwcToNchw")


def read(run):
    p = run.profile
    total = sum(s for s, _ in p.kernels.values())
    if total <= 0:
        return None
    return 100.0 * p.kernel_seconds(*FRAGMENTS) / total
