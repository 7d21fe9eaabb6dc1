"""Share of the traced burst's device time (%) in the attention's softmax
kernels, forward and backward, and in any fused-attention kernel, from the
profiler's kernel names (the heads' DFL softmax over 17 bins and the loss's
log-softmax match too; they are small beside the attention's scores)."""

FRAGMENTS = ("softmax", "SoftMax", "fmha", "flash", "attention")


def read(run):
    p = run.profile
    total = sum(s for s, _ in p.kernels.values())
    if total <= 0:
        return None
    return 100.0 * p.kernel_seconds(*FRAGMENTS) / total
