"""The GroupNorm kernels' share of their byte roofline in the traced
sequence: the bytes the sequence's GroupNorms must move (from the
reference model's GroupNorm shapes and the configuration's passes,
``harness/counts.py``) over the card's 3.35 TB/s, divided by the device
time of the port's GroupNorm kernels, by name, in the trace."""

KERNELS = ("partial_sums_kernel", "group_finalize_kernel", "affine_kernel",
           "affine_dx_kernel")


def read(run):
    if run.trace is None or not run.counts:
        return None
    seconds = sum(s for name, s in run.trace.kernel_s.items()
                  if any(k in name for k in KERNELS))
    if seconds <= 0 or run.counts["gn_bytes"] <= 0:
        return None
    bound = run.counts["gn_bytes"] / run.peaks.HBM_BYTES_PER_S
    return 100.0 * bound / seconds
