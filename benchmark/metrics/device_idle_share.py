"""Share of the traced sequence's wall time in which no operation ran on
the device: 1 - (union of the device operations' intervals / the traced
window), in percent."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
