"""The whole sequence's share of the card's dense peak at the
configuration's precision: the convolution and matrix FLOPs of the
sequences the window completed (counted on the reference model,
``harness/counts.py``) over the window's seconds times the peak
(``harness/peaks.py``)."""


def read(run):
    w = run.window
    if not run.counts or not w.sequences or w.seconds <= 0:
        return None
    peak = run.peaks.FLOPS[run.cfg["precision"]["dtype"]]
    flops = run.counts["flops"] * len(w.sequences)
    return 100.0 * flops / (w.seconds * peak)
