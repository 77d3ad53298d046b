"""Mean seconds of a sequence's propagation (window inferences, refits,
for Mask R-CNN the box carry) over the window's sequences, on the
device's timeline: between the evaluator's ``on_phase("fine_tune")`` and
``on_phase("propagate")`` marks."""

from harness.window import phase_seconds


def read(run):
    return phase_seconds(run.window, "fine_tune", "propagate")
