"""Mean seconds of a sequence's fine-tune over the window's sequences, on
the device's timeline: from the sequence's start to the evaluator's
``on_phase("fine_tune")`` mark."""

from harness.window import phase_seconds


def read(run):
    return phase_seconds(run.window, "start", "fine_tune")
