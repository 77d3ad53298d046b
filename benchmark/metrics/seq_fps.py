"""Frames per second of whole sequences, fine-tune included: every frame
of every sequence the window completed, over the window's wall time from
its start to its last sequence's end (host fetch included)."""


def read(run):
    w = run.window
    return w.frames / w.seconds if w.sequences and w.seconds > 0 else None
