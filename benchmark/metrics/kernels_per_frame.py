"""Device kernels of the traced sequence (``torch.profiler``; copies and
sets not counted) over its frames: the host's launch load a frame."""


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    return run.trace.kernels / run.traced_frames
