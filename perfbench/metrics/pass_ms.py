"""pass_ms (end to end): the window's measured time over the passes it
completed, in ms: a time per pass over all the window's work and time."""


def read(run):
    return run.window_s / run.passes * 1e3 if run.passes else None
