"""setup_s (end to end): from the start of the process's benchmark code to
the first measured query: imports, CUDA's start, kernel builds or loads,
the tables made from the seed, their load and interning, the copy to the
device, and the warm-up passes."""


def read(run):
    return run.setup_s
