"""device.launches (layer: device): cudaLaunchKernel* and cudaGraphLaunch
calls in the traced passes, per pass."""


def read(run):
    t = run.trace_summary
    if t is None or not t.launches:
        return None
    return t.launches / t.passes
