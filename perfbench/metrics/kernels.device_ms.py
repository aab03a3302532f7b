"""kernels.device_ms (layer: kernels): the device time of every kernel
record in the traced passes (torch.profiler, CUDA activity), per pass."""


def read(run):
    t = run.trace_summary
    if t is None or t.kernel_s <= 0:
        return None
    return t.kernel_s / t.passes * 1e3
