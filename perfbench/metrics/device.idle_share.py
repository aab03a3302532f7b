"""device.idle_share (layer: device): 1 - the union of the device's kernel,
copy and set records over the traced window's length."""


def read(run):
    t = run.trace_summary
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 1.0 - t.busy_s / t.window_s
