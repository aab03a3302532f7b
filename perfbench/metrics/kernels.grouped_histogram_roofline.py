"""kernels.grouped_histogram_roofline (layer: kernels): kernel 1's share of
its memory bound over the traced passes, in %: the bytes its calls must
move (each input byte read once, each output byte written once, from the
calls' arguments; a replay credited with its text's recorded bytes) at
the card's published rate, over the device time of its records. Nothing
is read where no call ran, where a call's bytes are unknown, or where the
trace holds another number of its records than the calls launched."""


def read(run):
    t = run.trace_summary
    if (t is None or run.hbm_bytes_per_s is None or t.k1_launches == 0
            or t.k1_bytes is None or t.k1_records != t.k1_launches or t.k1_s <= 0):
        return None
    return 100.0 * t.k1_bytes / run.hbm_bytes_per_s / t.k1_s
