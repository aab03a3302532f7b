"""dist.host_self_ms (layer: sharded engine): the host self time per pass
of the profile's `dist:` operators (parallel/dist_executor.py)."""


def read(run):
    if not run.op_passes or "dist" not in run.op_self_s:
        return None
    return run.op_self_s["dist"] / run.op_passes * 1e3
