"""ops.host_self_ms (layer: operators): the operators' host self time per
pass, from the engine's operator profile (Database(profile=True),
db.last_profile after each statement), single-device operators only."""


def read(run):
    if not run.op_passes or "ops" not in run.op_self_s:
        return None
    return run.op_self_s["ops"] / run.op_passes * 1e3
