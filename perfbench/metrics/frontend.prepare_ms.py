"""frontend.prepare_ms (layer: frontend): host ms a query spends in
`db.connect().prepare(sql)` (parse, bind, HEP optimize, physical plan),
over every statement of the traced run's frontend passes, per query."""


def read(run):
    if not run.prepare_queries:
        return None
    return run.prepare_s / run.prepare_queries * 1e3
