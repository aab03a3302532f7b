"""programs.replay_share (layer: programs): over the window, graph replays
over replays + first sightings + captures + calls routed eagerly
(utils/programs.py's `stats`)."""


def read(run):
    st = run.program_stats
    total = st.get("replays", 0) + st.get("warmups", 0) + st.get("captures", 0) \
        + st.get("eager_routed", 0)
    return st["replays"] / total if total else None
