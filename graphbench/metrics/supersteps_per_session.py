"""supersteps_per_session (traversal): the program's ``bfs.superstep``
spans per ``session.get_paths`` span (``repro_torch.obs.trace``), in the
second part of a traced window: the supersteps of both collects of a
session, each one host synchronization."""


def read(ctx):
    names = [e.get("name") for e in ctx.program_spans if e.get("ph") == "X"]
    sessions = names.count("session.get_paths")
    if not sessions:
        return None
    return names.count("bfs.superstep") / sessions
