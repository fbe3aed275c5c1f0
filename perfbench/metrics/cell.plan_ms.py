"""Host ms a round in the cell's planner (span ``cell.plan``)."""


def read(ctx):
    rounds = len(ctx["records"])
    d = [sp.dur_ns for sp in ctx["spans"] if sp.name == "cell.plan"]
    return 1e-6 * sum(d) / rounds if d and rounds else None
