"""Device-true ms a round of drafting: the engine's ``engine.draft`` span,
closed after a device synchronise."""


def read(ctx):
    rounds = len(ctx["records"])
    d = [sp.dur_ns for sp in ctx["spans"] if sp.name == "engine.draft"]
    return 1e-6 * sum(d) / rounds if d and rounds else None
