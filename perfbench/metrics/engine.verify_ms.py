"""Device-true ms a round of verification (the target's window pass and
the accept test): the engine's ``engine.verify_step`` span, closed after a
device synchronise."""


def read(ctx):
    rounds = len(ctx["records"])
    d = [sp.dur_ns for sp in ctx["spans"] if sp.name == "engine.verify_step"]
    return 1e-6 * sum(d) / rounds if d and rounds else None
