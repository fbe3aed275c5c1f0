"""Host ms a round in the compiled steps' calls: the ``compiled.draft``,
``compiled.verify`` and ``compiled.commit`` spans (input copies, graph
replay, output clones) summed, over the window's rounds."""

STEPS = ("compiled.draft", "compiled.verify", "compiled.commit")


def read(ctx):
    rounds = len(ctx["records"])
    d = [sp.dur_ns for sp in ctx["spans"] if sp.name in STEPS]
    return 1e-6 * sum(d) / rounds if d and rounds else None
