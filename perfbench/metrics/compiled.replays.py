"""CUDA graph replays a round of the compiled draft, verify and commit
steps (``SpecEngine.step_counts()`` over the window)."""


def read(ctx):
    rounds = len(ctx["records"])
    return sum(ctx["replays"].values()) / rounds if rounds else None
