"""Ms an admission (``engine.add_streams``: both models' bucketed prefill
and the page allocation), timed by the benchmark's own wrapper to the end
of its work on the device."""


def read(ctx):
    a = ctx["admits"]
    return 1e3 * sum(s for _, _, s in a) / len(a) if a else None
