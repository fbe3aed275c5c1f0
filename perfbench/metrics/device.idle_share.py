"""Share of the profiled stretch in which no operation ran on the card:
1 - (union of device intervals) / (stretch length), in %."""


def read(ctx):
    p = ctx["profile"]
    if p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
