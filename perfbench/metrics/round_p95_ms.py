"""95th percentile of the window's round times (host clock, each round
ending in the engine's one host sync), in ms, over every round."""

import numpy as np


def read(ctx):
    return 1e3 * float(np.percentile(ctx["window"]["round_s"], 95))
