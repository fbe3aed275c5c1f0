"""Mean planned draft length over the active rows of every round
(``RoundRecord.lengths``), in tokens."""

import numpy as np


def read(ctx):
    recs = ctx["records"]
    return float(np.mean(np.concatenate([r.lengths for r in recs]))) \
        if recs else None
