"""95th percentile of time to first token over every request whose first
token was committed in the traced run's window: from its submission (the
host clock when its device sent it) to the end of the round that committed
the token.  A request's first token lands at the end of its admission
round, so this is the tail of the rounds that admit most.  A per-layer
reading: its runs spread too widely over seeds for an end-to-end bound."""

import numpy as np


def read(ctx):
    ttft = ctx["window"]["ttft_s"]
    return 1e3 * float(np.percentile(ttft, 95)) if ttft else None
