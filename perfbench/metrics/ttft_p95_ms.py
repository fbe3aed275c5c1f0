"""95th percentile of time to first token over every request whose first
token was committed in the window: from its submission (the host clock when
its device sent it) to the end of the round that committed the token."""

import numpy as np


def read(ctx):
    ttft = ctx["window"]["ttft_s"]
    return 1e3 * float(np.percentile(ttft, 95)) if ttft else None
