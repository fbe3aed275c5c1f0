"""Blocking device-to-host fetches a round (``RoundRecord.n_host_syncs``,
the engine's own count)."""

import numpy as np


def read(ctx):
    n = [r.n_host_syncs for r in ctx["records"] if r.n_host_syncs is not None]
    return float(np.mean(n)) if n else None
