"""Blocking device-to-host fetches an admission: the mean ``syncs`` of the
engine's ``engine.admit`` spans (the splice's copies, which the round's
``backend.host_syncs`` does not count)."""


def read(ctx):
    n = [sp.args["syncs"] for sp in ctx["spans"]
         if sp.name == "engine.admit" and sp.args and "syncs" in sp.args]
    return sum(n) / len(n) if n else None
