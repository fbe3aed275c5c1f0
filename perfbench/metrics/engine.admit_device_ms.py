"""Device ms an admission: the mean ``device_ms`` of the engine's
``engine.admit`` spans, a pair of CUDA events around both models' prefill,
read at the splice's first fetch."""


def read(ctx):
    d = [sp.args["device_ms"] for sp in ctx["spans"]
         if sp.name == "engine.admit" and sp.args and "device_ms" in sp.args]
    return sum(d) / len(d) if d else None
