"""Device ms a round of the compiled commit step: the ``device_ms`` of the
``compiled.commit`` spans (a pair of CUDA events around each graph
replay) summed, over the window's rounds."""


def read(ctx):
    rounds = len(ctx["records"])
    d = [sp.args["device_ms"] for sp in ctx["spans"]
         if sp.name == "compiled.commit" and sp.args
         and "device_ms" in sp.args]
    return sum(d) / rounds if d and rounds else None
