"""Device ms a round of the compiled draft step: the ``device_ms`` of the
``compiled.draft`` spans (a pair of CUDA events around each graph
replay) summed, over the window's rounds."""


def read(ctx):
    rounds = len(ctx["records"])
    d = [sp.args["device_ms"] for sp in ctx["spans"]
         if sp.name == "compiled.draft" and sp.args
         and "device_ms" in sp.args]
    return sum(d) / rounds if d and rounds else None
