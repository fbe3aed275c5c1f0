"""Window pages a live row holds: the mean, over the engine's
``engine.window_free`` spans (one after each commit and admission of a
target with sliding-window layers, once the pages below every row's window
have gone back to the window pool), of ``held`` / ``rows``, in pages a
row.  None where no span has rows (no window layers)."""


def read(ctx):
    v = [sp.args["held"] / sp.args["rows"] for sp in ctx["spans"]
         if sp.name == "engine.window_free" and sp.args
         and sp.args.get("rows")]
    return sum(v) / len(v) if v else None
