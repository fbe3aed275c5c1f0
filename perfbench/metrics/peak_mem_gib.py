"""The card's peak allocated memory over the whole run, set-up included
(``torch.cuda.max_memory_allocated``), in GiB; read before the check."""


def read(ctx):
    return ctx["peak_bytes"] / 2 ** 30 if ctx["peak_bytes"] else None
