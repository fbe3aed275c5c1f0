"""Committed tokens delivered per second of the window: every token the
cell counted to a request in the window's rounds (at most its
``max_new_tokens``), over the window's host-clock length."""


def read(ctx):
    w = ctx["window"]
    return w["tokens"] / w["seconds"]
