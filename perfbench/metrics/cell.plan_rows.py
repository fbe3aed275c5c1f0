"""Distinct length vectors the planner solved, as a share of its grid: the
mean ``rows`` / ``grid`` x 100 of the window's ``cell.plan_equalize`` spans,
in %.  A program whose span carries no such args reads None."""


def read(ctx):
    s = [sp.args["rows"] / sp.args["grid"] for sp in ctx["spans"]
         if sp.name == "cell.plan_equalize" and sp.args
         and sp.args.get("grid")]
    return 100.0 * sum(s) / len(s) if s else None
