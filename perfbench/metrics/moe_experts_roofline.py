"""The routed experts of an MoE target (the port's dropless expert layer:
three ``torch._grouped_mm`` products over the rows sorted by expert)
against their roofline over the profiled stretch, in %: the least time
of the profiled rounds' expert products (``costs/moe.py``: each round's
routed rows from its rows' own window lengths, top-k a token in every
layer, and each admission's prompt; the (layer, expert) pairs a verify
window hits is the mean ``moe_hit`` of the window's ``compiled.verify``
spans, a prompt's at most every expert) over the profiled device time of
the grouped-product kernels.

Those are the kernels of the grouped GEMM that ``torch._grouped_mm`` runs
on the card: CUTLASS's grouped-problem GEMM (a name holding
``GroupProblemShape``) and the kernel that lays out its problems from the
group ends (``prepare_grouped_gemm``).  None when the profile has none,
or no verify span carries ``moe_hit`` (a dense target, or a program
without the counts)."""

from perfbench.costs import moe


def is_grouped(name: str) -> bool:
    return "GroupProblemShape" in name or "prepare_grouped_gemm" in name


def read(ctx):
    p = ctx["profile"]
    kernel_s = sum(s for n, s in p["kernels"] if is_grouped(n))
    hits = [sp.args["moe_hit"] for sp in ctx.get("spans", ())
            if sp.name == "compiled.verify" and sp.args
            and "moe_hit" in sp.args]
    if kernel_s <= 0 or not hits:
        return None
    target, _ = ctx["models"]
    hit = sum(hits) / len(hits)
    least = 0.0
    for r in p["rounds"]:
        rows = moe.routed_rows(target, sum(L + 1 for L in r["lengths"]))
        least += ctx["peaks"].least_seconds(*moe.expert_cost(target, rows,
                                                             hit))
        for M in r["prompts"]:
            rows = moe.routed_rows(target, M - 1)
            least += ctx["peaks"].least_seconds(*moe.expert_cost(
                target, rows, moe.prefill_hit(target, M - 1)))
    return 100.0 * least / kernel_s
