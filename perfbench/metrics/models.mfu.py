"""The whole step's share of the card's bf16 peak over the profiled
stretch: the models' operations that the rounds' inputs need (each active
row's own draft length, its verify window, each admission's prompt; no
padding, no frozen row, no prefill LM head) over stretch seconds x peak,
in %."""

from perfbench.costs import model as cost


def read(ctx):
    p = ctx["profile"]
    if p["busy_s"] <= 0:
        return None
    target, draft = ctx["models"]
    flops = 0.0
    for r in p["rounds"]:
        for pos, L_k in zip(r["pos"], r["lengths"]):
            flops += cost.draft_needed(draft, pos, L_k)
            flops += cost.verify_needed(target, pos, L_k)
        for M in r["prompts"]:
            flops += (cost.prefill_needed(target, M)
                      + cost.prefill_needed(draft, M))
    return 100.0 * flops / (p["window_s"] * ctx["peaks"].BF16_FLOPS)
