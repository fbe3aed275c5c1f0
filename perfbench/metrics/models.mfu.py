"""The whole step's share of the card's bf16 peak over the profiled
stretch: the models' operations that the rounds' inputs need (each active
row's own draft length, its verify window, each admission's prompt; no
padding, no frozen row, no prefill LM head) over stretch seconds x peak,
in %."""

from perfbench.costs import dense


def read(ctx):
    p = ctx["profile"]
    if p["busy_s"] <= 0:
        return None
    tm, dm = ctx["models"]
    flops = 0.0
    for r in p["rounds"]:
        for pos, L_k in zip(r["pos"], r["lengths"]):
            flops += dense.draft_needed(dm, pos, L_k)
            flops += dense.verify_needed(tm, pos, L_k)
        for M in r["prompts"]:
            flops += dense.prefill_needed(tm, M) + dense.prefill_needed(dm, M)
    return 100.0 * flops / (p["window_s"] * ctx["peaks"].BF16_FLOPS)
