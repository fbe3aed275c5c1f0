#!/usr/bin/env python3
"""Time the port's attention, scan and verification kernels of one checkout
on the card, to compare two commits within one call.

    python3 tools/window_times.py <checkout root> <label> [kernel ...]

    python3 tools/window_times.py <root> <label> --row-blocks K [kernel ...]

Kernels (default: all): ``paged_attention`` (B1), ``paged_tree_attention``
(B3), ``tree_attention`` (B6), ``decode_attention`` (B7),
``decode_attention_q8`` (B9), ``ssd_scan`` (B10), ``fused_verify_sample``
(B2), ``gather_softmax_prob`` (B4), ``residual_sample`` (B5).
``--row-blocks K`` sets the blocks a SM that the samplers' split aims at
(``fused_verify_sample.ROW_BLOCKS_PER_SM``) for this run.  Builds them from
``<checkout root>/src/repro_torch/csrc`` (into that checkout's ``build/``),
prints their ptxas lines, and times each at the phase-3 shapes of that
checkout's ``chip_smoke.py`` (``PAGED_CASES`` and
``cases.PAGED_EDGE_CASES`` for B1, ``TREE_CASES`` for B3,
``CONTIGUOUS_TREE_CASES`` for B6, ``DECODE_CASES`` for B7, ``Q8_CASES`` for
B9, ``SSD_CASES`` for B10, float32 and bfloat16; ``VERIFY_CASES`` for B2,
``SOFTMAX_CASES`` for B4 and ``RESIDUAL_CASES`` for B5, float32): kernel ms
and, where one PyTorch call computes the same function, that call's ms
(SDPA), for B4 ``cross_entropy``'s (-log of the same value, not the same
function; ``cases.time_ms``), one line a case, with the samplers' chunks a
row where the checkout plans them.  Run one process per checkout (``.``, or
another commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists), in turns: parent, change, change, parent.  Needs one
CUDA card.
"""

import sys

KERNELS = ("paged_attention", "paged_tree_attention", "tree_attention",
           "decode_attention", "decode_attention_q8", "ssd_scan",
           "fused_verify_sample", "gather_softmax_prob", "residual_sample")


def main(root: str, label: str, names, row_blocks=None) -> None:
    sys.path.insert(0, root + "/src")
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, cases
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import decode_attention_q8 as daq
    from repro_torch.kernels import fused_verify_sample as fvs
    from repro_torch.kernels import gather_softmax_prob as gsp
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_tree_attention as pta
    from repro_torch.kernels import residual_sample as rs
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import tree_attention as ta

    if row_blocks is not None:
        fvs.ROW_BLOCKS_PER_SM = row_blocks
    print(label, cs.__file__, cs.card_line(), flush=True)
    libs = sorted({"decode_attention" if n == "decode_attention_q8" else n
                   for n in names})
    info = build.build_all(libs)
    for name in libs:
        for line in info[name]["ptxas"]:
            print(f"{label} ptxas {name}: {line}")
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def report(kernel, name, dtype, fn, lib_args=None, other=None):
        ms = cases.time_ms(fn)
        line = (f"{label} {kernel:20s} {name:40s} {str(dtype)[6:]:8s} kernel "
                f"{ms:.4f} ms")
        if other is not None:      # (note, fn): a yardstick of another function
            lib = cases.time_ms(other[1])
            line += f"  {other[0]} {lib:.4f} ms  kernel/{other[0]} {ms / lib:.2f}"
        if lib_args is not None:
            sq, sk, sv, kw = lib_args
            if not isinstance(kw, dict):
                kw = {"attn_mask": kw}
            lib = cases.time_ms(lambda: sdpa(sq, sk, sv, **kw))
            line += f"  sdpa {lib:.4f} ms  kernel/sdpa {ms / lib:.2f}"
        print(line, flush=True)

    paged = ([(n, s, {}) for n, s in cs.PAGED_CASES]
             + [(n, s, e) for n, s, e in cases.PAGED_EDGE_CASES])
    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, extra in paged * ("paged_attention" in names):
            args = cases.paged_case(*shape, dtype=dtype, device="cuda", **extra)
            report("paged_attention", name, dtype,
                   lambda: pa.paged_attention_cuda(*args),
                   cases.paged_sdpa_inputs(*args))
        for name, shape, chain in cs.TREE_CASES * ("paged_tree_attention"
                                                   in names):
            args = cases.tree_case(*shape, dtype=dtype, device="cuda",
                                   chain=chain)
            report("paged_tree_attention", name, dtype,
                   lambda: pta.paged_tree_attention_cuda(*args),
                   cases.tree_sdpa_inputs(*args))
        for name, shape, chain in cs.CONTIGUOUS_TREE_CASES * ("tree_attention"
                                                              in names):
            args = cases.contiguous_tree_case(*shape, dtype=dtype,
                                              device="cuda", chain=chain)
            report("tree_attention", name, dtype,
                   lambda: ta.tree_attention_cuda(*args),
                   cases.contiguous_tree_sdpa_inputs(*args))
        for name, shape in cs.DECODE_CASES * ("decode_attention" in names):
            args = cases.decode_case(*shape, dtype=dtype, device="cuda")
            report("decode_attention", name, dtype,
                   lambda: da.decode_attention_cuda(*args),
                   cases.decode_sdpa_inputs(*args))
        for name, shape in cs.Q8_CASES * ("decode_attention_q8" in names):
            args = cases.q8_case(*shape, dtype=dtype, device="cuda")
            report("decode_attention_q8", name, dtype,
                   lambda: daq.decode_attention_q8_cuda(*args))
        for name, (b, s, h, p, g, n, chunk), init in cs.SSD_CASES * (
                "ssd_scan" in names):
            x, dt, A, B, C, st = cases.ssd_case(b, s, h, p, g, n, dtype,
                                                "cuda", init=init)
            report("ssd_scan", name, dtype,
                   lambda: ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=chunk,
                                             initial_state=st))
    # (name, shape) in checkouts before the edge-row case, then (name,
    # shape, edge); the edge rows change no time, so only shapes are timed
    for case in cs.VERIFY_CASES * ("fused_verify_sample" in names):
        name, (B, L, V, vhat) = case[:2]
        if len(case) > 2 and case[2]:
            continue
        args = cases.verify_case(B, L, V, vhat, "cuda")
        report("fused_verify_sample", name, torch.float32,
               lambda: fvs.fused_verify_sample_cuda(*args))
    plan = getattr(fvs, "row_split_plan", None)   # None before the split

    def chunks(N, V, dev):
        if plan is None:
            return ""
        C, chunk = plan(N, V, pa.sm_count(dev))
        return f" ({C} x {chunk})"

    for name, (N, V) in cs.SOFTMAX_CASES * ("gather_softmax_prob" in names):
        logits, ids = cases.softmax_case(N, V, "cuda")
        ids_long = ids.long()
        report("gather_softmax_prob", name + chunks(N, V, logits.device),
               torch.float32, lambda: gsp.gather_softmax_prob_cuda(logits, ids),
               other=("cross_entropy", lambda: torch.nn.functional.cross_entropy(
                   logits, ids_long, reduction="none")))
    for name, (N, V) in cs.RESIDUAL_CASES * ("residual_sample" in names):
        p, q, u = cases.residual_case(N, V, "cuda")
        report("residual_sample", name + chunks(N, V, p.device), torch.float32,
               lambda: rs.residual_sample_cuda(p, q, u))


if __name__ == "__main__":
    args = sys.argv[3:]
    blocks = None
    if args[:1] == ["--row-blocks"]:
        blocks, args = int(args[1]), args[2:]
    chosen = tuple(args) or KERNELS
    unknown = set(chosen) - set(KERNELS)
    if unknown:
        sys.exit(f"unknown kernels {sorted(unknown)}; choose from {KERNELS}")
    main(sys.argv[1], sys.argv[2], chosen, blocks)
