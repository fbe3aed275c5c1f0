#!/usr/bin/env python3
"""Time the window attention kernels (B1 ``paged_attention``, B3
``paged_tree_attention``, B6 ``tree_attention``) of one checkout on the
card, to compare two commits within one call.

    python3 tools/window_times.py <checkout root> <label>

Builds the three kernels from ``<checkout root>/src/repro_torch/csrc`` (into
that checkout's ``build/``), prints their ptxas lines, and times each at the
phase-3 shapes of that checkout's ``chip_smoke.py`` (``PAGED_CASES`` and
``cases.PAGED_EDGE_CASES`` for B1, ``TREE_CASES`` for B3,
``CONTIGUOUS_TREE_CASES`` for B6), float32 and bfloat16: kernel ms and the
one-call SDPA ms of the same function (``cases.time_ms``), one line a case.
Run one process per checkout (``.``, or another commit unpacked with ``git
archive`` into a directory that ``.gitignore`` lists), in turns: parent,
change, change, parent.  Needs one CUDA card.
"""

import sys


def main(root: str, label: str) -> None:
    sys.path.insert(0, root + "/src")
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, cases
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_tree_attention as pta
    from repro_torch.kernels import tree_attention as ta

    print(label, cs.__file__, cs.card_line(), flush=True)
    names = ("paged_attention", "paged_tree_attention", "tree_attention")
    info = build.build_all(names)
    for name in names:
        for line in info[name]["ptxas"]:
            print(f"{label} ptxas {name}: {line}")
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def report(kernel, name, dtype, fn, lib_args):
        ms = cases.time_ms(fn)
        sq, sk, sv, mask = lib_args
        lib = cases.time_ms(lambda: sdpa(sq, sk, sv, attn_mask=mask))
        print(f"{label} {kernel:20s} {name:40s} {str(dtype)[6:]:8s} kernel "
              f"{ms:.4f} ms  sdpa {lib:.4f} ms  kernel/sdpa {ms / lib:.2f}",
              flush=True)

    paged = ([(n, s, {}) for n, s in cs.PAGED_CASES]
             + [(n, s, e) for n, s, e in cases.PAGED_EDGE_CASES])
    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, extra in paged:
            args = cases.paged_case(*shape, dtype=dtype, device="cuda", **extra)
            report("paged_attention", name, dtype,
                   lambda: pa.paged_attention_cuda(*args),
                   cases.paged_sdpa_inputs(*args))
        for name, shape, chain in cs.TREE_CASES:
            args = cases.tree_case(*shape, dtype=dtype, device="cuda",
                                   chain=chain)
            report("paged_tree_attention", name, dtype,
                   lambda: pta.paged_tree_attention_cuda(*args),
                   cases.tree_sdpa_inputs(*args))
        for name, shape, chain in cs.CONTIGUOUS_TREE_CASES:
            args = cases.contiguous_tree_case(*shape, dtype=dtype,
                                              device="cuda", chain=chain)
            report("tree_attention", name, dtype,
                   lambda: ta.tree_attention_cuda(*args),
                   cases.contiguous_tree_sdpa_inputs(*args))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
