#!/usr/bin/env python3
"""Hold the attention kernels of two checkouts against each other, bit for
bit, on the card.

    python3 tools/bit_compare.py run <checkout root> <out.pt> [max head dim]
    python3 tools/bit_compare.py compare <a.pt> <b.pt>

``run`` builds ``paged_attention`` (B1), ``paged_tree_attention`` (B3),
``tree_attention`` (B6), ``decode_attention`` (B7 and B9) and
``flash_attention`` (B8) from ``<checkout root>/src/repro_torch/csrc`` (into
that checkout's ``build/``), prints their ptxas lines, and calls each kernel
once, float32 and bfloat16, on the inputs of every phase-3 case of this
tool's own ``chip_smoke.py`` and of the checkout's ``cases`` edge lists
whose head dim is at most the limit (default 128), made from the cases'
own seeds (so both checkouts run the same list).  It
saves each output with a hash of its inputs, and the ptxas lines.
``compare`` holds two such files case by case: the inputs' hashes must
match and every output must be equal bit for bit; it prints the registers
and spills of each ptxas entry in both builds (names matched after
stripping the per-file anonymous-namespace hash) and exits 1 on any
difference of bits.  Run one ``run`` process per checkout (``.``, or the
parent unpacked with ``git archive`` into a directory that ``.gitignore``
lists), then ``compare``.  Needs one CUDA card.
"""

import hashlib
import importlib.util
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def _bytes(t):
    import torch

    return t.detach().cpu().contiguous().view(-1).view(torch.uint8)


def _hash(tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(str((t.dtype, tuple(t.shape))).encode())
        h.update(_bytes(t).numpy().tobytes())
    return h.hexdigest()


def run(root: str, out_path: str, max_d: int) -> None:
    spec = importlib.util.spec_from_file_location("chip_smoke_cases",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)     # puts HERE/src first: the root's goes before
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    import torch

    from repro_torch.kernels import build, cases
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import decode_attention_q8 as daq
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_tree_attention as pta
    from repro_torch.kernels import tree_attention as ta

    print(root, pa.__file__, cs.card_line(), flush=True)
    libs = ("paged_attention", "paged_tree_attention", "tree_attention",
            "decode_attention", "flash_attention")
    info = build.build_all(libs)
    ptxas = {name: list(info[name]["ptxas"]) for name in libs}
    outs = {}

    def call(kernel, name, dtype, fn, args):
        key = f"{kernel} | {name} | {str(dtype)[6:]}"
        outs[key] = (_hash(args), fn(*args).detach().cpu())

    for dtype in (torch.float32, torch.bfloat16):
        for name, shape, extra in ([(n, s, {}) for n, s in cs.PAGED_CASES]
                                   + list(cases.PAGED_EDGE_CASES)):
            if shape[4] <= max_d:
                call("paged_attention", name, dtype, pa.paged_attention_cuda,
                     cases.paged_case(*shape, dtype=dtype, device="cuda",
                                      **extra))
        tree = [(name, shape, chain, {}) for name, shape, chain in cs.TREE_CASES]
        if dtype == torch.bfloat16:
            tree += [(f"split: {name}, ps {ps}", (*shape, ps, 0), False,
                      dict(lengths=lengths, width=keys // ps))
                     for name, shape, lengths, keys in cases.TREE_SPLIT_CASES
                     for ps in (8, 16)]
        for name, shape, chain, extra in tree:
            if shape[5] <= max_d:
                call("paged_tree_attention", name, dtype,
                     pta.paged_tree_attention_cuda,
                     cases.tree_case(*shape, dtype=dtype, device="cuda",
                                     chain=chain, **extra))
        ctree = [(name, shape, chain, {})
                 for name, shape, chain in cs.CONTIGUOUS_TREE_CASES]
        if dtype == torch.bfloat16:
            ctree += [(f"split: {name}" + (", chain" if chain else ""),
                       (*shape, keys, 0), chain, dict(lengths=lengths))
                      for name, shape, lengths, keys in cases.TREE_SPLIT_CASES
                      for chain in (False, True)]
        for name, shape, chain, extra in ctree:
            if shape[5] <= max_d:
                call("tree_attention", name, dtype, ta.tree_attention_cuda,
                     cases.contiguous_tree_case(*shape, dtype=dtype,
                                                device="cuda", chain=chain,
                                                **extra))
        decode = list(cs.DECODE_CASES)
        if dtype == torch.bfloat16:
            decode += [(f"split: {name}", (*shape, lengths))
                       for name, shape, lengths in cases.DECODE_SPLIT_CASES]
        for name, shape in decode:
            if shape[3] <= max_d:
                call("decode_attention", name, dtype, da.decode_attention_cuda,
                     cases.decode_case(*shape, dtype=dtype, device="cuda"))
        for name, shape in cs.Q8_CASES:
            if shape[3] <= max_d:
                call("decode_attention_q8", name, dtype,
                     daq.decode_attention_q8_cuda,
                     cases.q8_case(*shape, dtype=dtype, device="cuda"))
        for name, (B, Sq, Skv, H, KV, D, causal) in cs.FLASH_CASES:
            if D <= max_d:
                args = cases.flash_case(B, Sq, Skv, H, KV, D, dtype, "cuda")
                call("flash_attention", name + (" causal" if causal else ""),
                     dtype, lambda q, k, v: fa.flash_attention_cuda(
                         q, k, v, causal=causal), args)
    torch.cuda.synchronize()
    torch.save({"root": root, "max_d": max_d, "outs": outs, "ptxas": ptxas},
               out_path)
    print(f"{root}: {len(outs)} outputs at head dim <= {max_d} -> {out_path}")


_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")
_ENTRY = re.compile(r"Function properties for (\S+)|Used (\d+) registers"
                    r"|(\d+) bytes spill stores, (\d+) bytes spill loads")


def _registers(lines) -> dict:
    """entry name (hash stripped) -> (registers, spill stores, spill loads)"""
    table, name, spill = {}, None, (0, 0)
    for line in lines:
        for m in _ENTRY.finditer(line):
            if m.group(1):
                name, spill = _ANON.sub("anon", m.group(1)), (0, 0)
            elif m.group(3) and name:
                spill = (int(m.group(3)), int(m.group(4)))
            elif m.group(2) and name:
                table[name] = (int(m.group(2)), *spill)
    return table


def compare(a_path: str, b_path: str) -> int:
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    bad = 0
    for lib in sorted(set(a["ptxas"]) & set(b["ptxas"])):
        ra, rb = _registers(a["ptxas"][lib]), _registers(b["ptxas"][lib])
        for name in sorted(set(ra) | set(rb)):
            print(f"ptxas {lib}: {name}: {a['root']} {ra.get(name)} "
                  f"{b['root']} {rb.get(name)} (registers, spill stores, "
                  f"spill loads)" + ("" if ra.get(name) == rb.get(name)
                                     else "  differs"))
    common = sorted(set(a["outs"]) & set(b["outs"]))
    for key in common:
        (ha, oa), (hb, ob) = a["outs"][key], b["outs"][key]
        if ha != hb:
            print(f"{key}: inputs differ")
            bad += 1
            continue
        same = oa.dtype == ob.dtype and oa.shape == ob.shape \
            and torch.equal(_bytes(oa), _bytes(ob))
        print(f"{key}: {'equal bit for bit' if same else 'BITS DIFFER'}")
        bad += not same
    only = sorted(set(a["outs"]) ^ set(b["outs"]))
    print(f"{len(common)} common outputs, {bad} differ; {len(only)} in one "
          f"checkout only: {only}")
    return int(bad > 0)


if __name__ == "__main__":
    if sys.argv[1:2] == ["run"]:
        run(sys.argv[2], sys.argv[3],
            int(sys.argv[4]) if len(sys.argv) > 4 else 128)
    elif sys.argv[1:2] == ["compare"]:
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    else:
        sys.exit(__doc__)
