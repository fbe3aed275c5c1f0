#!/usr/bin/env python3
"""Serve the contiguous tree and hybrid paths of one checkout's
``chip_smoke.py`` on the card, to compare two commits within one call.

    python3 tools/chip_paths.py <checkout root> <label>

Imports ``chip_smoke.main_path`` and the port from ``<checkout root>``
(``.``, or another commit unpacked with ``git archive`` into a directory
that ``.gitignore`` lists) and runs its contiguous tree path (Llama-2-7B /
TinyLlama-1.1B, ``multidraft``, 16 rounds) and its hybrid path
(Zamba2-2.7B / TinyLlama-1.1B, ``hete``, 16 rounds) in bfloat16, each
printing its round times, launch counts and profile.  Run one process per
checkout, in turns: parent, change, change, parent.  Needs one CUDA card.
"""

import gc
import sys


def main(root: str, label: str) -> None:
    sys.path.insert(0, root + "/src")
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    print(label, cs.__file__, ops.__file__, flush=True)
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    pair = (get_config("llama2-7b").replace(**bf16),
            get_config("tinyllama-1.1b").replace(**bf16), torch.bfloat16)
    cs.main_path(torch, np, ops, *pair, label=f"{label} contiguous tree path",
                 scheme="multidraft", scheme_params={"J_min": 2, "J_max": 3},
                 path_ops=("tree_attention",), syncs=2, min_width=2,
                 n_rounds=16, cache_kind="contiguous")
    gc.collect()
    torch.cuda.empty_cache()
    zamba = get_config("zamba2-2.7b").replace(**bf16)
    cs.main_path(torch, np, ops, zamba, pair[1], torch.bfloat16,
                 label=f"{label} hybrid path", scheme="hete", scheme_params={},
                 path_ops=("fused_verify_sample",), syncs=1, min_width=1,
                 n_rounds=16, cache_kind="contiguous", NEW=10 ** 6)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
