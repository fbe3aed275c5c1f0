"""Roofline rates, model FLOPs, parameter counts and the collective
inventory of a traced step.

The port of ``repro.roofline.analysis``.  Three terms per (arch x shape x
mesh) cell:

  compute_s    = FLOPs / peak_FLOP/s
  memory_s     = HBM bytes / HBM_bw
  collective_s = per-device collective bytes / link_bw

The rates are the card's datasheet figures, not measurements.  The JAX
package parses the collectives out of the partitioned HLO; eager torch has
no HLO, so ``record_collectives()`` counts the ``_c10d_functional`` ops a
traced step issues (DTensor's redistributions and the explicit collectives
of ``distributed.collectives``), with the bytes of each op's per-device
result, as the HLO parser sums result shapes.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM5 80GB, 700 W: datasheet rates, not measured here.
PEAK_FLOPS_BF16 = 989e12          # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12                  # HBM3 bytes/s
ICI_LINK_BW = 450e9               # NVLink 4: 900 GB/s both ways, one way

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

# _c10d_functional op -> the HLO collective it stands for
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
    "isend": "collective-permute",
    "irecv": "collective-permute",
}


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    bytes_by_op: dict

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())


def _nbytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_nbytes(o) for o in out)
    return 0


class _CollectiveCounter(TorchDispatchMode):
    """Counts every ``_c10d_functional`` collective that reaches the local
    tensors (below DTensor), with its per-device result bytes."""

    def __init__(self, stats: CollectiveStats):
        super().__init__()
        self.stats = stats

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "_c10d_functional":
            op = _FUNCTIONAL.get(func._opname)
            if op is not None:
                self.stats.counts[op] += 1
                self.stats.bytes_by_op[op] += _nbytes(out)
        return out


@contextlib.contextmanager
def record_collectives():
    """``with record_collectives() as stats:`` fills ``stats``, a
    ``CollectiveStats`` over ``COLLECTIVE_OPS``, with the collectives the
    block issues and their per-device result bytes."""
    stats = CollectiveStats(counts={op: 0 for op in COLLECTIVE_OPS},
                            bytes_by_op={op: 0 for op in COLLECTIVE_OPS})
    with _CollectiveCounter(stats):
        yield stats


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes_per_chip: float
    collective_counts: dict
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    flops_ratio: float            # MODEL_FLOPS / FLOPs (useful fraction)
    bottleneck: str
    peak_fraction: float          # useful-FLOPs time / bound-time (roofline frac)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline(arch: str, shape: str, mesh_name: str, chips: int,
             cost: dict, coll: CollectiveStats,
             model_flops: float) -> RooflineReport:
    """The reference's ``roofline`` with the collective inventory of
    ``record_collectives`` in place of the HLO text.  ``cost`` holds
    per-device ``"flops"`` and ``"bytes accessed"``."""
    flops = float(cost.get("flops", 0.0))
    byte_keys = [k for k in cost if "bytes accessed" in k]
    hbm_bytes = float(cost.get("bytes accessed", 0.0)) or \
        float(sum(cost[k] for k in byte_keys))

    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = hbm_bytes / HBM_BW
    collective_s = coll.total_bytes / ICI_LINK_BW

    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    useful_s = (model_flops / chips) / PEAK_FLOPS_BF16
    bound = max(terms.values())
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=flops, hlo_bytes=hbm_bytes,
        collective_bytes_per_chip=float(coll.total_bytes),
        collective_counts=coll.counts,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        model_flops=model_flops,
        flops_ratio=(model_flops / chips) / flops if flops else 0.0,
        bottleneck=bottleneck,
        peak_fraction=useful_s / bound if bound else 0.0,
    )


# ---------------------------------------------------------------------------
# MODEL_FLOPS (6ND rule; MoE uses active parameters)
# ---------------------------------------------------------------------------

def model_flops(cfg, shape, n_params: int, n_active_params: int | None = None) -> float:
    """6 * N * D for training; 2 * N * D for a forward-only step.

    decode steps process global_batch tokens (one per row); prefill/train
    process batch*seq tokens.
    """
    n = n_active_params if n_active_params is not None else n_params
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch  # one new token per row
    return 2.0 * n * tokens


def _leaves_with_path(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (str(i),))
    else:
        yield path, tree


def param_shapes(cfg):
    """The port's parameter tree of ``cfg`` as fake tensors: the model's
    own ``init`` under ``FakeTensorMode`` (the counterpart of
    ``jax.eval_shape``), nothing allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.model_zoo import build_model

    with FakeTensorMode():
        return build_model(cfg, device="cpu").init(0)


def count_params(cfg) -> tuple[int, int]:
    """(total, active) parameter counts from the config (no allocation)."""
    flat = list(_leaves_with_path(param_shapes(cfg)))
    total = sum(int(np.prod(leaf.shape)) for _, leaf in flat)
    if not cfg.num_experts:
        return total, total
    # active = total - (routed expert params) * (1 - top_k/E)
    expert_params = 0
    for keys, leaf in flat:
        if "moe" in keys and any(k in ("w_gate", "w_up", "w_down") for k in keys):
            expert_params += int(np.prod(leaf.shape))
    active = total - expert_params * (1 - cfg.top_k / cfg.num_experts)
    return total, int(active)
