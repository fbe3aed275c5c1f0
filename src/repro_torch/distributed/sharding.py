"""Sharding rules: parameters, optimizer state, caches, and batches.

The port of ``repro.distributed.sharding`` onto DTensor.  Strategy:
  * batch            -> data axes ("pod", "data")
  * attention heads / ffn hidden / vocab / experts -> "model" (TP / EP)
  * parameter d_model dim -> data axes (FSDP / ZeRO) — used for BOTH training
    and inference so 480B-class models fit per-device memory
  * optimizer moments inherit the parameter sharding (elementwise)

A spec is a tuple with one entry per tensor dim: ``None``, an axis name, or
a tuple of axis names (the entries of the reference's ``PartitionSpec``).
``placements`` turns it into DTensor placements, one per mesh dim.  Rules
are resolved against concrete leaf shapes with divisibility fallbacks
(``_fit``), so every assigned architecture traces on every mesh without
bespoke tables.

The port's trees unroll the layer axes into python lists (``bridge``): a
per-layer leaf has as many dims fewer than the reference's stacked leaf as
its path has list indices (two under the hybrid's ``mamba``).
``param_spec`` keys its rules on the stacked rank and returns the
reference's spec of the stacked leaf with those leading layer entries
dropped.  Cache leaves stay stacked (layers, rows, ...), so ``cache_spec``
applies to them as it is.

``use_mesh(mesh)`` is the counterpart of ``with mesh:``.  Inside it,
``logical_constraint`` / ``constrain_attention_scores`` redistribute a
DTensor to the placements the reference's logical names resolve to, and
plain tensors that meet DTensors are taken as replicated (DTensor's
``implicit_replication``: the model code makes its index and mask tensors
at global shapes).  Outside it, and for plain tensors, both return their
input unchanged.  The port has no mesh axis types: every axis is what JAX
calls an Auto axis.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

from repro_torch.kernels import ops as _ops

Params = Any

_ACTIVE: list = []          # the ``use_mesh`` stack


def axis_names(mesh) -> tuple:
    """Axis names of a ``DeviceMesh`` (``mesh_dim_names``) or of any object
    with ``axis_names`` and a ``shape`` dict (the rule tests' fake mesh)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def _axis_len(mesh, name: str) -> int:
    shape = mesh.shape
    if isinstance(shape, dict):
        return shape[name]
    return shape[axis_names(mesh).index(name)]


def data_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= _axis_len(mesh, a)
    return size


def _fit(dim: int, mesh, *candidates):
    """First candidate axis (or axis tuple) that divides ``dim``; None if no
    candidate fits."""
    for cand in candidates:
        if cand is None:
            continue
        if dim % axis_size(mesh, cand) == 0:
            return cand
    return None


def _entry(e):
    """A spec entry as ``PartitionSpec`` keeps it: a one-axis tuple is the
    axis name."""
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def _spec(dims) -> tuple:
    return tuple(_entry(e) for e in dims)


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _layer_axes(path: str) -> int:
    """List indices in a port path: the layer axes the reference stacks."""
    return sum(part.isdigit() for part in path.split("/"))


def param_spec(path: str, shape: tuple, mesh, fsdp: bool = True) -> tuple:
    """Spec of one parameter leaf, keyed on its name and its stacked rank:
    the reference's spec of the stacked leaf, its layer entries dropped."""
    lead = _layer_axes(path)
    return _spec(_stacked_param_spec(path, (1,) * lead + tuple(shape), mesh,
                                     fsdp)[lead:])


def _stacked_param_spec(path: str, shape: tuple, mesh,
                        fsdp: bool = True) -> tuple:
    """The reference's ``param_spec`` rules over a stacked leaf shape."""
    dp = data_axes(mesh) if fsdp else None
    mp = "model"
    name = path.split("/")[-1]
    nd = len(shape)

    def spec(*dims):
        # pad leading stacked-layer axes with None
        lead = nd - len(dims)
        return tuple([None] * lead + list(dims))

    if name == "embed":                      # (V, d)
        # vocab REPLICATED for the lookup gather; d over the data axes.
        return (None, _fit(shape[1], mesh, dp))
    if name in ("unembed",):                 # (d, V)
        return (_fit(shape[0], mesh, dp), _fit(shape[1], mesh, mp))
    if name in ("pos_embed", "enc_pos_embed"):
        return (None, _fit(shape[1], mesh, dp))
    if name in ("wq", "w_gate", "w_up", "in_proj") and nd >= 2:
        if name in ("w_gate", "w_up") and nd == 4:   # MoE (L, E, d, f)
            return (None, _fit(shape[1], mesh, mp),
                    _fit(shape[2], mesh, dp), None)
        return spec(_fit(shape[-2], mesh, dp), _fit(shape[-1], mesh, mp))
    if name in ("wk", "wv"):
        return spec(_fit(shape[-2], mesh, dp), _fit(shape[-1], mesh, mp))
    if name in ("wo", "w_down", "out_proj"):
        if name == "w_down" and nd == 4:             # MoE (L, E, f, d)
            return (None, _fit(shape[1], mesh, mp), None,
                    _fit(shape[3], mesh, dp))
        return spec(_fit(shape[-2], mesh, mp), _fit(shape[-1], mesh, dp))
    if name == "router":                     # (L, d, E)
        return spec(_fit(shape[-2], mesh, dp), None)
    if name == "conv_w":                     # (L, W, C)
        return spec(None, _fit(shape[-1], mesh, mp))
    # norms, biases, A_log, D, dt_bias, conv_b, norm_scale: replicated
    return tuple([None] * nd)


def cache_spec(path: str, shape: tuple, mesh, batch_axis: int) -> tuple:
    """Spec of a serving-cache leaf.

    KV caches (.., B, S, KV, D): batch->data; kv-heads->model when divisible,
    else sequence->model (long-cache fallback, e.g. whisper's 20 heads).
    SSM states (.., B, H, Pdim, N): heads->model, else head-dim->model.
    """
    dp = data_axes(mesh)
    name = path.split("/")[-1]
    nd = len(shape)
    dims = [None] * nd
    if shape[batch_axis] % axis_size(mesh, dp) == 0:
        dims[batch_axis] = dp
    if name in ("k", "v", "dense_k", "dense_v", "cross_k", "cross_v"):
        kv_dim, s_dim = nd - 2, nd - 3
        if shape[kv_dim] % axis_size(mesh, "model") == 0:
            dims[kv_dim] = "model"
        elif shape[s_dim] % axis_size(mesh, "model") == 0:
            dims[s_dim] = "model"
    elif name == "ssm":                      # (.., B, H, P, N)
        h_dim, p_dim = nd - 3, nd - 2
        if shape[h_dim] % axis_size(mesh, "model") == 0:
            dims[h_dim] = "model"
        elif shape[p_dim] % axis_size(mesh, "model") == 0:
            dims[p_dim] = "model"
    elif name == "conv":                     # (.., B, W-1, C)
        if shape[-1] % axis_size(mesh, "model") == 0:
            dims[-1] = "model"
    return _spec(dims)


def batch_spec(shape: tuple, mesh) -> tuple:
    """Input batches: leading batch dim over the data axes when divisible."""
    dp = data_axes(mesh)
    dims = [None] * len(shape)
    if shape[0] % axis_size(mesh, dp) == 0:
        dims[0] = dp
    return _spec(dims)


# ---------------------------------------------------------------------------
# Specs -> DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim: mesh
    dim ``a`` shards tensor dim ``d`` when ``a`` is named in ``spec[d]``,
    and replicates otherwise.  A tensor dim over ("pod", "data") is
    ``Shard(d)`` on both mesh dims, the pod dim major, as in JAX."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in mesh-dim order "
                             f"{names}: DTensor shards major to minor by "
                             "mesh dim")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


# ---------------------------------------------------------------------------
# Tree-level entry points
# ---------------------------------------------------------------------------

def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_shardings(mesh, params_shape: Params, fsdp: bool = True) -> Params:
    """NamedShardings matching a parameter tree (real or fake tensors)."""
    def rule(path, leaf):
        return NamedSharding(mesh, param_spec(_path_str(path), leaf.shape,
                                              mesh, fsdp=fsdp))
    return _map_with_path(rule, params_shape)


def opt_shardings(mesh, param_sh: Params) -> Params:
    """Optimizer state shardings: moments inherit parameter shardings."""
    return {
        "m": param_sh,
        "v": param_sh,
        "step": NamedSharding(mesh, ()),
    }


def cache_shardings(mesh, cache_shape: Params, batch_axes: dict) -> Params:
    def rule(path, leaf):
        key = _path_str(path).split("/")[-1]
        return NamedSharding(mesh, cache_spec(_path_str(path), leaf.shape,
                                              mesh, batch_axes[key]))
    return _map_with_path(rule, cache_shape)


def batch_shardings(mesh, batch_shape: Params) -> Params:
    return _map_with_path(
        lambda _, leaf: NamedSharding(mesh, batch_spec(leaf.shape, mesh)),
        batch_shape)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def distribute_tree(tree: Params, shardings: Params) -> Params:
    """Place every leaf of ``tree`` as a DTensor by the matching sharding.
    Every rank must hold the same whole leaves (made from one seed, or read
    from one checkpoint): each keeps its own shard, with no collective."""
    from torch.distributed.tensor import distribute_tensor

    def place(leaf, sh):
        return distribute_tensor(leaf, sh.mesh, sh.placements,
                                 src_data_rank=None)

    if isinstance(tree, dict):
        return {k: distribute_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute_tree(v, s)
                          for v, s in zip(tree, shardings))
    return place(tree, shardings)


def local_bytes(tree: Params) -> int:
    """Bytes of the local shards of a tree's leaves on this rank (the whole
    tensor for a plain leaf)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    t = tree.to_local() if isinstance(tree, DTensor) else tree
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# In-model logical sharding constraints
# ---------------------------------------------------------------------------

_LOGICAL_AXES = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "heads": ("model",),
    "experts": ("model",),
    "dmodel": ("data",),
    "seq": ("model",),
}


@contextlib.contextmanager
def use_mesh(mesh):
    """The counterpart of ``with mesh:``: makes ``mesh`` the active mesh of
    the logical constraints, and lets plain tensors meet DTensors as
    replicated values."""
    from torch.distributed.tensor.experimental import implicit_replication

    _ACTIVE.append(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _ACTIVE.pop()


def active_mesh():
    """The mesh of the innermost ``use_mesh``, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _resolve(mesh, dim_size, name):
    """Mesh axes for a logical name if they exist and divide dim_size."""
    if name is None:
        return None
    axes = tuple(a for a in _LOGICAL_AXES[name] if a in axis_names(mesh))
    if not axes:
        return None
    size = 1
    for a in axes:
        size *= _axis_len(mesh, a)
    return axes if dim_size % size == 0 else None


def _constrain(x, dims):
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    target = placements(tuple(dims), x.device_mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


def shards_dividing(x, dim: int, size: int):
    """``x`` ready to split its dim ``dim`` into (``size``, rest): a DTensor
    whose shards of that dim do not divide ``size`` is replicated over the
    mesh dims that shard it (e.g. q's flattened heads sharded 16 ways over
    ``model`` when the model has fewer heads); anything else unchanged."""
    if not _ops._is_dtensor(x):     # the plain hot path: no import
        return x
    from torch.distributed.tensor import Replicate, Shard

    dim = dim % x.dim()
    pl = tuple(x.placements)
    mesh = x.device_mesh
    ways = 1
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == dim:
            ways *= mesh.size(i)
    if size % ways == 0:
        return x
    target = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim
                   else p for p in pl)
    return x.redistribute(mesh, target)


def logical_constraint(x, *logical):
    """Redistribute a DTensor ``x`` by LOGICAL axis names; ``x`` unchanged
    when it is a plain tensor, when no ``use_mesh`` is active, or on the
    dims whose named axes don't exist/divide."""
    mesh = active_mesh()
    if mesh is None:
        return x
    dims = [_resolve(mesh, d, n) for d, n in zip(x.shape, logical)]
    return _constrain(x, dims + [None] * (x.dim() - len(dims)))


def attention_score_spec(mesh, shape) -> list:
    """Spec of a (B, KV, G, Sq, Skv) score tensor: batch -> data axes;
    kv-heads -> model when divisible, else query-heads (archs whose head
    counts don't divide the TP ways, e.g. whisper's 20 or arctic's 8x7)."""
    B, KV, G, Sq, Skv = shape
    dims = [_resolve(mesh, B, "batch"), None, None, None, None]
    if _resolve(mesh, KV, "heads"):
        dims[1] = _resolve(mesh, KV, "heads")
    elif _resolve(mesh, G, "heads"):
        dims[2] = _resolve(mesh, G, "heads")
    return dims


def constrain_attention_scores(logits):
    """Redistribute a DTensor score tensor to ``attention_score_spec``;
    unchanged outside ``use_mesh`` or when plain (inside the local map of
    ``layers.gqa_attention``, whose placements are that spec)."""
    mesh = active_mesh()
    if mesh is None:
        return logits
    return _constrain(logits, attention_score_spec(mesh, logits.shape))
