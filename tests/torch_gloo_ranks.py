"""Eight gloo ranks on the CPU for the port's distributed checks.

  python tests/torch_gloo_ranks.py <dir>

Imports torch and the port only (no jax).  ``<dir>/inputs.npz`` holds the
int8 all-reduce's input rows; every rank writes ``<dir>/rank<r>.json``:

  * ``allreduce``: ``make_compressed_allreduce`` over the 8-way ``data``
    axis of that input, the replicated mean;
  * ``elastic``: a (4, 2) mesh loses two devices (``degraded_mesh_plan`` to
    (3, 2)), the parameter goes through the host onto ranks 0-5 with its
    model axis sharded, and ``(a @ a.T).sum()`` runs there;
  * ``serve``: a smoke dense model's prefill and 4 ``forward_window`` steps
    on a (2, 4) mesh (params, caches and tokens placed by the sharding
    rules) against the same steps unsharded, once with 4 kv heads (they
    divide the model axis) and once with 2 (the caches fall back to the
    sequence over ``model``), the latter also with a 14-token prompt
    (longer than a rank's 8 cache positions) and steps at 14-17, across
    the boundary of two sequence shards, and once for a smoke MoE model
    (4 experts over ``model``, the routing on every rank), with the
    collectives of each run and the ops' plain calls of both;
  * ``cache_writes``: ``update_kv_cache`` into one layer's (4, 32, 2, 4)
    cache on the (2, 4) mesh, its sequence sharded over ``model`` (8
    positions a rank) and then its kv heads, against the plain function:
    windows longer than a rank's shard, windows that straddle two shards,
    offsets past S - T (clamped), a scalar and per-row offsets; the
    largest difference after any write;
  * ``train``: the loss gradients and one train step (2 microbatches,
    AdamW) of a smoke dense model on the (2, 4) mesh against the unsharded
    ones: the loss, every gradient, every updated parameter.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 8


def _mesh24():
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))


def _serve_case(arch: str, num_kv_heads: int, P: int = 8) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.roofline.analysis import record_collectives

    cfg = get_config(arch).smoke().replace(
        num_heads=8, num_kv_heads=num_kv_heads, head_dim=16)
    model = build_model(cfg, device="cpu")
    B, max_len, steps = 4, 32, 4
    gen = torch.Generator().manual_seed(7)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           dtype=torch.int32)
    windows = torch.randint(0, cfg.vocab_size, (steps, B, 1), generator=gen,
                            dtype=torch.int32)
    pos0 = torch.full((B,), P, dtype=torch.int32)

    def run(params, cache, put):
        logits = []
        with torch.no_grad():
            out, cache, _ = model.prefill(params, put(prompt), cache)
            logits.append(out)
            for t in range(steps):
                out, cache = model.forward_window(params, put(windows[t]),
                                                  cache, put(pos0 + t))
                logits.append(out)
        return [o.full_tensor() if hasattr(o, "full_tensor") else o
                for o in logits]

    ops.reset_counts()
    plain = run(model.init(0), model.init_cache(B, max_len, torch.float32),
                lambda t: t)
    plain_counts = ops.counts()

    mesh = _mesh24()
    params = model.init(0)
    params = shd.distribute_tree(params, shd.param_shardings(mesh, params))
    cache = model.init_cache(B, max_len, torch.float32)
    cache_sh = shd.cache_shardings(mesh, cache, model.CACHE_BATCH_AXES)
    cache = shd.distribute_tree(cache, cache_sh)

    def put(t):
        return shd.distribute_tree(t, shd.batch_shardings(mesh, t))

    ops.reset_counts()
    with shd.use_mesh(mesh), record_collectives() as coll:
        sharded = run(params, cache, put)
    return {
        "cache_spec": list(map(str, cache_sh["k"].spec)),
        "max_abs_err": max(float((a - b).abs().max())
                           for a, b in zip(sharded, plain)),
        "max_abs": max(float(a.abs().max()) for a in plain),
        "collectives": coll.counts,
        "plain_counts": {k: v["plain"] for k, v in plain_counts.items()},
        "sharded_counts": {k: v["plain"] for k, v in ops.counts().items()},
    }


def _cache_writes() -> dict:
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.layers import update_kv_cache

    mesh = _mesh24()
    B, S, KV, D = 4, 32, 2, 4
    gen = torch.Generator().manual_seed(11)
    # (T, offset): T > 8 = S / 4 positions a rank, or T <= 8 across two
    # shards; offsets past S - T land at S - T
    writes = [(12, 0), (12, [3, 20, 0, 30]), (3, [14, 15, 6, 31]),
              (8, [4, 12, 20, 24]), (1, [7, 8, 16, 31]), (20, 5)]
    out = {}
    for name, pl in (("sequence", [Shard(0), Shard(1)]),
                     ("kv heads", [Shard(0), Shard(2)])):
        plain = torch.randn((B, S, KV, D), generator=gen)
        cache = distribute_tensor(plain.clone(), mesh, pl)
        err = 0.0
        for i, (T, off) in enumerate(writes):
            new = torch.randn((B, T, KV, D), generator=gen)
            off = torch.tensor(off, dtype=torch.int32)
            update_kv_cache(plain, new, off)
            if i % 2:           # the window as the model hands it: by row
                new = distribute_tensor(new, mesh, [Shard(0), Replicate()])
            update_kv_cache(cache, new, off)
            err = max(err, float((cache.full_tensor() - plain).abs().max()))
        out[name] = {"max_abs_err": err,
                     "local_positions": cache.to_local().shape[1]}
    return out


def _train_case() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import build_model
    from repro_torch.training import (
        OptimizerConfig,
        init_optimizer,
        make_train_step,
    )
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_loop import value_and_grad

    cfg = get_config("qwen2.5-3b").smoke().replace(num_heads=8,
                                                  num_kv_heads=4)
    model = build_model(cfg, device="cpu")
    ocfg = OptimizerConfig(warmup_steps=1)
    step = make_train_step(model, ocfg, microbatches=2)
    tokens = torch.randint(0, cfg.vocab_size, (4, 16), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(3))
    params = model.init(0)
    _, _, g1 = value_and_grad(model, params, tokens)
    p1, _, m1 = step(params, init_optimizer(ocfg, params), {"tokens": tokens})

    mesh = _mesh24()
    p_sh = shd.param_shardings(mesh, params)
    dparams = shd.distribute_tree(params, p_sh)
    opt = shd.distribute_tree(init_optimizer(ocfg, params),
                              shd.opt_shardings(mesh, p_sh))
    batch = {"tokens": shd.distribute_tree(
        tokens, shd.batch_shardings(mesh, tokens))}
    with shd.use_mesh(mesh):
        _, _, g2 = value_and_grad(model, dparams, batch["tokens"])
        p2, _, m2 = step(dparams, opt, batch)
    return {"loss": float(m1["loss"]),
            "grad_max": max(float(g.abs().max()) for g in tree_leaves(g1)),
            "grad_err": max(float((b.full_tensor() - a).abs().max())
                            for a, b in zip(tree_leaves(g1),
                                            tree_leaves(g2))),
            "loss_err": abs(float(m2["loss"].full_tensor()) - float(m1["loss"])),
            "param_err": max(float((b.full_tensor() - a).abs().max())
                             for a, b in zip(tree_leaves(p1),
                                             tree_leaves(p2))),
            "moved": max(float((a - b).abs().max())
                         for a, b in zip(tree_leaves(p1),
                                         tree_leaves(params)))}


def _elastic() -> dict | None:
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed.fault_tolerance import degraded_mesh_plan

    w = np.arange(48.0, dtype=np.float32).reshape(8, 6)
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    sharded = distribute_tensor(torch.from_numpy(w), mesh,
                                [Shard(0), Shard(1)])
    plan = degraded_mesh_plan((4, 2), ("data", "model"), failed_chips=2,
                              chips_per_host=2)
    # checkpoint-restore path: host roundtrip, then re-place on survivors
    host = sharded.full_tensor().numpy()
    new_mesh = DeviceMesh("cpu", torch.arange(6).reshape(plan.shape),
                          mesh_dim_names=plan.axis_names)
    resharded = distribute_tensor(torch.from_numpy(host), new_mesh,
                                  [Replicate(), Shard(1)])
    y = (resharded @ resharded.T).sum()
    if dist.get_rank() >= 6:
        return {"plan": list(plan.shape), "member": False}
    return {"plan": list(plan.shape), "member": True,
            "local_cols": resharded.to_local().shape[1],
            "value": float(y.full_tensor())}


def _rank(rank: int, out_dir: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.distributed.collectives import make_compressed_allreduce

    torch.set_num_threads(1)
    # a file store in the results directory: no port to race for
    store = os.path.join(os.path.abspath(out_dir), "store")
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    try:
        res = {}
        x = torch.from_numpy(np.load(os.path.join(out_dir, "inputs.npz"))["x"])
        mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
        fn = make_compressed_allreduce(mesh, "data")
        got = fn(distribute_tensor(x, mesh, [Shard(0)]))
        res["allreduce"] = got.to_local().numpy().tolist()
        res["elastic"] = _elastic()
        res["serve"] = {str(kv): _serve_case("qwen2.5-3b", kv)
                        for kv in (4, 2)}
        res["serve"]["2-long"] = _serve_case("qwen2.5-3b", 2, P=14)
        res["cache_writes"] = _cache_writes()
        res["serve"]["moe"] = _serve_case("moonshot-v1-16b-a3b", 4)
        res["train"] = _train_case()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(_rank, args=(sys.argv[1],), nprocs=WORLD, join=True)
