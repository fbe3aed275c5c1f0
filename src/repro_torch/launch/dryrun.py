"""Multi-pod dry run: trace every (arch x shape x mesh) cell on fake tensors.

The port of ``repro.launch.dryrun``.  Where the reference lowers and
compiles each cell's step from ``ShapeDtypeStruct``s under the production
mesh, the port traces it: a fake process group of the mesh's size
(``torch.distributed`` backend "fake", this process rank 0) under a "cpu"
``DeviceMesh`` with the production shape and names, parameters, optimizer
state, caches and inputs placed as DTensors by the repo's sharding rules,
and the step (``train_step`` / the prefill / the serve step) run eagerly
under ``FakeTensorMode`` and ``use_mesh``: every op runs its sharding
propagation, every redistribution its collective, on tensors that carry
shapes and no data, so nothing is allocated.

Per cell it records:
  * ``memory_analysis.argument_size_in_bytes``: the local shard bytes of
    the step's arguments on one device (params, optimizer state, caches,
    inputs), as XLA's ``memory_analysis`` counts them;
  * ``memory_analysis.traced_peak_temp_bytes``: the peak of the storages
    the step allocates on that device above its arguments, counted op by
    op on the local shards (the counterpart of ``temp_size_in_bytes``);
  * ``collective_counts`` / ``collective_bytes_by_op``: the collectives the
    step issues and their per-device result bytes
    (``roofline.analysis.record_collectives``);
  * ``traced_flops_per_device``: FLOPs of the matmul-class ops (torch's
    ``FlopCounterMode`` table) that ran on rank 0's shards, the local maps
    included; ``traced_flops_global_dtensor_ops``: the same count over the
    DTensor-level ops at their global shapes, which leaves out what runs
    inside a local map (the attention cores, the MoE routing);
  * ``roofline``: the analytic terms of ``roofline.analytic`` (datasheet
    rates, not measurements).
Fake tensors carry no data for a kernel, so the ops of ``kernels/ops.py``
run their plain versions on the CPU route: the traced FLOPs and bytes are
the ``flash=False`` baseline, as the reference's analytic default.

The reference's ``probe_pair`` / ``probe_costs`` are not ported: they
correct XLA's cost analysis, which counts a scanned layer body once; the
eager trace runs every layer, so there is no loop body to scale.

Results are cached per cell in experiments/dryrun_torch/<arch>__<shape>__
<mesh>.json so interrupted sweeps resume where they stopped.  A failing
cell is recorded with ``"status": "error"`` and its traceback; the command
exits non-zero when any requested cell failed.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
      --shape decode_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
import weakref

import torch

from repro_torch.configs import (
    ASSIGNED_ARCHS,
    SHAPES,
    applicable_shapes,
    get_config,
)
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model, has_prefix_embeds, input_specs
from repro_torch.models.model_zoo import prefix_len
from repro_torch.roofline.analysis import (
    count_params,
    model_flops,
    record_collectives,
)
from repro_torch.training.optimizer import tree_leaves

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")

TRAIN_MICROBATCHES = 4
# arctic-480b: deep microbatching is the only way to approach fit
ARCH_MICROBATCHES = {"arctic-480b": 16}


VOCAB_PAD = 2048  # 128 lanes x 16-way tensor parallelism


def _cfg_for_dryrun(arch: str, training: bool):
    cfg = get_config(arch)
    # pad vocab so the "vocab" logical axis shards over model (MaxText-style);
    # logits shrink 16x per device and the embedding-grad transpose stays local.
    padded_vocab = -(-cfg.vocab_size // VOCAB_PAD) * VOCAB_PAD
    return cfg.replace(param_dtype="bfloat16", compute_dtype="bfloat16",
                       remat=training, vocab_size=padded_vocab)


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0,
    destroyed on exit: collectives return tensors of the right shapes and
    move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group; "
                           "this process already has one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


class _StepProbe:
    """Per-device live bytes and FLOPs of a traced step, op by op.

    A dispatch mode sees each DTensor op (global shapes) and then the ops
    DTensor runs on rank 0's local shards.  Local outputs whose storage is
    new are counted live until the storage dies; storages of the arguments
    are seeded as seen, so the peak is the temporaries' above them."""

    def __init__(self, args):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import FlopCounterMode

        probe = self
        self.live = self.peak = 0
        self.flops_global = self.flops_local = 0
        self._seen = {}
        for leaf in tree_leaves(args):
            t = leaf.to_local() if isinstance(leaf, DTensor) else leaf
            self._seen[id(t.untyped_storage())] = None
        registry = FlopCounterMode(display=False).flop_registry

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                packet = func.overloadpacket
                is_global = any(issubclass(t, DTensor) for t in types)
                if packet in registry:
                    n = registry[packet](*args, **kwargs, out_val=out)
                    if is_global:
                        probe.flops_global += n
                    else:
                        probe.flops_local += n
                if not is_global:
                    probe._track(out)
                return out

        self.mode = Mode()

    def _track(self, out):
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            self._seen[key] = weakref.finalize(st, self._free, key, n)

    def _free(self, key, n):
        self.live -= n
        self._seen.pop(key, None)


def _fake_like(meta: torch.Tensor) -> torch.Tensor:
    """A zero tensor of a meta stand-in's shape and dtype (inside
    ``FakeTensorMode``: a fake tensor)."""
    return torch.zeros(meta.shape, dtype=meta.dtype)


def trace_cell(arch: str, shape_name: str, multi_pod: bool,
               microbatches: int | None = None, fsdp: bool = True,
               moe_capacity: float | None = None, draft_window: int = 0,
               cache_dtype=None):
    """Trace one dry-run cell's step; must run inside ``fake_group`` of the
    mesh's size.  Returns (meta, cfg, shape, measures)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.training import (
        OptimizerConfig,
        init_optimizer,
        make_train_step,
    )

    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    training = shape.kind == "train"
    cfg = _cfg_for_dryrun(arch, training)
    model = build_model(cfg, device="cpu")
    mb = microbatches or ARCH_MICROBATCHES.get(arch, TRAIN_MICROBATCHES)

    with FakeTensorMode(allow_non_fake_inputs=True):
        params = model.init(0)
        p_sh = shd.param_shardings(mesh, params, fsdp=fsdp)
        specs = input_specs(cfg, shape, draft_window=draft_window)
        batch = shd.distribute_tree({k: _fake_like(v)
                                     for k, v in specs.items()},
                                    shd.batch_shardings(mesh, specs))
        if training:
            ocfg = OptimizerConfig(
                state_dtype="bfloat16" if arch == "arctic-480b" else "float32")
            opt = shd.distribute_tree(init_optimizer(ocfg, params),
                                      shd.opt_shardings(mesh, p_sh))
            params = shd.distribute_tree(params, p_sh)
            step = make_train_step(model, ocfg, microbatches=mb,
                                   has_prefix=has_prefix_embeds(cfg))
            args = (params, opt, batch)

            def run():
                return step(params, opt, batch)
        else:
            params = shd.distribute_tree(params, p_sh)
            max_len = shape.seq_len + prefix_len(cfg)
            cdt = cache_dtype or torch.bfloat16
            cache = model.init_cache(shape.global_batch, max_len, cdt)
            cache = shd.distribute_tree(
                cache, shd.cache_shardings(mesh, cache,
                                           model.CACHE_BATCH_AXES))
            args = (params, batch, cache)
            if shape.kind == "prefill":
                cap = moe_capacity if moe_capacity is not None else \
                    (cfg.capacity_factor if cfg.num_experts else None)

                def run():
                    kw = {"moe_capacity": cap} if cfg.num_experts else {}
                    logits, new_cache, _ = model.prefill(
                        params, batch["tokens"], cache,
                        prefix_embeds=batch.get("prefix_embeds"), **kw)
                    # the last-position logits only (sampling seed)
                    return logits[:, -1], new_cache
            else:
                def run():
                    return model.forward_window(params, batch["tokens"], cache,
                                                batch["pos"])

        probe = _StepProbe(args)
        t0 = time.time()
        with torch.no_grad() if not training else contextlib.nullcontext(), \
                shd.use_mesh(mesh), record_collectives() as coll, probe.mode:
            out = run()
        trace_s = time.time() - t0
        del out
        measures = {
            "trace_s": trace_s,
            "argument_size_in_bytes": shd.local_bytes(args),
            "traced_peak_temp_bytes": probe.peak,
            "traced_flops_global": probe.flops_global,
            "traced_flops_per_device": probe.flops_local,
            "collectives": coll,
        }
    meta = {"arch": arch, "shape": shape_name,
            "mesh": "pod2x16x16" if multi_pod else "pod16x16",
            "chips": 512 if multi_pod else 256,
            "fsdp": fsdp, "microbatches": microbatches}
    return meta, cfg, shape, measures


def run_cell(arch: str, shape_name: str, multi_pod: bool, force: bool = False,
             results_dir: str | None = None, **kw) -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    results_dir = results_dir or RESULTS_DIR
    os.makedirs(results_dir, exist_ok=True)
    out_path = os.path.join(results_dir,
                            f"{arch}__{shape_name}__{mesh_name}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "status": "error"}
    try:
        with fake_group(512 if multi_pod else 256):
            meta, cfg, shape, m = trace_cell(arch, shape_name, multi_pod, **kw)
        total, active = count_params(get_config(arch))
        mflops = model_flops(cfg, shape, total, active)

        # analytic roofline terms (closed forms over the same configs and
        # rules; datasheet rates of the card, not measurements)
        from repro_torch.roofline.analytic import (
            MeshInfo,
            roofline_terms,
            summarize,
        )
        mesh_info = MeshInfo(chips=meta["chips"],
                             dp=meta["chips"] // 16, mp=16)
        tb = roofline_terms(cfg, shape, mesh_info,
                            flash=kw.get("flash", False),
                            microbatches=kw.get("microbatches")
                            or ARCH_MICROBATCHES.get(arch, TRAIN_MICROBATCHES),
                            fsdp=kw.get("fsdp", True))
        rf = summarize(tb, mflops, meta["chips"])
        rf.update(arch=arch, shape=shape_name, mesh=mesh_name,
                  chips=meta["chips"])
        coll = m["collectives"]
        result = {
            **meta,
            "status": "ok",
            "trace_s": round(m["trace_s"], 1),
            "params_total": total,
            "params_active": active,
            "memory_analysis": {
                "argument_size_in_bytes": m["argument_size_in_bytes"],
                "traced_peak_temp_bytes": m["traced_peak_temp_bytes"],
            },
            "traced_flops_global_dtensor_ops": m["traced_flops_global"],
            "traced_flops_per_device": m["traced_flops_per_device"],
            "collective_counts": coll.counts,
            "collective_bytes_by_op": coll.bytes_by_op,
            "roofline": rf,
        }
    except Exception as e:  # noqa: BLE001 — a failing cell is a recorded bug
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-2000:]
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2, default=str)
    return result


def all_cells():
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape_name in applicable_shapes(cfg):
            for multi_pod in (False, True):
                yield arch, shape_name, multi_pod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        cells = list(all_cells())
    else:
        archs = [args.arch] if args.arch else ASSIGNED_ARCHS
        meshes = {"single": [False], "multi": [True],
                  "both": [False, True]}[args.mesh]
        cells = []
        for arch in archs:
            shapes = ([args.shape] if args.shape
                      else applicable_shapes(get_config(arch)))
            for s in shapes:
                for m in meshes:
                    cells.append((arch, s, m))

    n_ok = 0
    for arch, shape_name, multi_pod in cells:
        res = run_cell(arch, shape_name, multi_pod, force=args.force)
        ok = res.get("status") == "ok"
        n_ok += ok
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
        if ok:
            r = res["roofline"]
            print(f"[OK ] {arch:22s} {shape_name:12s} {mesh_name:10s} "
                  f"trace={res['trace_s']:>6.1f}s "
                  f"bottleneck={r['bottleneck']:10s} "
                  f"frac={r['peak_fraction']:.3f} "
                  f"terms(c/m/n)={r['compute_s']:.2e}/{r['memory_s']:.2e}/"
                  f"{r['collective_s']:.2e}")
            mem = res["memory_analysis"]
            print(f"      temp={mem['traced_peak_temp_bytes']/1e9:.1f}GB "
                  f"args={mem['argument_size_in_bytes']/1e9:.2f}GB")
        else:
            print(f"[ERR] {arch:22s} {shape_name:12s} {mesh_name:10s} "
                  f"{res.get('error', '?')}")
    print(f"\n{n_ok}/{len(cells)} cells OK")
    return 0 if n_ok == len(cells) else 1


if __name__ == "__main__":
    sys.exit(main())
