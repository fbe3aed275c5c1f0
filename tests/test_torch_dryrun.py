"""The port's dry run (``repro_torch.launch.dryrun``) on smoke configs.

A smoke config is registered under an assigned arch name, as the
reference's ``probe_costs`` registers its probes, and its cells are traced
on the fake 256-rank (and 512-rank) group: each must come out ``ok``, with
the per-device argument bytes that the reference's sharding rules give the
same leaves.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro_torch.configs.base as tbase
from repro.configs.base import ModelConfig as JModelConfig
from repro.distributed import sharding as jshd
from repro.models import build_model as jbuild_model
from repro.training import OptimizerConfig as JOptimizerConfig
from repro.training import init_optimizer as jinit_optimizer
from repro_torch.configs import get_config
from repro_torch.launch import dryrun

ARCH = "qwen2.5-3b"


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


@pytest.fixture
def smoke_arch(monkeypatch):
    """The smoke config of ``ARCH`` registered under its name."""
    monkeypatch.setitem(tbase._REGISTRY, ARCH,
                        get_config(ARCH).smoke().replace(name=ARCH))
    return ARCH


def _shard_bytes(leaf, spec) -> int:
    ways = int(np.prod([jshd.axis_size(FakeMesh, s) for s in spec]))
    return int(np.prod(leaf.shape)) // ways * leaf.dtype.itemsize


def _tree_bytes(tree, rule) -> int:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return sum(_shard_bytes(leaf, rule(jshd._path_str(p), leaf))
               for p, leaf in flat)


def _reference_argument_bytes(arch: str, shape_name: str) -> int:
    """Per-device bytes of the cell's arguments under the reference's rules,
    over the reference's own ``eval_shape`` trees of the same config."""
    from repro.configs.base import SHAPES

    shape = SHAPES[shape_name]
    training = shape.kind == "train"
    cfg = JModelConfig(**dataclasses.asdict(
        dryrun._cfg_for_dryrun(arch, training)))
    model = jbuild_model(cfg)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    mesh = FakeMesh

    def param_rule(path, leaf):
        return jshd.param_spec(path, leaf.shape, mesh)

    total = _tree_bytes(params, param_rule)
    batch = {"tokens": jax.ShapeDtypeStruct(
        (shape.global_batch, shape.seq_len if training else 1), jnp.int32)}
    if training:
        opt = jax.eval_shape(lambda: jinit_optimizer(JOptimizerConfig(),
                                                     params))
        total += _tree_bytes({"m": opt["m"], "v": opt["v"]},
                             lambda p, leaf: param_rule(p.split("/", 1)[1],
                                                        leaf))
        total += opt["step"].dtype.itemsize
    else:
        batch["pos"] = jax.ShapeDtypeStruct((shape.global_batch,), jnp.int32)
        cache = jax.eval_shape(lambda: model.init_cache(
            shape.global_batch, shape.seq_len, jnp.bfloat16))
        total += _tree_bytes(cache, lambda p, leaf: jshd.cache_spec(
            p, leaf.shape, mesh, model.CACHE_BATCH_AXES[p.split("/")[-1]]))
    total += _tree_bytes(batch, lambda p, leaf: jshd.batch_spec(leaf.shape,
                                                                mesh))
    return total


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_smoke_cell_traces_with_the_reference_rules_bytes(smoke_arch, shape,
                                                          tmp_path):
    res = dryrun.run_cell(smoke_arch, shape, False, force=True,
                          results_dir=str(tmp_path))
    assert res["status"] == "ok", res.get("traceback")
    assert res["mesh"] == "pod16x16" and res["chips"] == 256
    mem = res["memory_analysis"]
    assert mem["argument_size_in_bytes"] == _reference_argument_bytes(
        smoke_arch, shape)
    assert mem["traced_peak_temp_bytes"] > 0
    assert res["traced_flops_global_dtensor_ops"] > 0
    assert res["traced_flops_per_device"] > 0
    assert res["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")
    assert sum(res["collective_counts"].values()) > 0
    saved = json.loads((tmp_path / f"{smoke_arch}__{shape}__pod16x16.json")
                       .read_text())
    assert saved["status"] == "ok"


def test_single_then_multi_pod_cell_in_one_process(smoke_arch, tmp_path):
    """Each cell sets up and destroys its own fake group: a 256-rank cell,
    then a 512-rank cell, in one process; a cached cell is read back."""
    one = dryrun.run_cell(smoke_arch, "decode_32k", False, force=True,
                          results_dir=str(tmp_path))
    two = dryrun.run_cell(smoke_arch, "decode_32k", True, force=True,
                          results_dir=str(tmp_path))
    assert one["status"] == two["status"] == "ok"
    assert two["mesh"] == "pod2x16x16" and two["chips"] == 512
    # twice the data ways: the batch-sharded cache halves per device
    assert two["memory_analysis"]["argument_size_in_bytes"] < \
        one["memory_analysis"]["argument_size_in_bytes"]
    again = dryrun.run_cell(smoke_arch, "decode_32k", True,
                            results_dir=str(tmp_path))
    assert again == json.loads(json.dumps(two, default=str))


def test_failing_cell_is_recorded_and_the_cli_exits_non_zero(
        smoke_arch, tmp_path, monkeypatch, capsys):
    def broken(*args, **kw):
        raise RuntimeError("no strategy")

    monkeypatch.setattr(dryrun, "trace_cell", broken)
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    rc = dryrun.main(["--arch", smoke_arch, "--shape", "decode_32k",
                      "--mesh", "single", "--force"])
    assert rc == 1
    assert "0/1 cells OK" in capsys.readouterr().out
    saved = json.loads((tmp_path / f"{smoke_arch}__decode_32k__pod16x16.json")
                       .read_text())
    assert saved["status"] == "error"
    assert saved["error"] == "RuntimeError: no strategy"
    assert "Traceback" in saved["traceback"]


def test_ops_take_dtensors_through_local_maps_and_paged_ops_refuse():
    """On a fake (2, 2) group: ``ops.decode_attention`` keeps rows over
    ``data`` and heads over ``model`` when the kv heads divide it (no
    collective), runs whole over ``model`` when they do not, and equals
    the plain op on each rank's shard; the paged ops refuse a DTensor."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import ops
    from repro_torch.roofline.analysis import record_collectives

    g = torch.Generator().manual_seed(0)
    with dryrun.fake_group(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        for kv, heads_split in ((2, True), (1, False)):
            q = torch.randn(4, 4, 16, generator=g)
            k = torch.randn(4, 8, kv, 16, generator=g)
            v = torch.randn(4, 8, kv, 16, generator=g)
            lengths = torch.tensor([8, 3, 5, 1], dtype=torch.int32)
            h = Shard(1) if heads_split else Replicate()
            put = [distribute_tensor(t, mesh, pl, src_data_rank=None)
                   for t, pl in ((q, [Shard(0), h]),
                                 (k, [Shard(0), Shard(2) if heads_split
                                      else Replicate()]),
                                 (v, [Shard(0), Shard(2) if heads_split
                                      else Replicate()]),
                                 (lengths, [Shard(0), Replicate()]))]
            with record_collectives() as coll:
                out = ops.decode_attention(*put)
            assert tuple(out.placements) == (Shard(0), h)
            assert sum(coll.counts.values()) == 0
            # rank 0 holds rows 0-1 and, split, heads 0-1 (kv head 0)
            hs = slice(0, 2) if heads_split else slice(None)
            ks = slice(0, 1) if heads_split else slice(None)
            want = ops.decode_attention(q[:2, hs], k[:2, :, ks], v[:2, :, ks],
                                        lengths[:2])
            assert torch.equal(out.to_local(), want)
        with pytest.raises(TypeError, match="takes no DTensor"):
            ops.paged_attention(put[0][:, None], put[1], put[2],
                                torch.zeros((4, 1), dtype=torch.int32),
                                lengths)
