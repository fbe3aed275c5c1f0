"""The port's distributed runtime against the JAX package (ROADMAP A17).

Sharding rules on every registered architecture (a per-layer leaf of the
port's unrolled trees gets the reference's spec of the stacked leaf, its
layer entries dropped), the dry run's shapes, parameter counts and
analytic roofline terms, the gradient-compression arithmetic, and one
spawn of eight gloo ranks (``tests/torch_gloo_ranks.py``) for what only
several processes show: the int8 all-reduce, the elastic 8 -> 6 reshard,
and the sharded smoke prefill + decode (dense and MoE) and train step
against the unsharded port.
"""

import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS, applicable_shapes
from repro.configs import get_config as jget_config
from repro.configs import list_architectures
from repro.configs.base import SHAPES as JSHAPES
from repro.distributed import collectives as jcoll
from repro.distributed import sharding as jshd
from repro.models import build_model as jbuild_model
from repro.models import input_specs as jinput_specs
from repro.models.model_zoo import cache_specs as jcache_specs
from repro.roofline import analysis as janalysis
from repro.roofline import analytic as janalytic
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.distributed import collectives as tcoll
from repro_torch.distributed import sharding as tshd
from repro_torch.models import build_model, cache_specs, input_specs
from repro_torch.roofline import analysis as tanalysis
from repro_torch.roofline import analytic as tanalytic

ROOT = Path(__file__).resolve().parents[1]


class FakeMesh:
    """The rule functions read only axis names and sizes."""

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


MESHES = {"pod2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16}),
          "pod16x16": FakeMesh({"data": 16, "model": 16})}


def _jpath(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, path + (i,))
    else:
        yield path, tree


@functools.cache
def _ref_param_shapes(arch: str) -> dict:
    model = jbuild_model(jget_config(arch))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    return {_jpath(p): tuple(leaf.shape)
            for p, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}


@functools.cache
def _port_param_shapes(arch: str) -> tuple:
    return tuple((path, tuple(leaf.shape)) for path, leaf in
                 _port_leaves(tanalysis.param_shapes(get_config(arch))))


def _ref_spec(spec, rank: int) -> tuple:
    spec = tuple(spec)
    return spec + (None,) * (rank - len(spec))


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", list_architectures())
def test_param_specs_are_the_references_with_layer_axes_dropped(arch,
                                                               mesh_name):
    mesh = MESHES[mesh_name]
    ref = _ref_param_shapes(arch)
    seen = set()
    for path, shape in _port_param_shapes(arch):
        lead = sum(isinstance(p, int) for p in path)
        jp = "/".join(str(p) for p in path if not isinstance(p, int))
        seen.add(jp)
        assert ref[jp][lead:] == shape, (jp, ref[jp], shape)
        port = tshd.param_spec("/".join(map(str, path)), shape, mesh)
        want = _ref_spec(jshd.param_spec(jp, ref[jp], mesh), len(ref[jp]))
        assert port == want[lead:], (jp, port, want)
    assert seen == set(ref)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", list_architectures())
def test_cache_specs_equal_the_references(arch, mesh_name):
    from torch._subclasses.fake_tensor import FakeTensorMode

    mesh = MESHES[mesh_name]
    jcfg, cfg = jget_config(arch), get_config(arch)
    jmodel = jbuild_model(jcfg)
    for batch, max_len in ((128, 4096), (8, 1000)):
        ref = jax.eval_shape(lambda: jmodel.init_cache(batch, max_len,
                                                       jnp.bfloat16))
        with FakeTensorMode():
            model = build_model(cfg, device="cpu")
            port = model.init_cache(batch, max_len, torch.bfloat16)
        assert model.CACHE_BATCH_AXES == jmodel.CACHE_BATCH_AXES
        assert sorted(port) == sorted(ref)
        for key, leaf in port.items():
            shape = tuple(leaf.shape)
            assert shape == tuple(ref[key].shape), key
            axis = model.CACHE_BATCH_AXES[key]
            assert tshd.cache_spec(key, shape, mesh, axis) == _ref_spec(
                jshd.cache_spec(key, shape, mesh, axis), len(shape)), key


@pytest.mark.parametrize("shape", [(256, 4096), (30, 7), (32,)])
def test_batch_spec_equals_the_references(shape):
    for mesh in MESHES.values():
        assert tshd.batch_spec(shape, mesh) == _ref_spec(
            jshd.batch_spec(shape, mesh), len(shape))


def _ways(spec, mesh) -> int:
    return int(np.prod([tshd.axis_size(mesh, s) for s in spec]))


def test_arctic_per_chip_param_bytes_equal_the_reference_rules():
    mesh = MESHES["pod2x16x16"]
    ref = _ref_param_shapes("arctic-480b")
    want = sum(np.prod(s) // _ways(jshd.param_spec(p, s, mesh), mesh)
               for p, s in ref.items())
    got = sum(np.prod(s) // _ways(tshd.param_spec(
        "/".join(map(str, p)), s, mesh), mesh)
        for p, s in _port_param_shapes("arctic-480b"))
    assert got == want
    assert got * 6 < 16e9        # bf16 params + bf16 moments, as the reference


def test_placements_shard_pod_major_and_refuse_other_orders():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh3:
        mesh_dim_names = ("pod", "data", "model")
    assert tshd.placements((("pod", "data"), "model"), Mesh3()) == (
        Shard(0), Shard(0), Shard(1))
    assert tshd.placements((None, "data"), Mesh3()) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh-dim order"):
        tshd.placements((("data", "pod"),), Mesh3())


def test_constraints_pass_plain_tensors_and_need_an_active_mesh():
    x = torch.randn(4, 3, 8)
    assert tshd.logical_constraint(x, "batch", None, "vocab") is x
    scores = torch.randn(2, 2, 1, 3, 3)
    assert tshd.constrain_attention_scores(scores) is scores
    assert tshd.active_mesh() is None
    mesh = MESHES["pod16x16"]
    # the reference's score rule: kv heads over model, else query groups
    assert tshd.attention_score_spec(mesh, (32, 16, 2, 8, 8)) == [
        ("data",), ("model",), None, None, None]
    assert tshd.attention_score_spec(mesh, (32, 2, 16, 8, 8)) == [
        ("data",), None, ("model",), None, None]
    assert tshd.attention_score_spec(mesh, (8, 8, 7, 8, 8)) == [
        None, None, None, None, None]


# ---------------------------------------------------------------------------
# Shapes, counts and the analytic roofline
# ---------------------------------------------------------------------------

def _dt(x) -> str:
    return str(x.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_input_and_cache_specs_equal_the_references(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    for shape in applicable_shapes(jcfg):
        ref, port = jinput_specs(jcfg, shape), input_specs(cfg, shape)
        assert sorted(port) == sorted(ref), shape
        for k, v in port.items():
            assert v.device.type == "meta"
            assert (tuple(v.shape), _dt(v)) == (tuple(ref[k].shape),
                                                _dt(ref[k])), (shape, k)
        if JSHAPES[shape].kind == "decode":
            ref, port = jcache_specs(jcfg, shape), cache_specs(cfg, shape)
            assert sorted(port) == sorted(ref), shape
            for k, v in port.items():
                assert v.device.type == "meta"
                assert (tuple(v.shape), _dt(v)) == (tuple(ref[k].shape),
                                                    _dt(ref[k])), (shape, k)


@pytest.mark.parametrize("arch,smoke", [
    ("qwen2.5-3b", True), ("mamba2-130m", True),
    ("moonshot-v1-16b-a3b", True), ("arctic-480b", False),
    ("deepseek-7b", False)])
def test_count_params_equals_the_reference(arch, smoke):
    jcfg, cfg = jget_config(arch), get_config(arch)
    if smoke:
        jcfg, cfg = jcfg.smoke(), cfg.smoke()
    assert tanalysis.count_params(cfg) == janalysis.count_params(jcfg)


def test_model_flops_and_roofline_keep_the_references_arithmetic():
    cfg, jcfg = get_config("qwen2.5-3b"), jget_config("qwen2.5-3b")
    for name in SHAPES:
        assert tanalysis.model_flops(cfg, SHAPES[name], 3e9, 1e9) == \
            janalysis.model_flops(jcfg, JSHAPES[name], 3e9, 1e9)
    coll = tanalysis.CollectiveStats(
        counts={op: 1 for op in tanalysis.COLLECTIVE_OPS},
        bytes_by_op={op: 2 ** 20 for op in tanalysis.COLLECTIVE_OPS})
    rep = tanalysis.roofline("a", "s", "m", 256, {"flops": 1e15,
                                                  "bytes accessed": 1e12},
                             coll, 1e17)
    assert rep.compute_s == 1e15 / tanalysis.PEAK_FLOPS_BF16
    assert rep.collective_s == 5 * 2 ** 20 / tanalysis.ICI_LINK_BW
    assert rep.bottleneck == max(("compute", rep.compute_s),
                                 ("memory", rep.memory_s),
                                 ("collective", rep.collective_s),
                                 key=lambda t: t[1])[0]


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_analytic_terms_equal_the_references(shape, monkeypatch):
    # count_params is pure in the config: memoise it on both sides
    monkeypatch.setattr(janalysis, "count_params",
                        functools.cache(janalysis.count_params))
    monkeypatch.setattr(tanalysis, "count_params",
                        functools.cache(tanalysis.count_params))
    for arch in ASSIGNED_ARCHS:
        for chips, dp in ((256, 16), (512, 32)):
            ref = janalytic.roofline_terms(
                jget_config(arch), JSHAPES[shape],
                janalytic.MeshInfo(chips=chips, dp=dp, mp=16))
            got = tanalytic.roofline_terms(
                get_config(arch), SHAPES[shape],
                tanalytic.MeshInfo(chips=chips, dp=dp, mp=16))
            assert (got.flops, got.hbm_bytes, got.coll_bytes) == \
                (ref.flops, ref.hbm_bytes, ref.coll_bytes), (arch, chips)
            assert got.detail == ref.detail


# ---------------------------------------------------------------------------
# Gradient compression
# ---------------------------------------------------------------------------

def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_topk_and_int8_match_the_reference():
    x = _normal(0, (64, 32))
    jidx, jvals, jres = jcoll.topk_compress(jnp.asarray(x), 0.1)
    idx, vals, res = tcoll.topk_compress(torch.from_numpy(x), 0.1)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
    np.testing.assert_array_equal(
        tcoll.topk_decompress(idx, vals, x.shape).numpy(),
        np.asarray(jcoll.topk_decompress(jidx, jvals, x.shape)))

    y = _normal(2, (4096,))
    jq, js = jcoll.quantize_int8(jnp.asarray(y))
    q, s = tcoll.quantize_int8(torch.from_numpy(y))
    assert q.dtype == torch.int8 and float(s) == float(js)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tcoll.dequantize_int8(q, s).numpy(),
                                  np.asarray(jcoll.dequantize_int8(jq, js)))


def test_error_feedback_steps_match_the_reference():
    """200 steps of top-k with error feedback on a constant gradient: the
    residuals, every compressed payload and the transmitted sum equal the
    reference's bit for bit."""
    g = _normal(1, (256,))
    jg, tg = {"w": jnp.asarray(g)}, {"w": torch.from_numpy(g)}
    jef, tef = jcoll.init_error_feedback(jg), tcoll.init_error_feedback(tg)
    jtot, ttot = np.zeros(256, np.float32), np.zeros(256, np.float32)
    for _ in range(200):
        jcomp, jef, jeff = jcoll.compress_gradients_topk(jg, jef, 0.05)
        tcomp, tef, teff = tcoll.compress_gradients_topk(tg, tef, 0.05)
        np.testing.assert_array_equal(tcomp[0][0].numpy(),
                                      np.asarray(jcomp[0][0]))
        np.testing.assert_array_equal(tef["w"].numpy(), np.asarray(jef["w"]))
        jtot += np.asarray(jeff["w"])
        ttot += teff["w"].numpy()
    np.testing.assert_array_equal(ttot, jtot)
    assert tcoll.compression_ratio(tcomp) == jcoll.compression_ratio(jcomp)


def _ref_psum_rows(x: np.ndarray) -> np.ndarray:
    """The reference's ``compressed_psum_int8`` over the rows of ``x``, one
    participant a row, under ``jax.vmap`` (pmax / psum over the mapped
    axis)."""
    return np.asarray(jax.vmap(lambda v: jcoll.compressed_psum_int8(v, "i"),
                               axis_name="i")(jnp.asarray(x)))


def test_compressed_psum_int8_arithmetic_matches_the_reference():
    """The port's per-rank pieces over 8 rows: MAX of the scales, each
    row's int32 codes against it, their exact integer sum, dequantized;
    equal to the reference's vmapped all-reduce with tolerance 0."""
    x = _normal(3, (8, 300)) * np.linspace(0.5, 4.0, 8)[:, None]
    rows = [torch.from_numpy(np.ascontiguousarray(r, dtype=np.float32))
            for r in x]
    smax = torch.stack([tcoll.quantize_int8(r)[1] for r in rows]).max()
    acc = torch.stack([tcoll.requantize_int8(*tcoll.quantize_int8(r), smax)
                       for r in rows]).sum(0, dtype=torch.int32)
    got = acc.to(torch.float32) * smax
    want = _ref_psum_rows(x.astype(np.float32))
    for row in want:
        np.testing.assert_array_equal(got.numpy(), row)


# ---------------------------------------------------------------------------
# Eight gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """One spawn of eight gloo ranks for the whole file; returns rank
    0's results, all ranks' results and the all-reduce input."""
    out = tmp_path_factory.mktemp("gloo")
    x = _normal(4, (8, 128))
    np.savez(out / "inputs.npz", x=x)
    res = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_gloo_ranks.py"),
         str(out)], cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(8)]
    return ranks, x


def test_gloo_int8_allreduce_equals_the_reference(gloo):
    """``make_compressed_allreduce`` over an 8-way axis: every rank holds
    the reference's shard_map mean (its vmapped psum / 8) bit for bit."""
    ranks, x = gloo
    want = _ref_psum_rows(x)[0] / 8
    for r in ranks:
        np.testing.assert_array_equal(np.asarray(r["allreduce"], np.float32),
                                      want)


def test_gloo_elastic_reshard_runs_the_contracting_matmul(gloo):
    """The reference's elastic case, which fails in JAX (an ambiguous
    sharding of the contracted dim): 8 -> 6 devices, a host restore onto
    ranks 0-5 with the model axis sharded, ``(a @ a.T).sum()``."""
    ranks, _ = gloo
    w = np.arange(48.0, dtype=np.float32).reshape(8, 6)
    for rank, r in enumerate(ranks):
        e = r["elastic"]
        assert e["plan"] == [3, 2]
        assert e["member"] == (rank < 6)
        if e["member"]:
            assert e["local_cols"] == 3
            assert e["value"] == float((w @ w.T).sum())


@pytest.mark.parametrize("kv", ["4", "2", "2-long", "moe"])
def test_gloo_sharded_serve_steps_equal_the_unsharded_port(gloo, kv):
    """A smoke model's prefill and 4 T=1 steps on a (2, 4) mesh equal the
    unsharded port on every rank, to float32 tolerance (atol 1e-5; the
    sharded matmuls sum in another order).  4 kv heads divide the model
    axis and shard the caches by head; 2 do not, and the caches fall back
    to the sequence over ``model``, whose attention all-gathers them
    ("2-long": a 14-token prompt, longer than a rank's 8 positions, and
    steps at 14-17, across two sequence shards); the MoE model (4 kv
    heads) routes on every rank and runs its 4 experts over ``model``.
    Both runs make the same plain calls of the attention ops: no op is
    skipped or doubled by the sharding."""
    ranks, _ = gloo
    for r in ranks:
        s = r["serve"][kv]
        assert s["max_abs_err"] <= 1e-5, s["max_abs_err"]
        assert s["max_abs"] > 1.0
        assert s["sharded_counts"] == s["plain_counts"]
        assert s["plain_counts"]["decode_attention"] == 8
        assert s["plain_counts"]["flash_attention"] == 2
        assert s["collectives"]["all-gather"] > 0
    spec = ranks[0]["serve"][kv]["cache_spec"]
    assert spec == (["None", "data", "model", "None", "None"]
                    if kv.startswith("2")
                    else ["None", "data", "None", "model", "None"])
    # the fallback gathers each layer's cache for the attention
    assert ranks[0]["serve"]["2"]["collectives"]["all-gather"] > \
        ranks[0]["serve"]["4"]["collectives"]["all-gather"]


@pytest.mark.parametrize("layout", ["sequence", "kv heads"])
def test_gloo_sharded_cache_writes_equal_the_plain_function(gloo, layout):
    """``update_kv_cache`` into a DTensor cache on the (2, 4) mesh equals
    the plain function bit for bit on every rank, after each of 6 writes:
    windows longer than a rank's 8 positions (12 and 20), windows across
    two sequence shards, offsets clamped to S - T, scalar and per-row
    offsets; with the sequence over ``model`` (the reference's fallback)
    and with the kv heads over it."""
    ranks, _ = gloo
    for r in ranks:
        w = r["cache_writes"][layout]
        assert w["max_abs_err"] == 0.0
        assert w["local_positions"] == (8 if layout == "sequence" else 32)


def test_gloo_sharded_train_step_equals_the_unsharded_port(gloo):
    """The loss gradients and one AdamW train step (2 microbatches) of a
    smoke dense model on the (2, 4) mesh against the unsharded port: the
    loss to 1e-6, every gradient to 1e-5 of the largest, every updated
    parameter to 1e-4 (a third of the step's learning rate: AdamW's first
    step moves each weight by ~lr * sign(g), so a gradient within rounding
    of 0 may move either way)."""
    ranks, _ = gloo
    for r in ranks:
        t = r["train"]
        assert t["loss_err"] <= 1e-6
        assert t["grad_err"] <= 1e-5 * t["grad_max"]
        assert t["param_err"] <= 1e-4 < t["moved"]


def test_fault_tolerance_copy_plans_as_the_reference():
    from repro.distributed import fault_tolerance as jft
    from repro_torch.distributed import fault_tolerance as tft

    for args in (((2, 16, 16), ("pod", "data", "model"), 3, 4),
                 ((16, 16), ("data", "model"), 40, 4)):
        assert dataclasses.asdict(tft.degraded_mesh_plan(*args)) == \
            dataclasses.asdict(jft.degraded_mesh_plan(*args))
    times = np.ones((8, 10)) * 0.1
    times[3] *= 5.0
    assert list(tft.straggler_policy(times)["stragglers"]) == [3]
