"""The port's checkpoint layer on the CPU against the JAX package's.

``repro_torch.checkpoint.msgpack_lite`` must give the bytes of
``msgpack.packb(obj, use_bin_type=True)`` and read msgpack's bytes back;
a file the port writes must be byte for byte the reference's for the same
arrays, with zstd and with zlib (the reference's codec when zstandard is
missing); a model's training state ``{"params", "opt"}`` crosses both ways
bit for bit, bfloat16 leaves included (the port side in the reference's
layout, ``bridge.params_to_jax``).  Corruption, retention, async writes and
restore past a corrupt latest file are held as in ``tests/test_training.py``.
The train launcher runs with jax blocked from import and leaves a file the
reference's ``load`` reads.
"""

import dataclasses
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

from repro.checkpoint import checkpoint as jckpt
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import build_model as jbuild_model
from repro.training import OptimizerConfig as JOptimizerConfig
from repro.training import init_optimizer as jinit_optimizer
from repro_torch.bridge import params_from_jax
from repro_torch.checkpoint import CheckpointManager, checkpoint as tckpt
from repro_torch.checkpoint import load, msgpack_lite, save
from repro_torch.configs import get_config
from repro_torch.launch.train import train_state
from repro_torch.training import OptimizerConfig, init_optimizer

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# msgpack_lite
# ---------------------------------------------------------------------------

INT_EDGES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
             2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
             -2**31 - 1, -2**63]
PAYLOADS = {
    "ints": INT_EDGES,
    "scalars": [None, True, False, 0.0, -1.5, 3e-300, float("inf"), 1e300],
    "strs": ["", "a" * 31, "a" * 32, "é" * 128, "b" * 256, "c" * 65535,
             "d" * 65536],
    "bins": [b"", b"x" * 255, b"y" * 256, b"z" * 65535, b"w" * 65536],
    "arrays": [[1] * 15, [2] * 16, list(range(65535)), [0] * 65536, (1, 2)],
    "maps": [{str(i): i for i in range(n)} for n in (0, 15, 16, 65536)],
    "checkpoint": {
        "arrays": {"a/0/w": {"dtype": "bfloat16", "shape": [3, 4],
                             "data": bytes(range(24))},
                   "step": {"dtype": "int32", "shape": [], "data": b"\0" * 4}},
        "metadata": {"step": 12, "loss": 2.5, "note": "x"}},
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_msgpack_lite_gives_msgpack_bytes(name):
    obj = PAYLOADS[name]
    want = msgpack.packb(obj, use_bin_type=True)
    assert msgpack_lite.packb(obj) == want
    back = msgpack.unpackb(want, raw=False)
    assert msgpack_lite.unpackb(want) == back


_leaf = (st.none() | st.booleans() | st.integers(-2**63, 2**64 - 1)
         | st.floats(allow_nan=False) | st.text(max_size=40)
         | st.binary(max_size=300))
_meta = st.recursive(_leaf, lambda kids: st.lists(kids, max_size=20)
                     | st.dictionaries(st.text(max_size=8), kids, max_size=20),
                     max_leaves=60)


@given(_meta)
@settings(max_examples=150, deadline=None)
def test_msgpack_lite_matches_msgpack_on_drawn_metadata(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert msgpack_lite.packb(obj) == want
    assert msgpack_lite.unpackb(want) == msgpack.unpackb(want, raw=False)


@pytest.mark.parametrize("data", [b"\xca\0\0\0\0", b"\xc7\x01\x05x",
                                  b"\x92\x01", b"\x01\x02"])
def test_msgpack_lite_refuses_what_the_format_lacks(data):
    """float32, ext, a truncated array, trailing bytes."""
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(data)


def test_msgpack_lite_refuses_unknown_types():
    with pytest.raises(TypeError):
        msgpack_lite.packb({"a": 1j})
    with pytest.raises(OverflowError):
        msgpack_lite.packb(2**64)


# ---------------------------------------------------------------------------
# The file format against the reference
# ---------------------------------------------------------------------------

def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "blocks": {"b": rng.standard_normal((2, 4)).astype(np.float32),
                       "h": rng.standard_normal(6).astype(np.float16)},
            "emb": rng.standard_normal((4, 3)).astype(np.float32),
            "ids": rng.integers(-5, 5, (7,)).astype(np.int32),
            "mask": rng.random(5) < 0.5,
            "step": np.array(9, np.int32),
            "empty": np.zeros((0, 3), np.float32)}


def _bf16_pair(a):
    """The same bfloat16 values on both sides: jnp rounds, torch views the
    bits."""
    j = jnp.asarray(a, jnp.bfloat16)
    bits = np.asarray(j).view(np.uint16).astype(np.int16)
    return j, torch.from_numpy(bits).view(torch.bfloat16)


def _trees():
    n = _np_tree()
    jtree = {k: (jax.tree.map(jnp.asarray, v) if isinstance(v, dict)
                 else jnp.asarray(v)) for k, v in n.items()}
    ttree = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
                 if isinstance(v, dict) else torch.from_numpy(v))
             for k, v in n.items()}
    jtree["emb"], ttree["emb"] = _bf16_pair(n["emb"])
    # a list: the port's per-layer layout keys its items by index
    ttree["layers"] = [torch.ones(2), torch.zeros(2)]
    jtree["layers"] = [jnp.ones(2), jnp.zeros(2)]
    return jtree, ttree


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
def test_port_file_is_byte_identical_to_reference(codec, tmp_path, monkeypatch):
    if codec == "zlib":
        monkeypatch.setattr(jckpt, "zstandard", None)
        monkeypatch.setattr(tckpt, "zstandard", None)
    jtree, ttree = _trees()
    meta = {"step": 9, "tag": "x", "loss": 1.25}
    jckpt.save(str(tmp_path / "ref.ckpt"), jtree, meta)
    save(str(tmp_path / "port.ckpt"), ttree, meta)
    ref = (tmp_path / "ref.ckpt").read_bytes()
    assert (tmp_path / "port.ckpt").read_bytes() == ref
    magic = 11 + 32
    assert (ref[magic:magic + 4] == b"\x28\xb5\x2f\xfd") == (codec == "zstd")


def test_zstd_file_without_zstandard_raises(tmp_path, monkeypatch):
    _, ttree = _trees()
    p = str(tmp_path / "ck")
    save(p, ttree)
    monkeypatch.setattr(tckpt, "zstandard", None)
    with pytest.raises(ValueError, match="zstandard"):
        load(p, ttree)


def _bits(t):
    if isinstance(t, torch.Tensor):
        return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.asarray(t).reshape(-1).view(np.uint8)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _assert_same_bits(a, b):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        names = [str(x.dtype).removeprefix("torch.") for x in (fa[k], fb[k])]
        assert names[0] == names[1], (k, names)
        np.testing.assert_array_equal(_bits(fa[k]), _bits(fb[k]), err_msg=k)


def test_roundtrip_keeps_dtypes_shapes_and_devices(tmp_path):
    _, ttree = _trees()
    p = str(tmp_path / "ck")
    save(p, ttree, {"step": 7})
    template = {k: (dict(v) if isinstance(v, dict) else v)
                for k, v in ttree.items()}
    got, meta = load(p, template)
    assert meta == {"step": 7}
    _assert_same_bits(got, ttree)
    assert isinstance(got["layers"], list)
    got["w"].add_(1)                        # restored leaves own their memory
    assert not torch.equal(got["w"], ttree["w"])


# ---------------------------------------------------------------------------
# A model's training state across the packages
# ---------------------------------------------------------------------------

ARCHS = ["tinyllama-1.1b", "moonshot-v1-16b-a3b", "zamba2-2.7b",
         "whisper-large-v3"]


def _state(arch, param_dtype):
    cfg = get_config(arch).smoke().replace(param_dtype=param_dtype)
    jm = jbuild_model(JModelConfig(**dataclasses.asdict(cfg)))
    jparams = jm.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                             jparams)
    tparams = params_from_jax(cfg, np_params, device="cpu")
    tparams = jax.tree.map(lambda t: t.to(getattr(torch, param_dtype)),
                           tparams)
    opt_cfg = OptimizerConfig(state_dtype="bfloat16")
    topt = init_optimizer(opt_cfg, tparams)
    g = torch.Generator().manual_seed(3)
    for key in ("m", "v"):
        topt[key] = jax.tree.map(
            lambda t: torch.randn(t.shape, generator=g).abs().to(t.dtype),
            topt[key])
    topt["step"] = torch.tensor(17, dtype=torch.int32)
    jopt = jinit_optimizer(JOptimizerConfig(state_dtype="bfloat16"), jparams)
    return cfg, jparams, jopt, tparams, topt


@pytest.mark.parametrize("arch", ARCHS)
def test_training_state_crosses_both_ways_bit_exact(arch, tmp_path):
    cfg, jparams, jopt, tparams, topt = _state(
        arch, "bfloat16" if arch == "tinyllama-1.1b" else "float32")
    state = train_state(cfg, tparams, topt)
    port_file = str(tmp_path / "port.ckpt")
    save(port_file, state, {"step": 17})
    # the reference restores the port's file into its own structure
    got, meta = jckpt.load(port_file, {"params": jparams, "opt": jopt})
    assert meta["step"] == 17
    _assert_same_bits(jax.tree.map(np.asarray, got), state)
    # and the port restores the reference's file of the same arrays
    ref_file = str(tmp_path / "ref.ckpt")
    jckpt.save(ref_file, got, {"step": 17})
    assert Path(ref_file).read_bytes() == Path(port_file).read_bytes()
    template = train_state(cfg, jax.tree.map(torch.zeros_like, tparams),
                           init_optimizer(OptimizerConfig(
                               state_dtype="bfloat16"), tparams))
    back, _ = load(ref_file, template)
    _assert_same_bits(back, state)
    # and back into the port's own layout
    _assert_same_bits(params_from_jax(cfg, back["params"], device="cpu"),
                      tparams)


def test_load_refuses_missing_leaf_and_shape_mismatch(tmp_path):
    p = str(tmp_path / "ck")
    save(p, {"a": torch.ones(3)})
    with pytest.raises(KeyError, match="missing leaf"):
        load(p, {"a": torch.ones(3), "b": torch.ones(1)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load(p, {"a": torch.ones(4)})


# ---------------------------------------------------------------------------
# Corruption and the manager (tests/test_training.py on the port)
# ---------------------------------------------------------------------------

def _small():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones(2, dtype=torch.bfloat16),
                  "d": torch.tensor(3, dtype=torch.int32)}}


@pytest.mark.parametrize("where", [-3, 0])
def test_checkpoint_detects_corruption(where, tmp_path):
    """A flipped payload byte fails the hash; a flipped first byte the
    magic."""
    p = str(tmp_path / "ck.bin")
    save(p, _small())
    raw = bytearray(open(p, "rb").read())
    raw[where] ^= 0xFF
    open(p, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="corrupt" if where else "magic"):
        load(p, _small())


def test_manager_retention_and_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in [1, 2, 3]:
        mgr.save(s, {"w": torch.full((2,), float(s))})
    assert mgr.steps() == [2, 3]
    got, meta = mgr.restore_latest({"w": torch.zeros(2)})
    assert meta["step"] == 3
    assert got["w"].tolist() == [3.0, 3.0]


def test_manager_skips_corrupt_latest(tmp_path):
    """Node dies mid-write of step 3 -> restore falls back to step 2."""
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(2, {"w": torch.full((2,), 2.0)})
    mgr.save(3, {"w": torch.full((2,), 3.0)})
    p3 = mgr._path(3)
    raw = bytearray(open(p3, "rb").read())
    raw[-1] ^= 0xFF
    open(p3, "wb").write(bytes(raw))
    got, meta = mgr.restore_latest({"w": torch.zeros(2)})
    assert meta["step"] == 2
    assert mgr.restore_latest({"w": torch.zeros(3)}) is None   # no match


def test_manager_async_writes_a_snapshot(tmp_path, monkeypatch):
    """The writer gets a copy: updating the tensors in place right after
    ``save_async`` does not reach the file (the writer is held until the
    update is done)."""
    gate, real_save = threading.Event(), tckpt.save

    def held_save(path, tree, metadata=None):
        assert gate.wait(timeout=60)
        real_save(path, tree, metadata)

    monkeypatch.setattr(tckpt, "save", held_save)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    w = torch.ones(1 << 16)
    mgr.save_async(10, {"w": w})
    w.mul_(5)
    gate.set()
    mgr.wait()
    assert mgr.steps() == [10]
    got, _ = mgr.restore_latest({"w": torch.zeros(1 << 16)})
    assert torch.equal(got["w"], torch.ones(1 << 16))


def test_manager_wait_raises_what_the_writer_raised(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(1, {"w": torch.ones(2)}, metadata={"bad": object()})
    with pytest.raises(TypeError):
        mgr.wait()
    mgr.wait()                                  # reported once
    assert mgr.steps() == []


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_train_launcher_runs_without_jax_and_writes_a_reference_file(tmp_path):
    ckpt = tmp_path / "ck"
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"          # any import of jax fails
            "sys.modules['repro'] = None\n"
            "sys.argv = ['train'] + sys.argv[1:]\n"
            "runpy.run_module('repro_torch.launch.train', run_name='__main__')\n")
    res = subprocess.run(
        [sys.executable, "-c", code, "--arch", "tinyllama-1.1b", "--smoke",
         "--steps", "3", "--device", "cpu", "--ckpt-dir", str(ckpt)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "step    2 loss=" in res.stdout
    cfg = JModelConfig(**dataclasses.asdict(
        get_config("tinyllama-1.1b").smoke()))
    jparams = jbuild_model(cfg).init(jax.random.PRNGKey(1))
    template = {"params": jparams,
                "opt": jinit_optimizer(JOptimizerConfig(), jparams)}
    got, meta = jckpt.CheckpointManager(str(ckpt)).restore_latest(template)
    assert meta["step"] == 3
    assert int(got["opt"]["step"]) == 3
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(got))


def test_train_launcher_dry_run_names_its_roadmap_item(monkeypatch, capsys):
    """``--dry-run`` calls ``run_cell`` with the reference launcher's
    arguments (``train_4k``, the ``--multi-pod`` flag, ``force=True``) and
    prints its status and roofline, as ``repro.launch.train`` does."""
    from repro_torch.launch import dryrun, train

    calls = []

    def fake_run_cell(*args, **kw):
        calls.append((args, kw))
        return {"status": "ok", "roofline": {"bottleneck": "memory"}}

    monkeypatch.setattr(dryrun, "run_cell", fake_run_cell)
    train.main(["--arch", "tinyllama-1.1b", "--dry-run", "--multi-pod"])
    assert calls == [(("tinyllama-1.1b", "train_4k", True), {"force": True})]
    assert capsys.readouterr().out == "ok {'bottleneck': 'memory'}\n"
