"""The port's dense decoder on the CPU against the JAX package's.

Parameters come from the reference's ``DecoderLM.init`` and are carried
across with ``repro_torch.bridge.params_from_jax``; inputs are numpy with
fixed seeds.  Logits must agree within ``_tol(float32)`` of
``tests/test_kernels.py`` (2e-5) for prefill and for T=1 and T=L+1
windows.  The JAX side runs its CPU path (page-table gather + masked
``gqa_attention``); the port runs ``ops.paged_attention``'s plain version.
The two differ only on query rows that see no key (all-(-1) table rows),
which the comparison leaves out and says so.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import build_model as jbuild_model
from repro.models import layers as jl
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import layers as tl

TOL = dict(rtol=2e-5, atol=2e-5)
PS, N_SLOTS = 16, 6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfgs():
    """The engine-test model sizes of ``tests/test_roundpath.py:24-26``."""
    tcfg = get_config("qwen2.5-3b").smoke()
    dcfg = tcfg.replace(num_layers=1, d_model=32, num_heads=2, num_kv_heads=1,
                        head_dim=16, d_ff=64, name="draft-smoke")
    return {"target": tcfg, "draft": dcfg}


def _jcfg(cfg):
    """The same configuration as the JAX package's ``ModelConfig``."""
    return JModelConfig(**dataclasses.asdict(cfg))


def _pair(role, seed=0):
    cfg = _cfgs()[role]
    jm = jbuild_model(_jcfg(cfg))
    jparams = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(cfg, device="cpu")
    tparams = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return cfg, jm, jparams, tm, tparams


def _table(rng, B, P, lengths, retired_row=True):
    pt = np.full((B, N_SLOTS), -1, np.int32)
    pages = rng.permutation(P)
    n = 0
    for b in range(B):
        need = -(-int(lengths[b]) // PS)
        pt[b, :need] = pages[n:n + need]
        n += need
    if retired_row:
        pt[-1] = -1
    return pt


@pytest.mark.parametrize("role", ["target", "draft"])
def test_prefill_and_windows_match_jax(role):
    cfg, jm, jparams, tm, tparams = _pair(role)
    rng = np.random.default_rng(1)
    B, S, L = 3, 13, 4
    P = B * N_SLOTS
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    # every row maps the prompt plus two windows (1 + (L+1) tokens); the
    # last row is retired (all -1): its writes drop and its outputs differ
    pt = _table(rng, B, P, np.full(B, S + 1 + L + 1))
    jcache = dict(jm.init_paged_cache(P, PS, jnp.float32), pages=jnp.asarray(pt))
    tcache = dict(tm.init_paged_cache(P, PS, torch.float32),
                  pages=torch.from_numpy(pt))
    live = slice(0, B - 1)

    jl_, jcache, _ = jm.prefill(jparams, jnp.asarray(tokens), jcache)
    tl_, tcache, _ = tm.prefill(tparams, torch.from_numpy(tokens), tcache)
    np.testing.assert_allclose(tl_.numpy()[live], np.asarray(jl_)[live], **TOL)

    pos = np.full(B, S, np.int32)
    for T in (1, L + 1):
        win = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
        jl_, jcache = jm.forward_window(jparams, jnp.asarray(win), jcache,
                                        jnp.asarray(pos))
        tl_, tcache = tm.forward_window(tparams, torch.from_numpy(win),
                                        tcache, torch.from_numpy(pos))
        assert tl_.shape == (B, T, cfg.vocab_size) and tl_.dtype == torch.float32
        np.testing.assert_allclose(tl_.numpy()[live], np.asarray(jl_)[live],
                                   **TOL)
        pos = pos + T
    # the pools agree everywhere, the retired row's dropped writes included
    for leaf in ("k", "v"):
        np.testing.assert_allclose(tcache[leaf].numpy(),
                                   np.asarray(jcache[leaf]), **TOL)


def test_params_from_jax_keeps_layouts():
    cfg, jm, jparams, tm, tparams = _pair("target")
    assert len(tparams["blocks"]) == cfg.num_layers
    for i, blk in enumerate(tparams["blocks"]):
        for group, leaves in blk.items():
            for name, t in leaves.items():
                want = np.asarray(jparams["blocks"][group][name])[i]
                assert tuple(t.shape) == want.shape    # (in, out): no transpose
                np.testing.assert_array_equal(t.numpy(), want)
    np.testing.assert_array_equal(tparams["embed"].numpy(),
                                  np.asarray(jparams["embed"]))


def test_init_draws_the_reference_distributions():
    cfg = _cfgs()["target"]
    tm = build_model(cfg, device="cpu")
    p = tm.init(0)
    assert tm.num_params(p) == sum(int(np.prod(x.shape)) for x in
                                   jax.tree.leaves(jbuild_model(_jcfg(cfg)).init(
                                       jax.random.PRNGKey(0))))
    w = p["blocks"][0]["mlp"]["w_down"]
    assert abs(float(w.std()) * np.sqrt(cfg.d_ff) - 1.0) < 0.1
    assert abs(float(p["embed"].std()) - 0.02) < 0.005
    assert torch.equal(tm.init(0)["embed"], p["embed"])       # seeded


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_jax(kind):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    p = {"scale": scale, "bias": rng.standard_normal(32).astype(np.float32)}
    jfn, tfn = getattr(jl, kind), getattr(tl, kind)
    want = np.asarray(jfn({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x)))
    got = tfn({k: torch.from_numpy(v) for k, v in p.items()},
              torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("theta", [10000.0, 1000000.0])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    want = np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    # angles reach 500 rad, where one float32 ulp of the angle is ~3e-5:
    # cos/sin of it differ by that much between the two math libraries
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_jax(act):
    rng = np.random.default_rng(4)
    d, f = 16, 24
    p = {k: (rng.standard_normal(s) / 4).astype(np.float32) for k, s in
         (("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d)))}
    if act == "gelu":
        del p["w_gate"]
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    want = np.asarray(jl.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x), act))
    got = tl.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_paged_update_drop_contract_matches_jax():
    """Writes through -1 entries or past the table width are dropped; the
    rest land at page_table[b, p // ps] slot p % ps — exactly as the JAX
    scatter with its P*ps drop bin."""
    rng = np.random.default_rng(5)
    P, ps, KV, D, B, T, n_slots = 6, 4, 2, 8, 3, 5, 3
    pt = np.array([[2, -1, 4], [0, 1, 3], [-1, -1, -1]], np.int32)
    offset = np.array([2, 9, 0], np.int32)         # row 1 runs past the table
    new = rng.standard_normal((B, T, KV, D)).astype(np.float32)
    pool0 = rng.standard_normal((P, ps, KV, D)).astype(np.float32)
    want = np.asarray(jl.paged_update_kv_cache(
        jnp.asarray(pool0), jnp.asarray(new), jnp.asarray(offset),
        jnp.asarray(pt)))
    pool = tl.new_page_pool(1, P, ps, KV, D, dtype=torch.float32,
                           device="cpu")[0]
    pool.copy_(torch.from_numpy(pool0))
    tl.paged_update_kv_cache(pool, torch.from_numpy(new),
                             torch.from_numpy(offset), torch.from_numpy(pt))
    np.testing.assert_array_equal(pool.numpy(), want)
    gathered = tl.paged_gather_kv(pool, torch.from_numpy(pt)).numpy()
    np.testing.assert_array_equal(
        gathered, np.asarray(jl.paged_gather_kv(jnp.asarray(want),
                                                jnp.asarray(pt))))
    with pytest.raises(ValueError, match="new_page_pool"):
        tl.paged_update_kv_cache(torch.zeros((P, ps, KV, D)),
                                 torch.from_numpy(new),
                                 torch.from_numpy(offset),
                                 torch.from_numpy(pt))


def test_unported_paths_name_their_roadmap_item():
    cfg = _cfgs()["target"]
    tm = build_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="A2"):
        tm.init_cache(1, 32)
    with pytest.raises(NotImplementedError, match="A7"):
        tm.forward_window(None, torch.zeros((1, 2), dtype=torch.int32), {},
                          torch.zeros(1, dtype=torch.int32),
                          window_mask=torch.ones((1, 2, 2), dtype=torch.bool))
    for arch, item in (("mamba2-130m", "A13"), ("zamba2-2.7b", "A13"),
                       ("whisper-large-v3", "A14"), ("paligemma-3b", "A14"),
                       ("moonshot-v1-16b-a3b", "A12")):
        with pytest.raises(NotImplementedError, match=item):
            build_model(get_config(arch).smoke(), device="cpu")
