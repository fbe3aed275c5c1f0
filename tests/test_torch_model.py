"""The port's dense decoder on the CPU against the JAX package's.

Parameters come from the reference's ``DecoderLM.init`` and are carried
across with ``repro_torch.bridge.params_from_jax``; inputs are numpy with
fixed seeds.  Logits must agree within ``_tol(float32)`` of
``tests/test_kernels.py`` (2e-5) for prefill, for T=1 and T=L+1
windows and for token-tree windows.  The JAX side runs its CPU path (page-table gather + masked
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
from repro_torch.configs import get_config, list_architectures
from repro_torch.models import build_model, has_prefix_embeds
from repro_torch.models import layers as tl
from repro_torch.models.model_zoo import prefix_len

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


def _leaves(tree, path=()):
    """(path, leaf) of every array of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


# the engine tests' dense target, a MoE stack with a leading dense block and
# shared experts, a MoE stack with a dense residual, a VLM with tied
# embeddings, and the encoder-decoder
BRIDGE_ARCHS = ["target", "moonshot-v1-16b-a3b", "arctic-480b",
                "paligemma-3b", "whisper-large-v3"]


@pytest.mark.parametrize("arch", BRIDGE_ARCHS)
def test_params_from_jax_keeps_layouts(arch):
    """Every stacked layer axis (``blocks``, ``dense_blocks``,
    ``enc_blocks``, ``dec_blocks``) unrolls into per-layer dicts whose
    leaves, MoE expert stacks and nested ``shared`` / ``dense`` MLPs
    included, equal the reference's layer slice exactly, in its (in, out)
    layout; the other entries carry over as they are."""
    if arch == "target":
        cfg, jm, jparams, tm, tparams = _pair("target")
    else:
        cfg = get_config(arch).smoke()
        jparams = jbuild_model(_jcfg(cfg)).init(jax.random.PRNGKey(3))
        tparams = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    stacks = [k for k in ("blocks", "dense_blocks", "enc_blocks", "dec_blocks")
              if k in jparams]
    assert set(tparams) == set(jparams)
    assert ("dense_blocks" in stacks) == (cfg.first_k_dense > 0)
    assert ("unembed" in tparams) == (not cfg.tie_embeddings)
    for stack in stacks:
        n = next(_leaves(jparams[stack]))[1].shape[0]
        assert len(tparams[stack]) == n
        for i, blk in enumerate(tparams[stack]):
            want_leaves = dict(_leaves(jparams[stack]))
            got_leaves = dict(_leaves(blk))
            assert set(got_leaves) == set(want_leaves)
            for path, t in got_leaves.items():
                want = np.asarray(want_leaves[path])[i]
                assert tuple(t.shape) == want.shape    # (in, out): no transpose
                np.testing.assert_array_equal(t.numpy(), want)
    for key in set(jparams) - set(stacks):
        for path, t in _leaves(tparams[key]):
            np.testing.assert_array_equal(
                t.numpy(), np.asarray(dict(_leaves(jparams[key]))[path]))
    if cfg.num_experts:
        moe = tparams["blocks"][0]["moe"]
        E, F = cfg.num_experts, cfg.moe_d_ff
        assert tuple(moe["w_gate"].shape) == (E, cfg.d_model, F)
        assert ("shared" in moe) == bool(cfg.num_shared_experts)
        assert ("dense" in moe) == cfg.dense_residual


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


# ---------------------------------------------------------------------------
# token-tree windows
# ---------------------------------------------------------------------------

def _tree(rng, B, J, L, lengths=None):
    """The packed tree of J random drafts per row over a 3-token alphabet
    (shared prefixes and divergence both occur)."""
    from repro_torch.core.token_tree import build_token_tree

    toks = rng.integers(0, 3, (B, J, L))
    zeros = np.zeros((B, J, L, 1))
    lengths = np.full(B, L) if lengths is None else np.asarray(lengths)
    return build_token_tree(toks, zeros[..., 0], zeros.astype(np.int32),
                            zeros, lengths)


def test_tree_window_helpers_match_jax():
    """``tree_window_mask``, ``gather_kv_window`` and ``scatter_kv_window``
    equal the JAX functions on numpy-seeded pools: positions past the table
    or through -1 entries clamp on gather and drop on scatter (the JAX drop
    bin is each port layer's drop slot), invalid positions drop."""
    rng = np.random.default_rng(6)
    Ln, P, ps, KV, D, B, T = 2, 6, 4, 2, 8, 3, 5
    pt = np.array([[2, -1, 4], [0, 1, 3], [-1, -1, -1]], np.int32)
    pos = np.array([[1, 5, 9, 2, 0], [3, 4, 11, 12, 7], [0, 1, 2, 3, 4]],
                   np.int32)                    # 12 runs past the table
    valid = rng.random((B, T)) < 0.8
    leaf0 = rng.standard_normal((Ln, P, ps, KV, D)).astype(np.float32)
    vals = rng.standard_normal((Ln, B, T, KV, D)).astype(np.float32)
    leaf = tl.new_page_pool(Ln, P, ps, KV, D, dtype=torch.float32,
                            device="cpu")
    leaf.copy_(torch.from_numpy(leaf0))
    got = tl.gather_kv_window(leaf, torch.from_numpy(pos), torch.from_numpy(pt))
    want = jl.gather_kv_window(jnp.asarray(leaf0), jnp.asarray(pos),
                               page_table=jnp.asarray(pt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tl.scatter_kv_window(leaf, torch.from_numpy(vals), torch.from_numpy(pos),
                         torch.from_numpy(valid), torch.from_numpy(pt))
    want = jl.scatter_kv_window(jnp.asarray(leaf0), jnp.asarray(vals),
                                jnp.asarray(pos), jnp.asarray(valid),
                                page_table=jnp.asarray(pt))
    np.testing.assert_array_equal(leaf.numpy(), np.asarray(want))
    assert not np.array_equal(leaf.numpy(), leaf0)
    tree = _tree(rng, B, 2, 3, lengths=[3, 2, 3])
    wm, offs = tree.window_mask(), np.array([4, 0, 9], np.int32)
    np.testing.assert_array_equal(
        tl.tree_window_mask(torch.from_numpy(offs), torch.from_numpy(wm),
                            20).numpy(),
        np.asarray(jl.tree_window_mask(jnp.asarray(offs), jnp.asarray(wm), 20)))


@pytest.mark.parametrize("J", [2, 3, "chain"])
def test_tree_forward_window_matches_jax(J):
    """A token-tree window of J drafts (from ``build_token_tree``) through
    the paged cache: logits within ``_tol(float32)`` of the JAX
    ``forward_window`` on live rows, and the pools agree everywhere.  A
    chain mask with depths 0..T-1 equals the port's sequential window."""
    cfg, jm, jparams, tm, tparams = _pair("target")
    rng = np.random.default_rng(7)
    B, S, L = 3, 13, 3
    P = B * N_SLOTS
    if J == "chain":
        T = L + 1
        wm = np.broadcast_to(np.tril(np.ones((T, T), bool)), (B, T, T)).copy()
        depth = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    else:
        tree = _tree(rng, B, J, L, lengths=[L, L - 1, L])
        wm, depth = tree.window_mask(), tree.window_depth().astype(np.int32)
        T = J * L + 1
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pt = _table(rng, B, P, np.full(B, S + T))
    jcache = dict(jm.init_paged_cache(P, PS, jnp.float32), pages=jnp.asarray(pt))
    tcache = dict(tm.init_paged_cache(P, PS, torch.float32),
                  pages=torch.from_numpy(pt))
    _, jcache, _ = jm.prefill(jparams, jnp.asarray(tokens), jcache)
    _, tcache, _ = tm.prefill(tparams, torch.from_numpy(tokens), tcache)
    win = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.full(B, S, np.int32)
    jl_, jcache = jm.forward_window(jparams, jnp.asarray(win), jcache,
                                    jnp.asarray(pos), window_mask=jnp.asarray(wm),
                                    window_depth=jnp.asarray(depth))
    if J == "chain":
        seq = dict(tm.init_paged_cache(P, PS, torch.float32),
                   pages=torch.from_numpy(pt))
        _, seq, _ = tm.prefill(tparams, torch.from_numpy(tokens), seq)
        seq_logits, seq = tm.forward_window(tparams, torch.from_numpy(win), seq,
                                            torch.from_numpy(pos))
    tl_, tcache = tm.forward_window(tparams, torch.from_numpy(win), tcache,
                                    torch.from_numpy(pos),
                                    window_mask=torch.from_numpy(wm),
                                    window_depth=torch.from_numpy(depth))
    live = slice(0, B - 1)
    np.testing.assert_allclose(tl_.numpy()[live], np.asarray(jl_)[live], **TOL)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(tcache[leaf].numpy(),
                                   np.asarray(jcache[leaf]), **TOL)
    if J == "chain":
        np.testing.assert_allclose(tl_.numpy(), seq_logits.numpy(), **TOL)
    with pytest.raises(ValueError, match="window_mask"):
        tm.forward_window(tparams, torch.from_numpy(win), tcache,
                          torch.from_numpy(pos),
                          window_depth=torch.from_numpy(depth))


@pytest.mark.parametrize("arch", list_architectures())
def test_unported_paths_name_their_roadmap_item(arch):
    """Every registered architecture's smoke config builds on the CPU and
    runs ``apply`` (with prefix embeddings where ``has_prefix_embeds``
    says so) against the reference's ``apply`` on the same parameters:
    no family is refused any more.  Logits and the aux loss within
    ``_tol(float32)``; MoE blocks dispatch at the configured capacity."""
    cfg = get_config(arch).smoke()
    jm = jbuild_model(_jcfg(cfg))
    jparams = jm.init(jax.random.PRNGKey(11))
    tm = build_model(cfg, device="cpu")
    tparams = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    rng = np.random.default_rng(12)
    B, S = 2, 6
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    prefix = None
    assert has_prefix_embeds(cfg) == (cfg.family in ("vlm", "audio"))
    if has_prefix_embeds(cfg):
        prefix = rng.standard_normal(
            (B, prefix_len(cfg), cfg.d_model)).astype(np.float32)
    jl_, jaux = jm.apply(jparams, jnp.asarray(tokens),
                         prefix_embeds=None if prefix is None
                         else jnp.asarray(prefix))
    tl_, taux = tm.apply(tparams, torch.from_numpy(tokens),
                         prefix_embeds=None if prefix is None
                         else torch.from_numpy(prefix))
    extra = cfg.num_patches if cfg.family == "vlm" else 0
    assert tl_.shape == (B, S + extra, cfg.vocab_size)
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
