"""MoE stacks, the VLM backbone and the encoder-decoder of the port on the
CPU against the JAX package's.

Parameters come from the reference's ``init`` and are carried across with
``repro_torch.bridge.params_from_jax``; inputs are numpy with fixed seeds.
Logits, MoE outputs and the aux loss must agree within ``_tol(float32)`` of
``tests/test_kernels.py`` (2e-5): both sides compute in float32, the MoE
combine sums in another order (the reference's ``segment_sum`` against the
port's fixed (T, K) sum) and the expert products run as ``torch.bmm``
against ``einsum``, which moves results by a few float32 ulps.  Rows that
see no key (the retired, all-(-1) table row) are left out, as in
``tests/test_torch_model.py``.  No reference subprocess: these are
single forwards, which do not compile engines.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import build_model as jbuild_model
from repro.models import layers as jl
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.token_tree import build_token_tree
from repro_torch.models import build_model, has_prefix_embeds
from repro_torch.models import layers as tl
from repro_torch.models.model_zoo import prefix_len

TOL = dict(rtol=2e-5, atol=2e-5)
PS, N_SLOTS = 8, 8
MOE_ARCHS = ["moonshot-v1-16b-a3b", "arctic-480b"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jcfg(cfg):
    return JModelConfig(**dataclasses.asdict(cfg))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _models(arch, seed=0):
    cfg = get_config(arch).smoke()
    jm = jbuild_model(_jcfg(cfg))
    jparams = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(cfg, device="cpu")
    tparams = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return cfg, jm, jparams, tm, tparams


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _moe_layer(arch, seed=0):
    cfg = get_config(arch).smoke()
    tm = build_model(cfg, device="cpu")
    mcfg = tm.moe_cfg
    jmcfg = jl.MoEConfig(**dataclasses.asdict(mcfg))
    jp = jl.init_moe(jax.random.PRNGKey(seed), cfg.d_model, jmcfg)
    return cfg, tm, mcfg, jmcfg, jp, _to_torch(jax.tree.map(np.asarray, jp))


def _loads(probs_router, x, K):
    """Tokens routed to each expert (numpy, from the same router)."""
    logits = x.reshape(-1, x.shape[-1]) @ probs_router
    top = np.argsort(-logits, axis=-1, kind="stable")[:, :K]
    return np.bincount(top.reshape(-1), minlength=probs_router.shape[1])


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity", ["configured", "no_drop"])
def test_moe_apply_matches_jax(arch, capacity):
    """Output and Switch aux loss against the reference's ``moe_apply`` at
    the configured factor 1.25, where this input drops tokens (some expert
    receives more than C items), and at the no-drop factor E / K (C = T);
    moonshot's smoke config has shared experts, arctic's the dense
    residual."""
    cfg, tm, mcfg, jmcfg, jp, tp = _moe_layer(arch)
    rng = np.random.default_rng(21)
    B, S = 4, 8
    # a shared offset skews the routing, so that 1.25 really drops
    x = (rng.standard_normal((B, S, cfg.d_model))
         + 1.5 * rng.standard_normal(cfg.d_model)).astype(np.float32)
    cf = None if capacity == "configured" else tm.no_drop_capacity
    C = tl.moe_capacity(B * S, mcfg, cf)
    loads = _loads(np.asarray(jp["router"]), x, mcfg.top_k)
    assert (loads.max() > C) == (capacity == "configured")
    if capacity == "no_drop":
        assert C == B * S
    want, want_aux = jl.moe_apply(jp, jnp.asarray(x), jmcfg, capacity_factor=cf)
    got, aux = tl.moe_apply(tp, torch.from_numpy(x), mcfg, capacity_factor=cf)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


def test_moe_combine_is_the_same_bits_call_to_call():
    """The combine sums each token's K contributions in a fixed order (no
    scatter-add): two calls give the same bits."""
    cfg, tm, mcfg, _, _, tp = _moe_layer("moonshot-v1-16b-a3b", seed=1)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 5, cfg.d_model)).astype(np.float32))
    a, _ = tl.moe_apply(tp, x, mcfg, capacity_factor=tm.no_drop_capacity)
    b, _ = tl.moe_apply(tp, x, mcfg, capacity_factor=tm.no_drop_capacity)
    assert torch.equal(a, b)


_NO_DROP = {}


@settings(max_examples=12, deadline=None, derandomize=True)
@given(B=st.integers(1, 4), S=st.integers(1, 6), row=st.integers(0, 3),
       seed=st.integers(0, 2 ** 16), arch=st.sampled_from(MOE_ARCHS))
def test_moe_no_drop_row_is_independent_of_the_batch(B, S, row, seed, arch):
    """Under the no-drop capacity a row's output does not depend on the
    other rows of the batch: the verification window's exactness
    (``forward_window`` dispatches at this capacity)."""
    if arch not in _NO_DROP:
        _NO_DROP[arch] = _moe_layer(arch)
    cfg, tm, mcfg, _, _, tp = _NO_DROP[arch]
    row = row % B
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    cf = tm.no_drop_capacity
    full, _ = tl.moe_apply(tp, x, mcfg, capacity_factor=cf)
    alone, _ = tl.moe_apply(tp, x[row:row + 1], mcfg, capacity_factor=cf)
    # the same products at other buffer shapes: float32 ulps, not routing
    np.testing.assert_allclose(full[row].numpy(), alone[0].numpy(),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# MoE and VLM models on both cache layouts
# ---------------------------------------------------------------------------

def _table(rng, B, P, need_tokens):
    pt = np.full((B, N_SLOTS), -1, np.int32)
    pages = rng.permutation(P)
    n = 0
    for b in range(B):
        need = -(-need_tokens // PS)
        pt[b, :need] = pages[n:n + need]
        n += need
    pt[-1] = -1                       # a retired row: its writes drop
    return pt


def _tree(rng, B, J, L):
    """The packed tree of J random drafts per row over a 3-token alphabet
    (shared prefixes and divergence both occur)."""
    toks = rng.integers(0, 3, (B, J, L))
    zeros = np.zeros((B, J, L, 1))
    return build_token_tree(toks, zeros[..., 0], zeros.astype(np.int32),
                            zeros, np.full(B, L))


def _caches(jm, tm, layout, B, rng, need):
    if layout == "paged":
        P = B * N_SLOTS
        pt = _table(rng, B, P, need)
        return (dict(jm.init_paged_cache(P, PS, jnp.float32),
                     pages=jnp.asarray(pt)),
                dict(tm.init_paged_cache(P, PS, torch.float32),
                     pages=torch.from_numpy(pt)), slice(0, B - 1))
    S_max = N_SLOTS * PS
    return (jm.init_cache(B, S_max, jnp.float32),
            tm.init_cache(B, S_max, torch.float32), slice(0, B))


def _check_leaves(tcache, jcache):
    leaves = [k for k in jcache if k != "pages"]
    assert sorted(leaves) == sorted(k for k in tcache if k != "pages")
    for leaf in leaves:
        np.testing.assert_allclose(tcache[leaf].numpy(),
                                   np.asarray(jcache[leaf]), **TOL)
    return leaves


@pytest.mark.parametrize("arch", MOE_ARCHS + ["paligemma-3b"])
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_prefill_and_windows_match_jax(arch, layout):
    """``prefill`` (a VLM with prefix embeds), a T = 1 window, a T = L + 1
    window and a token-tree window (J = 2) against the reference on both
    layouts: logits on live rows, the aux loss of the prefill and every
    cache leaf (a MoE stack's ``dense_k`` / ``dense_v`` included)."""
    cfg, jm, jparams, tm, tparams = _models(arch)
    rng = np.random.default_rng(5)
    B, S, L, J = 3, 9, 4, 2
    P0 = prefix_len(cfg)
    assert has_prefix_embeds(cfg) == (cfg.family == "vlm")
    assert P0 == (8 if cfg.family == "vlm" else 0)
    T_tree = J * L + 1
    jcache, tcache, live = _caches(jm, tm, layout, B, rng,
                                   P0 + S + 1 + (L + 1) + T_tree)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    prefix = (rng.standard_normal((B, P0, cfg.d_model)).astype(np.float32)
              if P0 else None)
    jl_, jcache, jaux = jm.prefill(
        jparams, jnp.asarray(tokens), jcache,
        prefix_embeds=None if prefix is None else jnp.asarray(prefix))
    tl_, tcache, taux = tm.prefill(
        tparams, torch.from_numpy(tokens), tcache,
        prefix_embeds=None if prefix is None else torch.from_numpy(prefix))
    assert tl_.shape == (B, P0 + S, cfg.vocab_size)
    np.testing.assert_allclose(tl_.numpy()[live], np.asarray(jl_)[live], **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    leaves = _check_leaves(tcache, jcache)
    assert ("dense_k" in leaves) == (cfg.first_k_dense > 0 and cfg.num_experts > 0)

    pos = np.full(B, P0 + S, np.int32)
    for T in (1, L + 1):
        win = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
        jl_, jcache = jm.forward_window(jparams, jnp.asarray(win), jcache,
                                        jnp.asarray(pos))
        tl_, tcache = tm.forward_window(tparams, torch.from_numpy(win),
                                        tcache, torch.from_numpy(pos))
        np.testing.assert_allclose(tl_.numpy()[live], np.asarray(jl_)[live],
                                   **TOL)
        pos = pos + T
    tree = _tree(rng, B, J, L)
    wm, depth = tree.window_mask(), tree.window_depth().astype(np.int32)
    win = rng.integers(0, cfg.vocab_size, (B, T_tree)).astype(np.int32)
    jl_, jcache = jm.forward_window(jparams, jnp.asarray(win), jcache,
                                    jnp.asarray(pos), window_mask=jnp.asarray(wm),
                                    window_depth=jnp.asarray(depth))
    tl_, tcache = tm.forward_window(tparams, torch.from_numpy(win), tcache,
                                    torch.from_numpy(pos),
                                    window_mask=torch.from_numpy(wm),
                                    window_depth=torch.from_numpy(depth))
    np.testing.assert_allclose(tl_.numpy()[live], np.asarray(jl_)[live], **TOL)
    _check_leaves(tcache, jcache)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_capacities_of_the_entry_points(arch):
    """``apply`` dispatches at the configured factor, ``prefill`` at the
    no-drop factor unless given one, ``forward_window`` always at the
    no-drop factor: the port's logits follow the reference's at each."""
    cfg, jm, jparams, tm, tparams = _models(arch, seed=2)
    assert tm.no_drop_capacity == jm.no_drop_capacity
    rng = np.random.default_rng(8)
    B, S = 3, 12
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    for cf in (None, 1.0, tm.no_drop_capacity):
        want, want_aux = jm.apply(jparams, jnp.asarray(tokens),
                                  moe_capacity=cf)
        got, aux = tm.apply(tparams, torch.from_numpy(tokens), moe_capacity=cf)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    jcache = jm.init_cache(B, 32, jnp.float32)
    tcache = tm.init_cache(B, 32, torch.float32)
    want, _, _ = jm.prefill(jparams, jnp.asarray(tokens), jcache,
                            moe_capacity=1.0)
    got, _, _ = tm.prefill(tparams, torch.from_numpy(tokens), tcache,
                           moe_capacity=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_moe_concat_caches_stacks_every_leaf():
    cfg, jm, _, tm, _ = _models("moonshot-v1-16b-a3b")
    caches = [tm.init_cache(n, 16, torch.float32) for n in (1, 2)]
    for i, c in enumerate(caches):
        for leaf in c.values():
            leaf.fill_(i + 1)
    out = tm.concat_caches(caches)
    assert sorted(out) == ["dense_k", "dense_v", "k", "v"]
    for leaf in out.values():
        assert leaf.shape[1] == 3
        assert (leaf[:, 0] == 1).all() and (leaf[:, 1:] == 2).all()


# ---------------------------------------------------------------------------
# the encoder-decoder
# ---------------------------------------------------------------------------

def test_encdec_apply_prefill_and_steps_match_jax():
    """whisper-large-v3's smoke config: ``apply`` on frames + tokens, then
    ``prefill`` with the frames and 3 one-token decode steps through
    ``forward_window`` and one 3-token window, against the reference:
    logits and every cache leaf (self-attention K/V and the fixed cross
    K/V)."""
    cfg, jm, jparams, tm, tparams = _models("whisper-large-v3")
    assert has_prefix_embeds(cfg) and prefix_len(cfg) == cfg.encoder_seq_len
    rng = np.random.default_rng(9)
    B, S = 2, 5
    frames = rng.standard_normal(
        (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    want, _ = jm.apply(jparams, jnp.asarray(tokens), jnp.asarray(frames))
    got, aux = tm.apply(tparams, torch.from_numpy(tokens),
                        torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == 0.0

    jcache = jm.init_cache(B, 16, jnp.float32)
    tcache = tm.init_cache(B, 16, torch.float32)
    want, jcache, _ = jm.prefill(jparams, jnp.asarray(tokens), jcache,
                                 prefix_embeds=jnp.asarray(frames))
    got, tcache, _ = tm.prefill(tparams, torch.from_numpy(tokens), tcache,
                                prefix_embeds=torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _check_leaves(tcache, jcache)
    pos = np.array([S, S - 2], np.int32)          # ragged rows
    for T in (1, 1, 1, 3):
        win = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
        want, jcache = jm.forward_window(jparams, jnp.asarray(win), jcache,
                                         jnp.asarray(pos))
        got, tcache = tm.forward_window(tparams, torch.from_numpy(win), tcache,
                                        torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        pos = pos + T
    _check_leaves(tcache, jcache)
    with pytest.raises(ValueError, match="frame"):
        tm.prefill(tparams, torch.from_numpy(tokens), tcache)
