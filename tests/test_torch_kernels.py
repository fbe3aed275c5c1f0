"""The port's kernel ops on the CPU: plain versions against the JAX oracles.

Same numpy inputs (fixed seeds) through ``repro.kernels.ref`` (the JAX
package's oracles, as ``tests/test_kernels.py`` holds its Pallas kernels to
them), or through the Pallas kernels in interpret mode, and through
``repro_torch.kernels`` with CPU tensors.  Tolerances are
``_tol`` of ``tests/test_kernels.py``: 2e-5 in float32, 2e-2 in bfloat16;
integer outputs (accept masks, counts, sampled tokens) must be equal.  The
CUDA kernels themselves are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import cases
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import decode_attention_q8 as tdaq
from repro_torch.kernels import fused_verify_sample as tfvs
from repro_torch.kernels import gather_softmax_prob as tgsp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import paged_tree_attention as tpta
from repro_torch.kernels import ref as tref
from repro_torch.kernels import residual_sample as trs
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels import tree_attention as tta

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _page_table(rng, B, n_slots, P, ps, lengths, T, holes=True):
    """Scattered, non-contiguous pages covering each row's window; with
    ``holes`` the slots past the window stay -1 and one row is all -1."""
    pt = np.full((B, n_slots), -1, np.int32)
    pages = rng.permutation(P)
    n = 0
    for b in range(B):
        need = -(-(int(lengths[b]) + T - 1) // ps)
        pt[b, :need] = pages[n:n + need]
        n += need
    if holes and B > 1:
        pt[-1] = -1                 # a retired/padding row: sees no key
    return pt


def _visible(pt, lengths, T, ps):
    """(B, T) rows that see at least one mapped key below their horizon."""
    B, n_slots = pt.shape
    kpos = np.arange(n_slots * ps)
    mapped = np.repeat(pt >= 0, ps, axis=1)
    horizon = lengths[:, None] + np.arange(T)[None]
    return ((kpos[None, None] < horizon[:, :, None])
            & mapped[:, None]).any(-1)


@pytest.mark.parametrize("B,T,H,KV,D,ps,P,n_slots", [
    (3, 1, 4, 2, 64, 16, 24, 8),      # draft step: decode, GQA
    (3, 5, 4, 1, 16, 16, 40, 6),      # verification window, MQA
    (2, 3, 8, 8, 128, 32, 12, 4),     # MHA, big pages
    (2, 9, 4, 2, 16, 8, 30, 12),      # prefill-like window, small pages
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_plain_matches_jax_ref(B, T, H, KV, D, ps, P, n_slots,
                                              dtype):
    rng = np.random.default_rng(B * 100 + T * 10 + D)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, ps, KV, D)).astype(np.float32)
    vp = rng.standard_normal((P, ps, KV, D)).astype(np.float32)
    lengths = rng.integers(1, n_slots * ps - T + 2, B).astype(np.int32)
    pt = _page_table(rng, B, n_slots, P, ps, lengths, T)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(jref.paged_attention_ref(
        jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
        jnp.asarray(pt), jnp.asarray(lengths)), np.float32)
    got = tops.paged_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
        torch.from_numpy(vp).to(tdt), torch.from_numpy(pt),
        torch.from_numpy(lengths)).float().numpy()
    vis = _visible(pt, lengths, T, ps)
    assert vis.any() and not vis.all()
    # rows with a visible key match the oracle; rows without one are 0 in
    # the port (the JAX oracle averages page 0 there instead)
    np.testing.assert_allclose(got[vis], want[vis],
                               **(F32_TOL if dtype == "float32" else BF16_TOL))
    assert np.all(got[~vis] == 0.0)


def test_paged_attention_decode_equals_gathered_gqa():
    """Paging is a pure layout change: T=1 through the page table equals
    masked dense attention over the gathered logical view."""
    from repro_torch.models.layers import gqa_attention, paged_gather_kv

    B, H, KV, D, ps, P, n_slots = 3, 4, 2, 16, 16, 24, 8
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((B, 1, H, D)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((P, ps, KV, D)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((P, ps, KV, D)).astype(np.float32))
    lengths = rng.integers(1, n_slots * ps + 1, B).astype(np.int32)
    pt = torch.from_numpy(_page_table(rng, B, n_slots, P, ps, lengths, 1,
                                      holes=False))
    got = tref.paged_attention_ref(q, kp, vp, pt, torch.from_numpy(lengths))
    mask = (torch.arange(n_slots * ps)[None, :]
            < torch.from_numpy(lengths)[:, None].long())[:, None, None, None]
    want = gqa_attention(q, paged_gather_kv(kp, pt), paged_gather_kv(vp, pt),
                         mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


# (B, KV, rows = T*G, n_slots, ps, SMs): the draft step, the verify window
# and the prefills of the Llama pair on an H100 (a 1024-token table of
# 16-key pages), then small tables, odd page sizes and one SM
SPLIT_SHAPES = [
    (8, 4, 8, 64, 16, 132), (8, 32, 9, 64, 16, 132), (8, 32, 127, 64, 16, 132),
    (8, 4, 1016, 64, 16, 132), (1, 1, 1, 1, 16, 132), (2, 2, 4, 7, 3, 132),
    (3, 1, 16, 40, 1, 132), (1, 2, 17, 100, 32, 132), (4, 4, 8, 64, 16, 1),
    (1, 1, 1, 513, 16, 132),
]


@pytest.mark.parametrize("B,KV,rows,n_slots,ps,n_sm", SPLIT_SHAPES)
def test_paged_attention_split_plan_covers_every_slot_once(B, KV, rows, n_slots,
                                                           ps, n_sm):
    """The bf16 kernel's split of the slot axis is a function of shapes
    alone; its ranges cover every slot exactly once, in order, and no split
    is empty of slots."""
    plan = tpa.split_plan(B, KV, rows, n_slots, ps, n_sm)
    assert plan == tpa.split_plan(B, KV, rows, n_slots, ps, n_sm)
    row_tile, row_tiles, n_split, split_slots = plan
    assert row_tile == (16 if rows <= 16 else 64)
    assert row_tiles * row_tile >= rows > (row_tiles - 1) * row_tile
    ranges = tpa.split_ranges(n_slots, n_split, split_slots)
    assert len(ranges) == n_split >= 1
    covered = [s for a, e in ranges for s in range(a, e)]
    assert covered == list(range(n_slots))
    assert all(e > a for a, e in ranges)
    assert n_split == 1 or split_slots * ps >= tpa.MIN_SPLIT_KEYS


def _merge_splits(q, k, v, seen, key_ranges, k_scale=None, v_scale=None):
    """The bf16 window kernels' partition and merge in plain torch
    (float32), over keys k, v (B, S, KV, D) of which query row t of batch b
    sees ``seen[b, t]``: per key range, the partial (m, l, acc) of the keys
    a row sees, empty (m = -inf, l = 0) where it sees none; then the merge
    the last block makes, in range order, skipping empty partials, 0 for a
    row that saw no key.  The scores' scale is 1/sqrt(D) as a float32;
    over int8 codes (B9) it is that times ``k_scale`` (B, KV), and the
    output is multiplied by ``v_scale`` (B, KV), as the kernel does."""
    B, T, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = torch.full((B, KV), D ** -0.5)
    if k_scale is not None:
        scale = scale * k_scale
    x = (torch.einsum("btkgd,bskd->bkgts", q.reshape(B, T, KV, G, D), k)
         * scale[:, :, None, None, None])
    parts = []
    for first, end in key_ranges:
        keys = slice(first, end)
        ok = seen[:, None, None, :, keys]
        xs = torch.where(ok, x[..., keys], -torch.inf)
        m = xs.amax(-1)
        p = torch.where(ok, torch.exp(xs - torch.nan_to_num(m, neginf=0.0)[..., None]),
                        0.0)
        parts.append((m, p.sum(-1),
                      torch.einsum("bkgts,bskd->bkgtd", p, v[:, keys])))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L = torch.zeros_like(M)
    A = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.where(m == -torch.inf, 0.0, torch.exp(m - M))
        L = L + w * l
        A = A + w[..., None] * acc
    out = torch.where(L[..., None] > 0, A / L.clamp(min=1e-30)[..., None], 0.0)
    if v_scale is not None:
        out = out * v_scale[:, :, None, None, None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, D)


def _split_emulated(q, k_pool, v_pool, page_table, lengths, n_sm):
    """B1's bf16 kernel in plain torch: its slot ranges as key ranges of
    ``_merge_splits``, a row t seeing the mapped keys below lengths + t."""
    B, T, H, D = q.shape
    P, ps, KV, _ = k_pool.shape
    n_slots = page_table.shape[1]
    _, _, n_split, split_slots = tpa.split_plan(B, KV, T * (H // KV), n_slots,
                                                ps, n_sm)
    S = n_slots * ps
    safe = page_table.clamp(min=0).long()
    k = k_pool[safe].reshape(B, S, KV, D)
    v = v_pool[safe].reshape(B, S, KV, D)
    horizon = lengths.long()[:, None] + torch.arange(T)[None]
    seen = ((torch.arange(S)[None, None] < horizon[:, :, None])
            & (page_table >= 0).repeat_interleave(ps, 1)[:, None])
    ranges = tpa.split_ranges(n_slots, n_split, split_slots)
    out = _merge_splits(q, k, v, seen, [(a * ps, e * ps) for a, e in ranges])
    return out, ranges


@pytest.mark.parametrize("B,T,H,KV,D,ctx,width,n_sm,in_first", [
    (8, 1, 8, 4, 16, 300, 64, 132, False),  # draft step, 1024-token table
    (4, 9, 4, 4, 16, 400, 64, 132, False),  # verify window
    (3, 5, 4, 2, 32, 3, 32, 132, True),     # every horizon in the 1st split
    (3, 1, 4, 2, 16, 40, 12, 1, True),      # one SM: one split
    (8, 1, 8, 1, 256, 300, 64, 132, False),   # paligemma step, D = 256
    (4, 9, 16, 16, 256, 200, 32, 132, False),  # gemma verify, D = 256
])
def test_paged_attention_split_merge_matches_ref(B, T, H, KV, D, ctx, width,
                                                 n_sm, in_first):
    """Partials of the split plus their merge equal the plain version (the
    oracle's function) within the float32 band: all-(-1) rows, rows whose
    horizon ends inside the first split, splits past every horizon."""
    q, kp, vp, pt, ln = cases.paged_case(B, T, H, KV, D, 16, ctx,
                                         torch.float32, "cpu", seed=B + T)
    assert width >= pt.shape[1]
    pt = torch.cat([pt, torch.full((B, width - pt.shape[1]), -1,
                                   dtype=torch.int32)], 1)
    got, ranges = _split_emulated(q, kp, vp, pt, ln, n_sm)
    want = tref.paged_attention_ref(q, kp, vp, pt, ln)
    assert (len(ranges) > 1) == (n_sm > 8)
    assert (int(ln.max()) + T - 1 <= ranges[0][1] * 16) == in_first
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)
    if B > 2:
        assert not got[-1].any()        # the all-(-1) row sees no key


# (B, KV, rows = T*G, n_keys, SMs): the Llama-2-7B tree windows on an H100
# (T = 13 and the T = 49 ceiling over a 1024-key table or cache), the card
# tests' small grids, ragged key counts, one chunk, one SM
WINDOW_SPLIT_SHAPES = [
    (8, 32, 13, 1024, 132), (8, 32, 49, 1024, 132), (2, 4, 13, 128, 132),
    (1, 1, 256, 128, 132), (2, 4, 13, 96, 132), (3, 2, 20, 1000, 132),
    (1, 1, 5, 64, 132), (1, 1, 5, 40, 132), (4, 4, 8, 1024, 1),
    (1, 1, 1, 8192, 132),
]


@pytest.mark.parametrize("B,KV,rows,n_keys,n_sm", WINDOW_SPLIT_SHAPES)
def test_window_split_plan_covers_every_key_once(B, KV, rows, n_keys, n_sm):
    """The tree kernels' split of the key axis is a function of shapes
    alone; its ranges are runs of whole 64-key chunks that cover every key
    exactly once, in order, none empty; only a grid of fewer blocks than
    SMs splits."""
    plan = tpa.window_split_plan(B, KV, rows, n_keys, n_sm)
    assert plan == tpa.window_split_plan(B, KV, rows, n_keys, n_sm)
    row_tile, row_tiles, n_split, split_keys = plan
    assert row_tile == (16 if rows <= 16 else 64)
    assert row_tiles * row_tile >= rows > (row_tiles - 1) * row_tile
    assert split_keys % tpa.CHUNK_KEYS == 0
    ranges = tpa.window_split_ranges(n_keys, n_split, split_keys)
    assert len(ranges) == n_split >= 1
    assert [k for a, e in ranges for k in range(a, e)] == list(range(n_keys))
    assert all(e > a for a, e in ranges)
    blocks = B * KV * row_tiles
    assert (n_split > 1) == (blocks < n_sm and n_keys > tpa.CHUNK_KEYS)
    assert n_split == 1 or blocks * n_split <= 2 * tpa.BLOCKS_PER_SM * n_sm


@pytest.mark.parametrize("S,ps", [(64, 16), (96, 16), (128, 8), (1024, 16),
                                  (1000, 8), (40, 8)])
@pytest.mark.parametrize("B,T,H,KV", [(2, 13, 4, 4), (1, 64, 4, 1),
                                      (8, 13, 32, 32), (3, 5, 8, 2)])
def test_tree_split_plans_agree_on_as_pages_layouts(S, ps, B, T, H, KV):
    """B3 over the pages of ``cases.as_pages`` (n_slots * ps == S) and B6
    over the cache cut their keys at the same positions, so they walk the
    same chunks: what keeps B6's chain mask bit-equal to B3's."""
    q = torch.zeros((B, T, H, 16))
    kc = torch.zeros((B, S, KV, 16))
    kp, _, table = cases.as_pages(kc, kc, ps)
    for n_sm in (1, 8, 132):
        paged = tpta.split_plan(q, kp, table, n_sm)
        contiguous = tta.split_plan(q, kc, n_sm)
        assert paged == contiguous
        assert (tpa.window_split_ranges(table.shape[1] * ps, *paged[2:])
                == tpa.window_split_ranges(S, *contiguous[2:]))


def _tree_split_inputs(seed, B, J, L, H, KV, D, S, ps, lengths):
    """Numpy inputs of a T = J*L+1 tree window over a (B, S, KV, D) cache
    and the same keys scattered over pages of ``ps`` (one more batch row,
    retired: its table all -1), with the ancestor masks of ``tree_mask``."""
    rng = np.random.default_rng(seed)
    T = J * L + 1
    q = rng.standard_normal((B + 1, T, H, D)).astype(np.float32)
    kc = rng.standard_normal((B + 1, S, KV, D)).astype(np.float32)
    vc = rng.standard_normal((B + 1, S, KV, D)).astype(np.float32)
    n_slots = S // ps
    pages = rng.permutation((B + 1) * n_slots + 3)
    kp = rng.standard_normal((pages.size, ps, KV, D)).astype(np.float32)
    vp = rng.standard_normal((pages.size, ps, KV, D)).astype(np.float32)
    pt = np.full((B + 1, n_slots), -1, np.int32)
    for b in range(B):
        pt[b] = pages[b * n_slots:(b + 1) * n_slots]
        kp[pt[b]] = kc[b].reshape(n_slots, ps, KV, D)
        vp[pt[b]] = vc[b].reshape(n_slots, ps, KV, D)
    ln = np.array(list(lengths) + [ps + 1], np.int32)
    mask = cases.tree_mask(B + 1, J, L, seed=seed).numpy()
    return q, kc, vc, kp, vp, pt, ln, mask


def _tree_seen(lengths, mask, S):
    """(B, T, S) bool: the keys each tree row sees in a contiguous cache."""
    ln, wm = torch.as_tensor(lengths).long(), torch.as_tensor(mask)
    B, T = wm.shape[:2]
    w = torch.arange(S)[None] - ln[:, None]
    allow = wm.gather(2, w.clamp(0, T - 1)[:, None].expand(B, T, S))
    return ((w < 0)[:, None] | (allow & ((w >= 0) & (w < T))[:, None]))


# name, (B, J, L, H, KV, D, S, ps), lengths, SMs: the window of row 0 in
# the last split while row 1's splits past its window are empty; G > 1 on
# 64-row tiles; T = 64 across a split boundary; one SM (no split)
TREE_SPLIT_CASES = [
    ("window in the last split", (2, 2, 2, 4, 2, 16, 256, 16), [250, 10], 132),
    ("G > 1, 64-row tiles", (2, 2, 6, 8, 2, 32, 192, 8), [100, 37], 132),
    ("T = 64 across a split", (1, 7, 9, 4, 1, 32, 128, 16), [60], 132),
    ("one SM: one split", (2, 2, 3, 4, 2, 16, 128, 16), [90, 3], 1),
    ("D = 256, G = 8 on 64-row tiles", (2, 2, 6, 8, 1, 256, 256, 16),
     [200, 40], 132),
]


@pytest.mark.parametrize("case", TREE_SPLIT_CASES,
                         ids=[c[0] for c in TREE_SPLIT_CASES])
def test_tree_split_merge_matches_ref(case):
    """The bf16 tree kernels' split partials plus their merge, emulated in
    plain torch, equal the plain B3 and B6 (and the JAX oracles on the rows
    they agree on) within the float32 band: rows whose window lies in the
    last split, empty splits, an all-(-1) row (0), G > 1."""
    name, (B, J, L, H, KV, D, S, ps), lengths, n_sm = case
    q, kc, vc, kp, vp, pt, ln, mask = _tree_split_inputs(
        len(name), B, J, L, H, KV, D, S, ps, lengths)
    T = J * L + 1
    tq, tkc, tvc, tkp, tvp, tpt, tln, tmask = map(
        torch.from_numpy, (q, kc, vc, kp, vp, pt, ln, mask))
    _, _, n_split, split_keys = tta.split_plan(tq, tkc, n_sm)
    assert (n_split, split_keys) == tpta.split_plan(tq, tkp, tpt, n_sm)[2:]
    assert (n_split > 1) == (n_sm > 1)
    ranges = tpa.window_split_ranges(S, n_split, split_keys)
    seen = _tree_seen(ln, mask, S)
    # B6 over the cache
    got = _merge_splits(tq, tkc, tvc, seen, ranges)
    np.testing.assert_allclose(
        got.numpy(), tref.tree_attention_ref(tq, tkc, tvc, tln, tmask).numpy(),
        **F32_TOL)
    want = np.asarray(jref.tree_attention_ref(
        *(jnp.asarray(a) for a in (q, kc, vc, ln, mask))))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    # B3 through the pages: the same answer, the retired row 0
    mapped = (tpt >= 0).repeat_interleave(ps, 1)[:, None]
    safe = tpt.clamp(min=0).long()
    got_p = _merge_splits(tq, tkp[safe].reshape(B + 1, S, KV, D),
                          tvp[safe].reshape(B + 1, S, KV, D), seen & mapped,
                          ranges)
    np.testing.assert_allclose(
        got_p.numpy(),
        tref.paged_tree_attention_ref(tq, tkp, tvp, tpt, tln, tmask).numpy(),
        **F32_TOL)
    want_p = np.asarray(jref.paged_tree_attention_ref(
        *(jnp.asarray(a) for a in (q, kp, vp, pt, ln, mask))))
    np.testing.assert_allclose(got_p[:B].numpy(), want_p[:B], **F32_TOL)
    np.testing.assert_allclose(got_p[:B].numpy(), got[:B].numpy(), **F32_TOL)
    assert not got_p[B].any()           # the all-(-1) row sees no key
    if name == "window in the last split":
        first_last = ranges[-1][0]
        assert first_last <= lengths[0] and lengths[0] + T <= S
        assert not seen[1, :, first_last:].any()     # row 1: empty splits


# (B, H, KV, S, SMs, n_split, split_keys): B7's phase-3 steps on an H100
# (the TinyLlama draft step, the B=4 edge case, the Zamba2 and Llama-2-7B
# steps), then the smoke steps (target and draft of the smoke engine over
# max_len 96, the plain engine's over 48), None where the test derives it
DECODE_SPLIT_SHAPES = [
    (8, 32, 4, 1024, 132, 8, 128), (4, 32, 4, 1024, 132, 16, 64),
    (8, 32, 32, 1024, 132, 1, 1024), (8, 32, 32, 1024, 132, 1, 1024),
    (3, 4, 2, 96, 132, None, None), (3, 2, 1, 96, 132, None, None),
    (3, 4, 2, 48, 132, None, None), (4, 32, 4, 1024, 1, 1, 1024),
]


@pytest.mark.parametrize("B,H,KV,S,n_sm,n_split,split_keys",
                         DECODE_SPLIT_SHAPES)
def test_decode_split_plan_covers_every_key_once(B, H, KV, S, n_sm, n_split,
                                                 split_keys):
    """B7's bf16 split of the key axis is ``window_split_plan`` over S for
    the G = H / KV heads of a kv head (one 16-row tile), from shapes alone:
    runs of whole 64-key chunks covering every key once, none empty."""
    q, kc = torch.empty((B, H, 1)), torch.empty((B, S, KV, 1))
    plan = tda.split_plan(q, kc, n_sm)
    assert plan == tpa.window_split_plan(B, KV, H // KV, S, n_sm)
    row_tile, row_tiles, got_split, got_keys = plan
    assert (row_tile, row_tiles) == (16, 1)
    if n_split is not None:
        assert (got_split, got_keys) == (n_split, split_keys)
    ranges = tpa.window_split_ranges(S, got_split, got_keys)
    assert [k for a, e in ranges for k in range(a, e)] == list(range(S))
    assert all(e > a for a, e in ranges)
    assert (got_split > 1) == (B * KV < n_sm and S > tpa.CHUNK_KEYS)


# name, (B, H, KV, D, S), lengths: every grid splits (fewer blocks than SMs)
DECODE_SPLIT_CASES = [
    ("a split row of length 0", (3, 8, 2, 16, 256), [0, 200, 37]),
    ("lengths past S", (2, 8, 4, 32, 192), [250, 192]),
    ("G = 8 at D = 80", (2, 8, 1, 80, 320), [300, 65]),
    ("G = 8 at D = 256", (2, 8, 1, 256, 512), [500, 3]),
    ("gemma-7b heads at D = 256", (2, 16, 16, 256, 300), [300, 17]),
]


@pytest.mark.parametrize("case", DECODE_SPLIT_CASES,
                         ids=[c[0] for c in DECODE_SPLIT_CASES])
def test_decode_split_merge_matches_ref(case):
    """B7's bf16 split partials plus their merge, emulated in plain torch
    (``_merge_splits`` over a one-row window), equal the JAX oracle within
    the float32 band on every row that sees a key; a row of length 0 gives
    0, as the kernel (the oracle's mean there is never committed)."""
    name, (B, H, KV, D, S), lengths = case
    rng = np.random.default_rng(len(name))
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    vc = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    ln = np.array(lengths, np.int32)
    tq, tkc, tvc, tln = map(torch.from_numpy, (q, kc, vc, ln))
    _, _, n_split, split_keys = tda.split_plan(tq, tkc, 132)
    assert n_split > 1
    ranges = tpa.window_split_ranges(S, n_split, split_keys)
    seen = (torch.arange(S)[None] < tln.long()[:, None])[:, None]
    got = _merge_splits(tq[:, None], tkc, tvc, seen, ranges)[:, 0]
    live = tln > 0
    want = np.asarray(jref.decode_attention_ref(
        *(jnp.asarray(a) for a in (q, kc, vc, ln))))
    np.testing.assert_allclose(got[live].numpy(), want[live.numpy()], **F32_TOL)
    np.testing.assert_allclose(
        got[live].numpy(),
        tref.decode_attention_ref(tq, tkc, tvc, tln)[live].numpy(), **F32_TOL)
    assert not got[~live].any()


@pytest.mark.parametrize("b,h,p,n_sm,plan", [
    (8, 80, 64, 132, (64, 1)),      # Zamba2-2.7B prefill: 640 blocks
    (1, 80, 64, 132, (32, 2)),      # one row: 80 blocks, p cut in two
    (8, 24, 64, 132, (64, 1)),      # mamba2-130m heads: 192 blocks
    (2, 8, 16, 132, (16, 1)),       # smoke widths: no narrower slice
    (2, 4, 32, 132, (16, 2)),
    (1, 1, 48, 132, (16, 3)),
    (1, 2, 64, 1, (64, 1)),
])
def test_ssd_split_plan_cuts_p_only_below_the_sm_count(b, h, p, n_sm, plan):
    assert tssd.split_plan(b, h, p, n_sm) == plan
    p_block, n_slices = plan
    assert p_block * n_slices == p and p_block in tssd.P_BLOCKS


def _ssd_tc_emulated(x, dt, A, B, C, chunk, init, n_sm):
    """The bf16 B10 kernel's arithmetic in plain torch (float32): per slice
    of p (``split_plan``) and chunk, dt folded into scores' = C B^T
    exp(acum_i - acum_j) dt_j (causal) and B'[j] = exp(acum_last - acum_j)
    dt_j B[j]; each float32 operand of a product (scores', the state, B')
    rounded to bf16 hi + lo; y = exp(acum_i) C state^T + scores' x; state <-
    exp(acum_last) state + x^T B'."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    p_block, n_slices = tssd.split_plan(b, h, p, n_sm)

    def parts(t):
        hi = t.to(torch.bfloat16).float()
        return hi + (t - hi).to(torch.bfloat16).float()

    Bh = B.repeat_interleave(h // g, dim=2)
    Ch = C.repeat_interleave(h // g, dim=2)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    y = torch.zeros((b, s, h, p))
    fs = torch.zeros((b, h, p, n))
    for sl in range(n_slices):
        cols = slice(sl * p_block, (sl + 1) * p_block)
        st = (torch.zeros((b, h, p_block, n)) if init is None
              else init[:, :, cols].clone())
        for c in range(s // chunk):
            rows = slice(c * chunk, (c + 1) * chunk)
            xc = x[:, rows, :, cols].permute(0, 2, 1, 3)      # (b, h, L, pb)
            Bc = Bh[:, rows].permute(0, 2, 1, 3)               # (b, h, L, n)
            Cc = Ch[:, rows].permute(0, 2, 1, 3)
            dtc = dt[:, rows].permute(0, 2, 1)                 # (b, h, L)
            acum = torch.cumsum(A[None, :, None] * dtc, -1)
            last = acum[..., -1:]
            decay = torch.exp(acum[..., :, None] - acum[..., None, :])
            sc = torch.where(causal, (Cc @ Bc.transpose(-1, -2)) * decay
                             * dtc[..., None, :], 0.0)
            yc = (torch.exp(acum)[..., None]
                  * (Cc @ parts(st).transpose(-1, -2)) + parts(sc) @ xc)
            y[:, rows, :, cols] = yc.permute(0, 2, 1, 3)
            Bp = parts((torch.exp(last - acum) * dtc)[..., None] * Bc)
            st = torch.exp(last)[..., None] * st + xc.transpose(-1, -2) @ Bp
        fs[:, :, cols] = st
    return y, fs


# name, (b, s, h, p, g, n, chunk), initial state, SMs
SSD_TC_CASES = [
    ("chunk 64, initial state, p cut", (2, 128, 4, 32, 1, 16, 64), True, 132),
    ("chunk 64, no initial state", (1, 128, 2, 64, 1, 32, 64), False, 1),
    ("chunk 8, smoke widths", (2, 32, 8, 16, 1, 16, 8), False, 132),
    ("chunk 8, initial state", (2, 24, 2, 16, 1, 16, 8), True, 132),
    ("g = 2, p cut", (2, 64, 4, 32, 2, 16, 16), True, 132),
]


@pytest.mark.parametrize("case", SSD_TC_CASES, ids=[c[0] for c in SSD_TC_CASES])
def test_ssd_tensor_core_arithmetic_matches_ref(case):
    """The bf16 kernel's refactored arithmetic (dt folded into scores' and
    B', each float32 operand in bf16 hi + lo parts, p cut by the plan),
    emulated in plain torch on bf16-exact x, B and C, equals the JAX
    oracle within the float32 bands on y and on the final state."""
    name, (b, s, h, p, g, n, chunk), init, n_sm = case
    rng = np.random.default_rng(len(name))

    def bf16_exact(*shape):
        t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return t.to(torch.bfloat16).float().numpy()

    x = bf16_exact(b, s, h, p)
    Bm, C = bf16_exact(b, s, g, n), bf16_exact(b, s, g, n)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    st = rng.standard_normal((b, h, p, n)).astype(np.float32) if init else None
    got_y, got_fs = _ssd_tc_emulated(
        *map(torch.from_numpy, (x, dt, A, Bm, C)), chunk,
        None if st is None else torch.from_numpy(st), n_sm)
    want_y, want_fs = jref.ssd_scan_ref(
        *(jnp.asarray(a) for a in (x, dt, A, Bm, C)), chunk=chunk,
        initial_state=None if st is None else jnp.asarray(st))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               rtol=cases.SSD_TOL[torch.float32][0],
                               atol=cases.SSD_TOL[torch.float32][1])
    np.testing.assert_allclose(got_fs.numpy(), np.asarray(want_fs),
                               rtol=cases.SSD_STATE_TOL[0],
                               atol=cases.SSD_STATE_TOL[1])


def _fused_inputs(seed, B, L, V, vhat):
    """Valid verification inputs from numpy: drafts drawn from the uploaded
    truncated distribution, so accept and reject both occur."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, L + 1, V)) * 2.0).astype(np.float32)
    z = rng.standard_normal((B, L, V)) * 2.0
    q = np.exp(z - z.max(-1, keepdims=True))
    q /= q.sum(-1, keepdims=True)
    idx = np.argsort(-q, axis=-1, kind="stable")[..., :vhat].astype(np.int32)
    val = np.take_along_axis(q, idx, -1)
    val = (val / val.sum(-1, keepdims=True)).astype(np.float32)
    j = np.array([[rng.choice(vhat, p=val[b, l] / val[b, l].sum())
                   for l in range(L)] for b in range(B)])
    tokens = np.take_along_axis(idx, j[..., None], -1)[..., 0]
    probs = np.take_along_axis(val, j[..., None], -1)[..., 0]
    u_acc = rng.random((B, L)).astype(np.float32)
    u_res = rng.random(B).astype(np.float32)
    return logits, tokens, probs, idx, val, u_acc, u_res


@pytest.mark.parametrize("B,L,V,vhat,dlen", [
    (2, 4, 512, 16, None),
    (3, 3, 1000, 32, None),
    (1, 6, 2048, 8, None),
    (3, 5, 640, 16, [5, 2, 1]),     # ragged draft lengths
])
@pytest.mark.parametrize("seed", [20, 21])
def test_fused_verify_sample_plain_matches_jax_ref(B, L, V, vhat, dlen, seed):
    arrs = _fused_inputs(seed, B, L, V, vhat)
    dlen = np.full(B, L, np.int32) if dlen is None else np.asarray(dlen, np.int32)
    want = jref.fused_verify_sample_ref(*(jnp.asarray(a) for a in arrs),
                                        jnp.asarray(dlen))
    got = tops.fused_verify_sample(*(torch.from_numpy(a) for a in arrs),
                                   torch.from_numpy(dlen))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    acc = got[0].numpy()
    for b, n in enumerate(dlen):
        assert not acc[b, n:].any()


# (B, V, SMs, resident blocks, C): the Llama and Qwen3.5 pairs on an H100
# (B = 8: 16 chunks), one row (132 chunks, V not a multiple of C), B at and
# past the SM count (C = 1), a resident count under the wish, V short of
# the wish (V < C: 1 chunk), V shorter than a chunk, the card tests' V = 300
VOCAB_SPLIT_SHAPES = [
    (8, 32000, 132, 1056, 16), (8, 151936, 132, 1056, 16),
    (1, 32000, 132, 1056, 132), (132, 32000, 132, 1056, 1),
    (300, 32000, 132, 1056, 1), (8, 32000, 132, 40, 5),
    (1, 100, 132, 1056, 1), (1, 5, 132, 1056, 1), (1, 300, 132, 1056, 4),
    (3, 257, 132, 1056, 4), (4, 20000, 132, 528, 33),
]


@pytest.mark.parametrize("B,V,n_sm,resident,C", VOCAB_SPLIT_SHAPES)
def test_vocab_split_plan_covers_every_entry_once(B, V, n_sm, resident, C):
    """B2's chunks of the vocabulary come from shapes alone, cover [0, V)
    exactly once in order, none empty; B x C stays within one wave of the
    SMs and within the resident blocks (the cooperative launch's limit),
    so C = 1 once B alone fills the SMs."""
    plan = tfvs.vocab_split_plan(B, V, n_sm, resident)
    got_c, chunk = plan
    assert got_c == C
    ranges = tfvs.vocab_split_ranges(V, got_c, chunk)
    assert [v for a, e in ranges for v in range(a, e)] == list(range(V))
    assert all(e > a for a, e in ranges)
    assert got_c == 1 or B * got_c <= min(n_sm, resident)
    assert (got_c == 1) >= (B >= n_sm)
    assert got_c == 1 or chunk >= tfvs.MIN_CHUNK


def _fused_split_emulated(args, C, chunk):
    """B2's split across the vocabulary in plain torch (float32): per chunk
    the softmax partial (m, s) of every drafted row, merged in chunk order;
    the accept test and prefix count; per chunk the residual mass of row
    sel and its argmax(p); the masses added in chunk order (Z); Z <= 0 gives
    the merged argmax; else the chunk whose prefix crosses u * Z scans its
    entries from the masses before it (its last positive entry should its
    own sums fall short); no crossing gives V - 1."""
    logits, tokens, probs, q_idx, q_val, u_acc, u_res, dlen = args
    B, L = tokens.shape
    V = logits.shape[-1]
    ranges = tfvs.vocab_split_ranges(V, C, chunk)
    x = logits[:, :L]
    m = torch.stack([x[..., a:e].amax(-1) for a, e in ranges], -1)
    s = torch.stack([torch.exp(x[..., a:e] - m[..., i, None]).sum(-1)
                     for i, (a, e) in enumerate(ranges)], -1)
    M = m.amax(-1)
    Z = torch.zeros_like(M)
    for i in range(C):
        Z = Z + s[..., i] * torch.exp(m[..., i] - M)
    p_t = torch.exp(x.gather(-1, tokens.long()[..., None])[..., 0] - M) / Z
    accept = u_acc < torch.clamp(p_t / torch.clamp(probs, min=1e-30), max=1.0)
    accept &= torch.arange(L)[None] < dlen.long()[:, None]
    n_acc = torch.cumprod(accept.int(), -1).sum(-1).int()
    calibrated = torch.empty(B, dtype=torch.int32)
    for b in range(B):
        sel = min(int(n_acc[b]), L - 1)
        p = torch.exp(x[b, sel] - M[b, sel]) / Z[b, sel]
        q = torch.zeros(V).index_add_(0, q_idx[b, sel].long(), q_val[b, sel])
        r = torch.clamp(p - q, min=0.0)
        mass = [r[a:e].sum() for a, e in ranges]
        zr = torch.zeros(())
        for w in mass:
            zr = zr + w
        if zr <= 0:
            best = [(p[a:e].max(), a + int(p[a:e].argmax())) for a, e in ranges]
            token = best[0]
            for cand in best[1:]:
                if cand[0] > token[0]:
                    token = cand
            calibrated[b] = token[1]
            continue
        target = u_res[b] * zr
        run, cross = torch.zeros(()), None
        for i, w in enumerate(mass):
            if run + w > target:
                cross = i
                break
            run = run + w
        if cross is None:
            calibrated[b] = V - 1
            continue
        a, e = ranges[cross]
        hit = ((run + torch.cumsum(r[a:e], 0)) > target).nonzero()
        calibrated[b] = a + int(hit[0] if len(hit)
                                else (r[a:e] > 0).nonzero()[-1])
    return accept, n_acc, calibrated


@pytest.mark.parametrize("B,L,V,vhat,n_sm", [
    (3, 4, 512, 16, 132),      # 8 chunks of 64
    (4, 5, 1000, 32, 132),     # 15 chunks of 67: V not a multiple of C
    (1, 3, 2048, 8, 132),      # one row: 32 chunks
    (4, 4, 300, 16, 2),        # B past the SMs: C = 1
    (8, 8, 4000, 64, 132),     # the Llama pair's B, L and Vhat: 16 chunks
])
@pytest.mark.parametrize("seed", [30, 31])
def test_fused_verify_split_arithmetic_matches_jax_ref(B, L, V, vhat, n_sm,
                                                       seed):
    """B2's split arithmetic, emulated in plain torch, against the JAX
    oracle: accept and n_acc equal, the calibrated token equal or at a CDF
    step (``cases.residual_boundary_ok``); with B >= 2 rows 0 and 1 carry a
    residual of Z = 0 (the token is argmax(p)) and one where nothing
    crosses (V - 1) (``cases.verify_edge_rows``)."""
    arrs = _fused_inputs(seed, B, L, V, vhat)
    dlen = np.random.default_rng(seed).integers(1, L + 1, B).astype(np.int32)
    args = tuple(map(torch.from_numpy, (*arrs, dlen)))
    if B >= 2:
        args = cases.verify_edge_rows(args)
    C, chunk = tfvs.vocab_split_plan(B, V, n_sm, 32 * n_sm)
    assert (C > 1) == (B < n_sm)
    got = _fused_split_emulated(args, C, chunk)
    want = [torch.from_numpy(np.array(w)) for w in
            jref.fused_verify_sample_ref(*(jnp.asarray(a.numpy())
                                           for a in args))]
    assert torch.equal(got[0], want[0].bool())
    assert torch.equal(got[1], want[1].int())
    for b in (got[2] != want[2].int()).nonzero().flatten().tolist():
        assert cases.residual_boundary_ok([a[b] for a in args], int(got[1][b]),
                                          int(got[2][b]), int(want[2][b]))
    if B >= 2:
        sel = min(int(got[1][0]), L - 1)
        assert int(got[2][0]) == int(want[2][0]) == int(args[1][0, sel])
        assert int(got[2][1]) == int(want[2][1]) == V - 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_softmax_prob_and_residual_sample_match_jax_ref(seed):
    rng = np.random.default_rng(seed)
    N, V = 6, 300
    logits = (rng.standard_normal((N, V)) * 3).astype(np.float32)
    ids = rng.integers(0, V, N).astype(np.int32)
    np.testing.assert_allclose(
        tref.gather_softmax_prob_ref(torch.from_numpy(logits),
                                     torch.from_numpy(ids)).numpy(),
        np.asarray(jref.gather_softmax_prob_ref(jnp.asarray(logits),
                                                jnp.asarray(ids))), **F32_TOL)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    q = np.roll(p, 1, axis=-1)
    q[0] = p[0]                             # degenerate row: argmax(p)
    u = rng.random(N).astype(np.float32)
    want = np.asarray(jref.residual_sample_ref(jnp.asarray(p), jnp.asarray(q),
                                               jnp.asarray(u)))
    got = tref.residual_sample_ref(torch.from_numpy(p), torch.from_numpy(q),
                                   torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == p[0].argmax()


# (N, V, SMs, C): B4's tree nodes (2 chunks a row at N = 96), B5's rows (33
# chunks of 972 at N = 8), the rows outnumbering the SMs (C = 1), one row
# (chunks of ROW_MIN_CHUNK), the card tests' unaligned V = 4097 (16 chunks
# of 260), V shorter than a chunk, V = 1 (chunk rounded up to 4)
ROW_SPLIT_SHAPES = [
    (96, 32000, 132, 2), (384, 32000, 132, 1), (96, 151936, 132, 2),
    (8, 32000, 132, 33), (8, 151936, 132, 33), (132, 32000, 132, 2),
    (133, 32000, 132, 1), (1, 32000, 132, 125), (5, 4097, 132, 16),
    (5, 300, 132, 1), (3, 1, 132, 1), (8, 4000, 132, 15), (4, 2500, 2, 1),
]


@pytest.mark.parametrize("N,V,n_sm,C", ROW_SPLIT_SHAPES)
def test_row_split_plan_covers_every_entry_once(N, V, n_sm, C):
    """The samplers' chunks (B4, B5) come from shapes alone, cover [0, V)
    exactly once in order, none empty, each a multiple of 4 entries (a
    16-byte-aligned row stays aligned at every edge); N * C stays within
    ``ROW_BLOCKS_PER_SM`` blocks a SM, so C = 1 once the rows outnumber the
    SMs."""
    got_c, chunk = tfvs.row_split_plan(N, V, n_sm)
    assert got_c == C
    ranges = tfvs.vocab_split_ranges(V, got_c, chunk)
    assert [v for a, e in ranges for v in range(a, e)] == list(range(V))
    assert all(e > a for a, e in ranges)
    assert chunk % 4 == 0
    assert got_c == 1 or N * got_c <= tfvs.ROW_BLOCKS_PER_SM * n_sm
    assert (got_c == 1) >= (N > n_sm)
    assert got_c == 1 or chunk >= tfvs.ROW_MIN_CHUNK


def _softmax_split_emulated(logits, ids, C, chunk):
    """B4's split in plain torch (float32): per chunk the softmax partial
    (m, s), merged max first, then each chunk's sum rescaled to it once and
    added in chunk order; the picked logit of the clamped id."""
    N, V = logits.shape
    ranges = tfvs.vocab_split_ranges(V, C, chunk)
    m = torch.stack([logits[:, a:e].amax(-1) for a, e in ranges], -1)
    s = torch.stack([torch.exp(logits[:, a:e] - m[:, k, None]).sum(-1)
                     for k, (a, e) in enumerate(ranges)], -1)
    M = m.amax(-1)
    S = torch.zeros_like(M)
    for k in range(C):
        S = S + s[:, k] * torch.exp(m[:, k] - M)
    pick = logits.gather(-1, ids.long().clamp(0, V - 1)[:, None])[:, 0]
    return torch.exp(pick - M) / S


@pytest.mark.parametrize("N,V,n_sm", [
    (96, 4000, 132),     # the tree path's N: 2 chunks of 2000
    (5, 4097, 132),      # 16 chunks of 260, rows not 16-byte aligned
    (1, 3000, 132),      # one row: 11 chunks
    (8, 2500, 2),        # rows past the SMs: C = 1
    (3, 1, 132),         # V = 1
])
@pytest.mark.parametrize("seed", [40, 41])
def test_gather_softmax_split_arithmetic_matches_jax_ref(N, V, n_sm, seed):
    """B4's split arithmetic, emulated in plain torch, against the JAX
    oracle within ``cases.GATHER_TOL``; rows pick their argmax, their argmin
    and random entries."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((N, V)) * 3).astype(np.float32)
    ids = rng.integers(0, V, N).astype(np.int32)
    ids[0] = logits[0].argmax()
    ids[-1] = logits[-1].argmin()
    C, chunk = tfvs.row_split_plan(N, V, n_sm)
    assert (C > 1) == (N <= n_sm and V >= 2 * tfvs.ROW_MIN_CHUNK)
    got = _softmax_split_emulated(torch.from_numpy(logits),
                                  torch.from_numpy(ids), C, chunk)
    want = np.asarray(jref.gather_softmax_prob_ref(jnp.asarray(logits),
                                                   jnp.asarray(ids)))
    rtol, atol = cases.GATHER_TOL
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


def _residual_split_emulated(p, q, u, C, chunk):
    """B5's split in plain torch (float32): per chunk the residual mass and
    argmax(p) (first index); the masses added in chunk order (Z); Z <= 0
    gives the merged argmax, ties to the smaller index; else the chunk whose
    prefix first exceeds u * Z scans its entries from the masses before it
    (its last positive entry should its own sums fall short); no crossing
    gives V - 1."""
    N, V = p.shape
    ranges = tfvs.vocab_split_ranges(V, C, chunk)
    out = torch.empty(N, dtype=torch.int32)
    for n in range(N):
        r = torch.clamp(p[n] - q[n], min=0.0)
        mass = [r[a:e].sum() for a, e in ranges]
        zr = torch.zeros(())
        for w in mass:
            zr = zr + w
        if zr <= 0:
            best = [(p[n, a:e].max(), a + int(p[n, a:e].argmax()))
                    for a, e in ranges]
            token = best[0]
            for cand in best[1:]:
                if cand[0] > token[0]:
                    token = cand
            out[n] = token[1]
            continue
        target = u[n] * zr
        run, cross = torch.zeros(()), None
        for k, w in enumerate(mass):
            if run + w > target:
                cross = k
                break
            run = run + w
        if cross is None:
            out[n] = V - 1
            continue
        a, e = ranges[cross]
        hit = ((run + torch.cumsum(r[a:e], 0)) > target).nonzero()
        out[n] = a + int(hit[0] if len(hit) else (r[a:e] > 0).nonzero()[-1])
    return out


def _residual_inputs(seed, N, V, chunk, vhat=32):
    """(p, q, u) from numpy: p a softmax row, q a top-``vhat`` draft row
    scattered dense (as ``verify_tree`` builds it), u uniform.  Row 0 has
    q == p (Z = 0: argmax(p)); row 1 q == p with p's maximum tied by an
    entry one chunk away, or half the row with one chunk (the first index
    wins); row 2 u = 1.5 (nothing crosses: V - 1)."""
    rng = np.random.default_rng(seed)

    def softmax(z):
        e = np.exp(z - z.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    p = softmax(rng.standard_normal((N, V)) * 3).astype(np.float32)
    d = softmax(rng.standard_normal((N, V)) * 3)
    idx = np.argsort(-d, axis=-1, kind="stable")[:, :vhat]
    val = np.take_along_axis(d, idx, -1)
    q = np.zeros((N, V), np.float32)
    np.put_along_axis(q, idx, (val / val.sum(-1, keepdims=True)), -1)
    u = rng.random(N).astype(np.float32)
    q[0] = p[0]
    top = int(p[1].argmax())
    twin = top + chunk if top + chunk < V else top - chunk
    if not 0 <= twin < V:        # one chunk: half the row away
        twin = (top + V // 2) % V
    p[1, twin] = p[1, top]
    q[1] = p[1]
    u[2] = 1.5
    return p, q, u, min(top, twin)


@pytest.mark.parametrize("N,V,n_sm", [
    (8, 4000, 132),      # the tree path's N: 15 chunks of 268
    (5, 4097, 132),      # 16 chunks of 260, rows not 16-byte aligned
    (3, 32000, 132),     # 88 chunks of 364
    (8, 300, 132),       # V shorter than two chunks: C = 1
    (6, 2000, 2),        # rows past the SMs: C = 1
])
@pytest.mark.parametrize("seed", [50, 51])
def test_residual_sample_split_arithmetic_matches_jax_ref(N, V, n_sm, seed):
    """B5's split arithmetic, emulated in plain torch, against the JAX
    oracle: each token equal or at a CDF step (``cases.cdf_step_ok``); the
    Z = 0 row gives argmax(p), the tie of p's maxima across two chunks its
    first index, and the row where nothing crosses V - 1."""
    C, chunk = tfvs.row_split_plan(N, V, n_sm)
    assert (C > 1) == (N <= n_sm and V >= 2 * tfvs.ROW_MIN_CHUNK)
    p, q, u, first = _residual_inputs(seed, N, V, chunk)
    if C > 1:
        tied = np.flatnonzero(p[1] == p[1].max())
        assert len(tied) == 2 and tied[0] // chunk != tied[1] // chunk
    tp, tq, tu = map(torch.from_numpy, (p, q, u))
    got = _residual_split_emulated(tp, tq, tu, C, chunk)
    want = torch.from_numpy(np.asarray(jref.residual_sample_ref(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(u))).astype(np.int32))
    for n in (got != want).nonzero().flatten().tolist():
        assert cases.cdf_step_ok(tp[n], tq[n], tu[n], got[n], want[n])
    assert int(got[0]) == int(want[0]) == int(p[0].argmax())
    assert int(got[1]) == int(want[1]) == first
    assert int(got[2]) == int(want[2]) == V - 1


def test_residual_sample_saturates_at_last_token_when_nothing_crosses():
    """Both reference versions return V - 1 when u * Z is at or past the
    last CDF value (the Pallas kernel returns argmax(p) there)."""
    p = torch.tensor([[0.5, 0.3, 0.2]])
    q = torch.zeros_like(p)
    u = torch.tensor([1.0])
    assert int(tref.residual_sample_ref(p, q, u)[0]) == 2
    assert int(np.asarray(jref.residual_sample_ref(
        jnp.asarray(p.numpy()), jnp.asarray(q.numpy()),
        jnp.asarray(u.numpy())))[0]) == 2


# ---------------------------------------------------------------------------
# the tree round's kernels: paged tree attention, gather softmax prob,
# residual sample
# ---------------------------------------------------------------------------

def _tree_inputs(seed, B, J, L, H, KV, D, ps, P, n_slots, retired=True):
    """q, pools, a scattered page table mapping each row's committed
    ``lengths`` plus the T = J*L+1 window (the last row retired: all -1,
    with a length), and the ancestor mask of J random drafts per row."""
    rng = np.random.default_rng(seed)
    T = J * L + 1
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, ps, KV, D)).astype(np.float32)
    vp = rng.standard_normal((P, ps, KV, D)).astype(np.float32)
    lengths = rng.integers(1, n_slots * ps - T + 1, B).astype(np.int32)
    pt = _page_table(rng, B, n_slots, P, ps, lengths + 1, T, holes=retired)
    mask = cases.tree_mask(B, J, L, seed=seed).numpy()
    return q, kp, vp, pt, lengths, mask


TREE_SHAPES = [
    # B, J, L, H, KV, D, ps, P, n_slots
    (3, 2, 3, 4, 2, 16, 16, 24, 6),      # GQA, J=2
    (3, 3, 2, 4, 1, 32, 8, 40, 8),       # MQA, J=3, small pages
    (2, 2, 4, 4, 4, 64, 16, 12, 5),      # MHA, longer drafts
]


@pytest.mark.parametrize("shape", TREE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_tree_attention_plain_matches_jax_ref(shape, dtype):
    """Rows with a live page table match the JAX oracle within ``_tol``;
    the retired row (all -1, with a length) is 0 in the port and attends
    page 0 in the oracle (ROADMAP §C), so it is left out and checked to be
    0."""
    B, J, L, H, KV, D, ps, P, n_slots = shape
    q, kp, vp, pt, lengths, mask = _tree_inputs(sum(shape), *shape)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(jref.paged_tree_attention_ref(
        jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
        jnp.asarray(pt), jnp.asarray(lengths), jnp.asarray(mask)), np.float32)
    got = tops.paged_tree_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
        torch.from_numpy(vp).to(tdt), torch.from_numpy(pt),
        torch.from_numpy(lengths), torch.from_numpy(mask)).float().numpy()
    live = (pt >= 0).any(-1)
    assert live.any() and not live.all()
    np.testing.assert_allclose(got[live], want[live],
                               **(F32_TOL if dtype == "float32" else BF16_TOL))
    assert np.all(got[~live] == 0.0)


def test_paged_tree_attention_plain_matches_pallas_interpret():
    """One small case through the Pallas kernel in interpret mode, the
    retired row included: the Pallas kernel skips unmapped pages, so that
    row is 0 there too."""
    from repro.kernels.tree_attention import paged_tree_attention_pallas

    q, kp, vp, pt, lengths, mask = _tree_inputs(5, 3, 2, 2, 4, 2, 16, 8, 20, 4)
    want = np.asarray(paged_tree_attention_pallas(
        *(jnp.asarray(a) for a in (q, kp, vp, pt, lengths, mask)),
        interpret=True))
    got = tops.paged_tree_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, pt, lengths, mask))).numpy()
    assert not (pt[-1] >= 0).any() and np.all(got[-1] == 0.0)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_paged_tree_attention_chain_mask_is_paged_attention():
    """A lower-triangular mask is the sequential window: the op equals
    ``paged_attention`` at lengths + 1, bit for bit."""
    B, T, H, KV, D, ps, P, n_slots = 3, 5, 4, 2, 16, 8, 30, 6
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((B, T, H, D)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((P, ps, KV, D)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((P, ps, KV, D)).astype(np.float32))
    lengths = rng.integers(1, n_slots * ps - T, B).astype(np.int32)
    pt = torch.from_numpy(_page_table(rng, B, n_slots, P, ps, lengths + 1, T))
    ln = torch.from_numpy(lengths)
    chain = torch.tril(torch.ones((T, T), dtype=torch.bool)).expand(B, T, T)
    got = tops.paged_tree_attention(q, kp, vp, pt, ln, chain.contiguous())
    want = tops.paged_attention(q, kp, vp, pt, ln + 1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("N,V", [(6, 300), (9, 2500), (4, 4096)])
def test_gather_softmax_prob_plain_matches_pallas_interpret(N, V):
    from repro.kernels.gather_softmax_prob import gather_softmax_prob_pallas

    logits, ids = cases.softmax_case(N, V, "cpu", seed=N)
    want = np.asarray(gather_softmax_prob_pallas(
        jnp.asarray(logits.numpy()), jnp.asarray(ids.numpy()), interpret=True))
    got = tops.gather_softmax_prob(logits, ids).numpy()
    rtol, atol = cases.GATHER_TOL       # relative: most picks are ~1/V
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_gather_tolerance_catches_a_wrong_normalizer():
    """The band the kernel is held to on the card fails a normalizer short
    of one key of average weight (1/V relative) and zeros on the rows whose
    pick is small, and the case picks large, median and small
    probabilities."""
    N, V = 96, 32000
    logits, ids = cases.softmax_case(N, V, "cpu")
    want = tops.gather_softmax_prob(logits, ids)
    rtol, atol = cases.GATHER_TOL
    assert float(want.max()) > 1e-2 and float(want.min()) < 1e-9
    assert int((want > 1e-4).sum()) > N // 8
    assert torch.allclose(want * (1 + 1e-6), want, rtol=rtol, atol=atol)
    for wrong in (want * (1 + 1 / V), want / (1 + 1 / V),
                  torch.where(want < 2e-5, 0.0, want)):
        assert not torch.allclose(wrong, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("N,V", [(6, 300), (8, 2500)])
def test_residual_sample_plain_matches_pallas_interpret(N, V):
    """Equal tokens on every row whose CDF crosses u * Z (the Pallas kernel
    returns argmax(p) where nothing crosses, the port V - 1; on the Z = 0
    rows both return argmax(p), the port taking the first of tied maxima
    and the Pallas kernel the last of them within a vocab tile)."""
    from repro.kernels.residual_sample import residual_sample_pallas

    p, q, u = cases.residual_case(N, V, "cpu", seed=V)
    want = np.asarray(residual_sample_pallas(
        *(jnp.asarray(a.numpy()) for a in (p, q, u)), interpret=True))
    got = tops.residual_sample(p, q, u).numpy()
    z = (p - q).clamp(min=0).sum(-1)
    crosses = ((z > 0) & (u < 1)).numpy()
    assert crosses.sum() == N - 3
    np.testing.assert_array_equal(got[crosses], want[crosses])
    assert got[0] == p[0].argmax() and got[2] == V - 1      # Z = 0, no cross
    tied = (p[1] == p[1].max()).nonzero().flatten()
    assert len(tied) == 2 and got[1] == tied[0] and want[1] in tied


def test_ops_count_plain_calls_on_cpu():
    tops.reset_counts()
    rng = np.random.default_rng(7)
    B, T, H, KV, D, ps, P, n_slots = 2, 2, 4, 2, 16, 16, 8, 4
    q = torch.from_numpy(rng.standard_normal((B, T, H, D)).astype(np.float32))
    kp = torch.zeros((P, ps, KV, D))
    pt = torch.from_numpy(np.arange(B * n_slots, dtype=np.int32)
                          .reshape(B, n_slots) % P)
    tops.paged_attention(q, kp, kp, pt, torch.tensor([3, 5], dtype=torch.int32))
    arrs = _fused_inputs(3, 2, 3, 100, 8)
    tops.fused_verify_sample(*(torch.from_numpy(a) for a in arrs))
    mask = cases.tree_mask(B, 1, 1)
    tops.paged_tree_attention(q, kp, kp, pt, torch.tensor([3, 5], dtype=torch.int32),
                              mask)
    logits = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32))
    tops.gather_softmax_prob(logits, torch.tensor([1, 2, 3], dtype=torch.int32))
    p = torch.softmax(logits, -1)
    tops.residual_sample(p, p.roll(1, -1), torch.rand(3))
    tops.residual_sample(p, p.roll(2, -1), torch.rand(3))
    tops.tree_attention(*cases.contiguous_tree_case(B, 1, 1, H, KV, D, 16, 8,
                                                    torch.float32, "cpu"))
    x, dt, A, Bm, C, st = cases.ssd_case(1, 12, 2, 16, 1, 16, torch.float32,
                                         "cpu", init=True)
    tops.ssd_scan(x, dt, A, Bm, C, chunk=8, initial_state=st)
    tops.ssd_decode(x[:, 0], dt[:, 0], A, Bm[:, 0], C[:, 0], st)  # no counter
    tops.decode_attention(*cases.decode_case(B, H, KV, D, 16, (1, 16),
                                             torch.float32, "cpu"))
    tops.flash_attention(*cases.flash_case(B, 5, 5, H, KV, D, torch.float32,
                                           "cpu"))
    tops.flash_attention(*cases.flash_case(B, 3, 5, H, KV, D, torch.float32,
                                           "cpu"), causal=False)
    q8 = cases.q8_case(B, H, KV, D, 16, (1, 16), torch.bfloat16, "cpu")
    tops.quantize_kv(torch.ones((1, 4, 1, 16)), torch.ones((1, 4, 1, 16)))
    tops.decode_attention_q8(*q8)
    assert tops.counts() == {
        "paged_attention": {"kernel": 0, "plain": 1},
        "fused_verify_sample": {"kernel": 0, "plain": 1},
        "paged_tree_attention": {"kernel": 0, "plain": 1},
        "gather_softmax_prob": {"kernel": 0, "plain": 1},
        "residual_sample": {"kernel": 0, "plain": 2},
        "tree_attention": {"kernel": 0, "plain": 1},
        "ssd_scan": {"kernel": 0, "plain": 1},
        "decode_attention": {"kernel": 0, "plain": 1},
        "flash_attention": {"kernel": 0, "plain": 2},
        "decode_attention_q8": {"kernel": 0, "plain": 1}}
    tops.reset_counts()
    assert all(c == {"kernel": 0, "plain": 0} for c in tops.counts().values())


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises; it never computes the plain
    version itself.  The checks run before any build."""
    q = torch.zeros((1, 1, 2, 16))
    pool = torch.zeros((2, 16, 1, 16))
    pt = torch.zeros((1, 1), dtype=torch.int32)
    ln = torch.ones((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_attention_cuda(q, pool, pool, pt, ln)
    arrs = _fused_inputs(4, 1, 2, 50, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tfvs.fused_verify_sample_cuda(*(torch.from_numpy(a) for a in arrs),
                                      torch.tensor([2], dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        tpta.paged_tree_attention_cuda(q, pool, pool, pt, ln,
                                       torch.ones((1, 1, 1), dtype=torch.bool))
    logits = torch.zeros((2, 50))
    with pytest.raises(ValueError, match="CUDA"):
        tgsp.gather_softmax_prob_cuda(logits, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        trs.residual_sample_cuda(logits, logits, torch.zeros(2))
    with pytest.raises(ValueError, match="CUDA"):
        tta.tree_attention_cuda(*cases.contiguous_tree_case(
            1, 1, 1, 2, 1, 16, 8, 4, torch.float32, "cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_scan_cuda(*cases.ssd_case(1, 8, 2, 16, 1, 16, torch.float32,
                                           "cpu")[:5], chunk=8)
    with pytest.raises(ValueError, match="CUDA"):
        tdaq.decode_attention_q8_cuda(*cases.q8_case(1, 2, 1, 16, 8, (1, 8),
                                                     torch.float32, "cpu"))
    assert tpa.launches == tfvs.launches == tpta.launches == 0
    assert tgsp.launches == trs.launches == tta.launches == tssd.launches == 0
    assert tdaq.launches == 0


def test_ops_reject_other_devices():
    q = torch.zeros((1, 1, 2, 16), device="meta")
    with pytest.raises(ValueError, match="device"):
        tops.paged_attention(q, q, q, q, q)


def test_build_waits_for_every_nvcc_and_raises_the_failure(tmp_path, monkeypatch):
    """One nvcc per source, started together: a failing build raises only
    after every started compiler has exited (no process is left behind), and
    a finished library lands under its content hash."""
    import stat

    from repro_torch.kernels import build

    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/usr/bin/env python3\n"
        "import sys, time\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "if 'fused_verify_sample' in sys.argv[-1]:\n"
        "    print('error: nope'); sys.exit(2)\n"
        "time.sleep(0.5)\n"
        "open(out, 'w').write('x')\n"
        "print('ptxas info    : Used 32 registers')\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "build_info", {})
    with pytest.raises(RuntimeError, match="nvcc failed for fused_verify_sample"):
        build.build_all(("fused_verify_sample", "paged_attention"))
    built = build._target("paged_attention")[1]
    assert built.exists() and built.parent == tmp_path / "out"
    assert build.build_info["paged_attention"]["ptxas"] == [
        "ptxas info    : Used 32 registers"]
    assert "paged_attention" not in build._libs
