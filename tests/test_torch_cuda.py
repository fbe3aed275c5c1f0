"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``; every test skips (decided in the ``cuda`` fixture, never at
import) when no CUDA device is present.  Run on a machine with an H100:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py

Attention outputs are held against the plain version in float32 on the same
inputs (``cases.paged_attention_held``): within 2e-5 for float32 (the band of
``tests/test_kernels.py``) and within rtol 8e-3, atol 1e-3 for bfloat16
(twice one bfloat16 rounding of the output, ``cases.PAGED_TOL``); the
bfloat16 plain version itself stays within 2e-2.  ``accept`` and ``n_acc``
must be equal;
``calibrated`` may differ from the plain version only where ``u * Z`` lies
within rounding of a CDF step (the two sum in different orders), which
``cases.residual_boundary_ok`` checks in float64; the verification kernel
splits the vocabulary across blocks (one chunk a block at B >= the SM
count), gives the exact tokens on a row of Z = 0 and one where nothing
crosses, and a second call gives the same bits.  Tree attention is held
like paged attention; ``gather_softmax_prob`` within 2e-5 relative
(``cases.GATHER_TOL``); ``residual_sample`` tokens may differ only at a CDF
step (``cases.cdf_step_ok``); both split the vocabulary across blocks
(``row_split_plan``; one chunk once the rows outnumber the SMs), at
unaligned V and row offsets, a second call gives the same bits, and they
leave their tickets at 0.  Contiguous tree attention is held like
paged tree attention, and a chain mask must equal paged tree attention over
the same keys laid out in pages, bit for bit (paged tree attention's own
chain mask matches paged attention within ``cases.PAGED_TOL``: at bf16 the
two split small grids differently, by slots and by 64-key chunks).  The SSD
scan's y is held against the plain version in float32 within 1e-4 (float32,
the scan's band in ``tests/test_kernels.py``) or rtol 8e-3 / atol 1e-3 (bfloat16,
``cases.SSD_TOL``), its float32 final state within 1e-4; the bf16 scan (on
the tensor cores) also with its head dim cut across blocks at small batch,
a second call bit-equal.  Decode and flash
attention (B7, B8) are held like paged attention, at the path shapes and at
lengths 1, S and past S, Sq < Skv and non-causal; B8 in bf16 (the
tensor-core kernel) at every head dim; bf16 B7 (the window body) on grids
that split its keys (``cases.DECODE_SPLIT_CASES``), a second call
bit-equal, and equal bit for bit to B6 with a one-row window.  Paged attention in bf16 splits its
slot axis across blocks: it is also held at the split's edges
(``cases.PAGED_EDGE_CASES``); so do paged and contiguous tree attention in
bf16, on grids small enough to split (``cases.TREE_SPLIT_CASES``), where a
second call must give the same bits.  Int8 decode attention
(B9) is held like B7 over caches made by ``quantize_kv``, returns 0 for a
row of length 0, and its wrapper refuses each input the kernel does not
take; its bf16 route (the window body over int8 rows) at unit scales
equals bf16 B7 on the codes bit for bit, split and unsplit, and a second
call gives the same bits.  No kernel has a backward: every op refuses,
under grad mode, an input that requires grad (the Mamba-2 train step
raises at the SSD scan).  This file imports no jax.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import cases
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import decode_attention_q8 as daq
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_verify_sample as fvs
from repro_torch.kernels import gather_softmax_prob as gsp
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import paged_tree_attention as pta
from repro_torch.kernels import residual_sample as rs
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels import tree_attention as ta
from repro_torch.kernels.cases import paged_case, verify_case

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


PAGED_SHAPES = [
    # (B, T, H, KV, D, ps, ctx)
    (3, 1, 4, 2, 16, 16, 40),        # smoke decode
    (3, 5, 4, 1, 16, 8, 70),         # smoke window, small pages
    (8, 9, 32, 32, 128, 16, 512),    # llama2-7b verify window
    (8, 1, 32, 4, 64, 16, 512),      # tinyllama draft step
    (2, 127, 32, 4, 64, 16, 1),      # tinyllama prefill (offset 0)
    (2, 127, 32, 32, 128, 16, 1),    # llama2-7b prefill
    (8, 9, 16, 16, 256, 16, 512),    # gemma-7b verify window (D = 256)
    (8, 1, 8, 1, 256, 16, 400),      # paligemma-3b step (D = 256, MQA)
    (2, 384, 8, 1, 256, 16, 1),      # paligemma-3b prefill: 64-row tiles
]


@pytest.mark.parametrize("shape", PAGED_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_matches_plain(cuda, shape, dtype):
    B, T, H, KV, D, ps, ctx = shape
    args = paged_case(B, T, H, KV, D, ps, ctx, dtype, cuda)
    got = pa.paged_attention_cuda(*args)
    want = cases.paged_attention_held(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    rtol, atol = cases.PAGED_TOL[dtype]
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(),
                                   pa.paged_attention_plain(*args).float(),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("case", cases.PAGED_EDGE_CASES,
                         ids=[c[0] for c in cases.PAGED_EDGE_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_at_the_edges_of_the_split(cuda, case, dtype):
    """bf16 splits the slot axis across blocks and merges in the last one:
    live slots all in one split, more splits than live slots, rows of
    length 0 and all-(-1) rows (0), lengths 1, and the serving tables."""
    _, shape, extra = case
    args = paged_case(*shape, dtype=dtype, device=cuda, **extra)
    got = pa.paged_attention_cuda(*args)
    want = cases.paged_attention_held(*args)
    torch.cuda.synchronize()
    rtol, atol = cases.PAGED_TOL[dtype]
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)
    pt, ln = args[3].cpu(), args[4].cpu()
    T = args[0].shape[1]
    dead = ~(pt >= 0).any(1) | (ln + T - 1 <= 0)
    assert not got[dead].any()
    again = pa.paged_attention_cuda(*args)      # the tickets were left at 0
    assert torch.equal(got, again)


def test_paged_attention_splits_the_slot_axis(cuda):
    """The draft step on a serving table runs several splits; the plan reads
    shapes only."""
    q, kp, vp, pt, ln = paged_case(8, 1, 32, 4, 64, 16, 512, torch.bfloat16,
                                   cuda, width=64)
    plan = pa.split_plan(8, 4, 8, 64, 16, pa.sm_count(q.device))
    assert plan[0] == 16 and plan[2] > 1
    before = pa.launches
    pa.paged_attention_cuda(q, kp, vp, pt, ln)
    assert pa.launches == before + 1


def compare_verify(args):
    got = fvs.fused_verify_sample_cuda(*args)
    want = fvs.fused_verify_sample_plain(*args)
    torch.cuda.synchronize()
    return cases.compare_verify(got, want, args), got


@pytest.mark.parametrize("B,L,V,vhat", [
    (3, 4, 257, 16),          # smoke vocab, fewer entries than threads
    (8, 8, 32000, 64),        # llama pair
    (8, 8, 151936, 64),       # qwen3.5 pair
    (5, 3, 5000, 300),
])
def test_fused_verify_sample_kernel_matches_plain(cuda, B, L, V, vhat):
    args = verify_case(B, L, V, vhat, cuda)
    rep, got = compare_verify(args)
    assert rep["accept_equal"] and rep["n_acc_equal"], rep
    assert rep["diff_rows_at_cdf_step"], \
        f"calibrated differs away from a CDF step: {rep}"
    n_acc, dlen = got[1].cpu(), args[-1].cpu()
    assert (n_acc == 0).any() and (n_acc >= dlen).any(), \
        "the case no longer covers reject and full-accept rows"


def test_fused_verify_sample_at_the_sparse_row_limit(cuda):
    """The largest Vhat the wrapper admits launches (its sorted sparse row
    and the kernel's static shared arrays fit in 48 KB) and matches the
    plain version; one more is refused before launch."""
    args = verify_case(4, 2, 20000, fvs.MAX_VHAT, cuda)
    rep, _ = compare_verify(args)
    assert rep["accept_equal"] and rep["n_acc_equal"], rep
    assert rep["diff_rows_at_cdf_step"], rep
    over = list(verify_case(1, 2, 20000, fvs.MAX_VHAT + 1, cuda))
    with pytest.raises(ValueError, match="Vhat"):
        fvs.fused_verify_sample_cuda(*over)


@pytest.mark.parametrize("B,L,V,vhat", [
    (1, 8, 32000, 64),        # one row: many chunks
    (8, 8, 32000, 64),        # llama pair: 16 chunks on an H100
    (8, 8, 151936, 64),       # qwen3.5 pair
    (4, 1, 300, 16),          # L = 1, a short vocab
    (None, 3, 4000, 16),      # B past the SM count: one block a row
])
def test_fused_verify_sample_splits_the_vocabulary(cuda, B, L, V, vhat):
    """The kernel cuts V into the plan's chunks (C = 1 once B fills the
    SMs): accept and n_acc equal the plain version, calibrated equal or at a
    CDF step, row 0's residual of Z = 0 gives argmax(p) and row 1's, where
    nothing crosses, V - 1 (``cases.verify_edge_rows``); one launch a call,
    and a second call gives the same bits."""
    n_sm = pa.sm_count(cuda)
    B = n_sm + 4 if B is None else B
    args = verify_case(B, L, V, vhat, cuda)
    if B >= 2:
        args = cases.verify_edge_rows(args)
    C, chunk = fvs.split_plan(args[0], args[3])
    assert (C > 1) == (B < n_sm) and C * chunk >= V > (C - 1) * chunk
    before = fvs.launches
    rep, got = compare_verify(args)
    assert fvs.launches == before + 1
    assert rep["accept_equal"] and rep["n_acc_equal"], rep
    assert rep["diff_rows_at_cdf_step"], rep
    if B >= 2:
        n_acc, cal = got[1].cpu(), got[2].cpu()
        assert int(cal[0]) == int(args[1][0, min(int(n_acc[0]), L - 1)])
        assert int(cal[1]) == V - 1
    again = fvs.fused_verify_sample_cuda(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_ops_route_cuda_tensors_to_the_kernels(cuda):
    ops.reset_counts()
    args = paged_case(2, 3, 4, 2, 16, 16, 20, torch.float32, cuda)
    ops.paged_attention(*args)
    ops.fused_verify_sample(*verify_case(2, 3, 300, 8, cuda))
    ops.paged_tree_attention(*cases.tree_case(2, 2, 2, 4, 2, 16, 16, 20,
                                              torch.float32, cuda))
    ops.gather_softmax_prob(*cases.softmax_case(3, 300, cuda))
    ops.residual_sample(*cases.residual_case(3, 300, cuda))
    ops.tree_attention(*cases.contiguous_tree_case(2, 2, 2, 4, 2, 16, 32, 20,
                                                   torch.float32, cuda))
    ops.ssd_scan(*cases.ssd_case(1, 16, 2, 16, 1, 16, torch.float32, cuda)[:5],
                 chunk=8)
    x, dt, A, B, C, _ = cases.ssd_case(1, 1, 2, 16, 1, 16, torch.float32, cuda)
    ops.ssd_decode(x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0],      # no counter
                   torch.zeros((1, 2, 16, 16), device=cuda))
    ops.decode_attention(*cases.decode_case(2, 4, 2, 16, 32, (1, 32),
                                            torch.float32, cuda))
    ops.flash_attention(*cases.flash_case(2, 9, 9, 4, 2, 16, torch.float32,
                                          cuda))
    ops.quantize_kv(*cases.decode_case(2, 4, 2, 16, 32, (1, 32),      # no counter
                                       torch.bfloat16, cuda)[1:3])
    ops.decode_attention_q8(*cases.q8_case(2, 4, 2, 16, 32, (1, 32),
                                           torch.bfloat16, cuda))
    assert ops.counts() == {
        "paged_attention": {"kernel": 1, "plain": 0},
        "fused_verify_sample": {"kernel": 1, "plain": 0},
        "paged_tree_attention": {"kernel": 1, "plain": 0},
        "gather_softmax_prob": {"kernel": 1, "plain": 0},
        "residual_sample": {"kernel": 1, "plain": 0},
        "tree_attention": {"kernel": 1, "plain": 0},
        "ssd_scan": {"kernel": 1, "plain": 0},
        "decode_attention": {"kernel": 1, "plain": 0},
        "flash_attention": {"kernel": 1, "plain": 0},
        "decode_attention_q8": {"kernel": 1, "plain": 0}}


def test_kernel_ops_refuse_inputs_that_require_grad(cuda):
    """No kernel has a backward: on the card an op refuses a floating input
    that requires grad (rather than cut it from the graph), launches nothing
    then, and runs as before under ``torch.no_grad``; the Mamba-2 model's
    forward reaches the refusal through its SSD scan."""
    ops.reset_counts()
    x, dt, A, B, C, _ = cases.ssd_case(1, 16, 2, 16, 1, 16, torch.float32,
                                       cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssd_scan(x.requires_grad_(), dt, A, B, C, chunk=8)
    q, k, v = cases.flash_case(2, 9, 9, 4, 2, 16, torch.float32, cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k.requires_grad_(), v)
    assert ops.counts()["ssd_scan"]["kernel"] == 0
    with torch.no_grad():
        ops.ssd_scan(x, dt, A, B, C, chunk=8)
    assert ops.counts()["ssd_scan"]["kernel"] == 1
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training.train_loop import value_and_grad

    model = build_model(get_config("mamba2-130m").smoke(), device=cuda)
    tokens = torch.randint(0, 257, (2, 16), device=cuda)
    with pytest.raises(RuntimeError, match="ops.ssd_scan"):
        value_and_grad(model, model.init(0), tokens)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q, kp, vp, pt, ln = paged_case(2, 3, 4, 2, 16, 16, 20, torch.float32, cuda)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention_cuda(q, kp, vp, pt.long(), ln)
    strided = q.transpose(1, 2).contiguous().transpose(1, 2)    # same shape
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention_cuda(strided, kp, vp, pt, ln)
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_attention_cuda(q[..., :8].contiguous(), kp[..., :8].contiguous(),
                                vp[..., :8].contiguous(), pt, ln)
    args = list(verify_case(2, 3, 300, 8, cuda))
    args[0] = args[0].to(torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        fvs.fused_verify_sample_cuda(*args)


def test_engine_round_on_the_card_uses_only_kernels(cuda):
    from repro_torch.configs import get_config
    from repro_torch.core.draws import RoundDraws
    from repro_torch.serving import SpecEngine

    tcfg = get_config("qwen2.5-3b").smoke()
    dcfg = tcfg.replace(num_layers=1, d_model=32, num_heads=2, num_kv_heads=1,
                        head_dim=16, d_ff=64, name="draft-smoke")
    eng = SpecEngine(tcfg, dcfg, max_len=96, cache_kind="paged", device=cuda)
    eng.init_params(0)
    g = torch.Generator(device=cuda).manual_seed(1)
    st = eng.start(torch.randint(0, 257, (3, 10), generator=g, device=cuda,
                                 dtype=torch.int32))
    ops.reset_counts()
    for r in range(3):
        h0 = eng.host_syncs
        st, res, _ = eng.spin_round(st, np.array([4, 2, 3]),
                                    RoundDraws.sample(r, 3, 4, 64, 257, cuda))
        assert eng.host_syncs - h0 == 1
    c = ops.counts()
    assert c["paged_attention"]["kernel"] > 0 and c["fused_verify_sample"]["kernel"] == 3
    assert c["paged_attention"]["plain"] == c["fused_verify_sample"]["plain"] == 0
    assert all(len(s) >= 13 for s in st.committed)
    eng.t_pages.check_invariants()
    eng.d_pages.check_invariants()


# ---------------------------------------------------------------------------
# the tree round's kernels
# ---------------------------------------------------------------------------

TREE_SHAPES = [
    # (B, J, L, H, KV, D, ps, ctx): T = J*L + 1
    (3, 2, 3, 4, 2, 16, 16, 40),       # smoke, GQA
    (3, 3, 4, 8, 2, 64, 8, 70),        # small pages
    (8, 2, 6, 32, 32, 128, 16, 512),   # llama2-7b tree window (T = 13)
    (8, 6, 8, 32, 32, 128, 16, 512),   # the scheme's ceiling (T = 49)
    (2, 7, 9, 4, 1, 32, 16, 100),      # T = 64, the kernel's limit
    (8, 2, 6, 16, 16, 256, 16, 512),   # gemma-7b tree window (D = 256)
    (4, 2, 6, 8, 1, 256, 16, 400),     # paligemma-3b: G = 8, 64-row tiles
]


@pytest.mark.parametrize("shape", TREE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chain", [False, True])
def test_paged_tree_attention_kernel_matches_plain(cuda, shape, dtype, chain):
    """Tree masks from ``build_token_tree`` (with B > 2 the last row is
    retired and gives 0); a chain mask must also match paged attention at
    lengths + 1 within ``cases.PAGED_TOL``."""
    args = cases.tree_case(*shape, dtype=dtype, device=cuda, chain=chain)
    got = pta.paged_tree_attention_cuda(*args)
    want = cases.tree_attention_held(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    rtol, atol = cases.PAGED_TOL[dtype]
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)
    if shape[0] > 2:
        assert torch.all(got[-1] == 0)
    if chain:       # B1 at bf16 splits by slots, B3 by 64-key chunks: on a
        q, kp, vp, pt, ln, _ = args     # small grid other partials, so PAGED_TOL
        torch.testing.assert_close(
            got.float(), pa.paged_attention_cuda(q, kp, vp, pt, ln + 1).float(),
            rtol=rtol, atol=atol)


def test_paged_tree_attention_refuses_a_65_token_window(cuda):
    args = cases.tree_case(1, 8, 8, 4, 2, 16, 16, 40, torch.float32, cuda)
    with pytest.raises(ValueError, match="at most 64"):
        pta.paged_tree_attention_cuda(*args)
    with pytest.raises(ValueError, match="bool"):
        pta.paged_tree_attention_cuda(*cases.tree_case(
            1, 2, 2, 4, 2, 16, 16, 40, torch.float32, cuda)[:5],
            torch.ones((1, 5, 5), dtype=torch.uint8, device=cuda))


def _check_split_case(fn, args, held, plan):
    """A split bf16 tree kernel within ``PAGED_TOL`` of its float32 plain
    version; a second call (tickets left at 0, the same merge order) gives
    the same bits."""
    assert plan[2] > 1, plan
    got = fn(*args)
    want = held(*args)
    torch.cuda.synchronize()
    rtol, atol = cases.PAGED_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)
    assert torch.equal(got, fn(*args))
    return got


@pytest.mark.parametrize("case", cases.TREE_SPLIT_CASES,
                         ids=[c[0] for c in cases.TREE_SPLIT_CASES])
@pytest.mark.parametrize("ps", [8, 16])
def test_paged_tree_attention_splits_its_keys(cuda, case, ps):
    _, (B, J, L, H, KV, D), lengths, n_keys = case
    args = cases.tree_case(B, J, L, H, KV, D, ps, 0, torch.bfloat16, cuda,
                           lengths=lengths, width=n_keys // ps)
    plan = pta.split_plan(args[0], args[1], args[3], pa.sm_count(cuda))
    got = _check_split_case(pta.paged_tree_attention_cuda, args,
                            cases.tree_attention_held, plan)
    if B > 2:
        assert not (args[3][-1] >= 0).any() and not got[-1].any()


def _offset(x, by):
    """``x`` copied into a flat buffer ``by`` floats past its start: the same
    values, contiguous, 4 * ``by`` bytes off 16-byte alignment."""
    flat = torch.empty(x.numel() + by, dtype=x.dtype, device=x.device)
    out = flat[by:].view(x.shape)
    out.copy_(x)
    return out


# (N, V): the tree path's nodes (2 chunks a row), the ceiling (one chunk),
# the Qwen3.5 vocabulary, one row (many chunks), rows past the SM count
# (one chunk), unaligned rows split (V = 4097) and unsplit (V = 300, V = 1)
SOFTMAX_SHAPES = [(96, 32000), (384, 32000), (96, 151936), (1, 32000),
                  (None, 4000), (5, 4097), (5, 300), (3, 1)]


@pytest.mark.parametrize("N,V", SOFTMAX_SHAPES)
def test_gather_softmax_prob_kernel_matches_plain(cuda, N, V):
    """B4 cuts V into ``row_split_plan``'s chunks (C = 1 once the rows
    outnumber the SMs), within ``cases.GATHER_TOL`` of the plain version;
    one launch a call, a second call gives the same bits, and logits 4
    bytes off 16-byte alignment (a scalar head) stay within the same
    tolerance."""
    n_sm = pa.sm_count(cuda)
    N = n_sm + 4 if N is None else N
    C, chunk = fvs.row_split_plan(N, V, n_sm)
    assert (C > 1) == (N <= n_sm and V >= 2 * fvs.ROW_MIN_CHUNK)
    logits, ids = cases.softmax_case(N, V, cuda)
    before = gsp.launches
    got = gsp.gather_softmax_prob_cuda(logits, ids)
    assert gsp.launches == before + 1
    rtol, atol = cases.GATHER_TOL
    torch.testing.assert_close(got, gsp.gather_softmax_prob_plain(logits, ids),
                               rtol=rtol, atol=atol)
    assert torch.equal(got, gsp.gather_softmax_prob_cuda(logits, ids))
    moved = gsp.gather_softmax_prob_cuda(_offset(logits, 1), ids)
    torch.testing.assert_close(moved, got, rtol=rtol, atol=atol)


RESIDUAL_SHAPES = [(8, 300), (8, 32000), (8, 151936), (1, 32000),
                   (None, 4000), (5, 4097), (5, 300), (3, 1)]


@pytest.mark.parametrize("N,V", RESIDUAL_SHAPES)
def test_residual_sample_kernel_matches_plain(cuda, N, V):
    """B5 cuts V into ``row_split_plan``'s chunks: tokens equal the plain
    version or differ at a CDF step; the Z = 0 row gives argmax(p), the
    tie of p's maxima half a row apart (two chunks when split) its first
    index, the row where nothing crosses V - 1; one launch a call, a second
    call gives the same bits; p and q 4 bytes off 16-byte alignment (a
    scalar head), or off by different amounts (all scalar loads), give the
    same tokens or differ at a CDF step."""
    n_sm = pa.sm_count(cuda)
    N = n_sm + 4 if N is None else N
    C, chunk = fvs.row_split_plan(N, V, n_sm)
    assert (C > 1) == (N <= n_sm and V >= 2 * fvs.ROW_MIN_CHUNK)
    p, q, u = cases.residual_case(N, V, cuda)
    before = rs.launches
    got = rs.residual_sample_cuda(p, q, u)
    assert rs.launches == before + 1
    rep = cases.compare_residual(got, rs.residual_sample_plain(p, q, u), p, q, u)
    assert rep["diff_rows_at_cdf_step"], rep
    tok = got.cpu()
    assert int(tok[0]) == int(p[0].argmax())
    if N > 2:
        assert int(tok[2]) == V - 1
    if N > 1 and V > 1:
        tied = (p[1] == p[1].max()).nonzero().flatten().cpu()
        assert len(tied) == 2 and int(tok[1]) == int(tied[0])
        assert C == 1 or int(tied[0]) // chunk != int(tied[1]) // chunk
    assert torch.equal(got, rs.residual_sample_cuda(p, q, u))
    for dp, dq in ((1, 1), (1, 2)):
        moved = rs.residual_sample_cuda(_offset(p, dp), _offset(q, dq), u)
        rep = cases.compare_residual(moved, got, p, q, u)
        assert rep["diff_rows_at_cdf_step"], rep


def test_samplers_leave_their_tickets_at_zero(cuda):
    """A split B1 launch between two calls of each split sampler uses the
    same tickets; each call gives the same bits and every ticket is 0
    afterwards."""
    logits, ids = cases.softmax_case(96, 32000, cuda)
    p, q, u = cases.residual_case(8, 32000, cuda)
    b1 = paged_case(8, 1, 32, 4, 64, 16, 512, torch.bfloat16, cuda, width=64)
    assert pa.split_plan(8, 4, 8, 64, 16, pa.sm_count(cuda))[2] > 1
    first = (gsp.gather_softmax_prob_cuda(logits, ids),
             rs.residual_sample_cuda(p, q, u))
    pa.paged_attention_cuda(*b1)
    second = (gsp.gather_softmax_prob_cuda(logits, ids),
              rs.residual_sample_cuda(p, q, u))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _, tickets = pa.scratch_for(p.device, 0, 0)
    assert not tickets.any()


@pytest.mark.parametrize("commit", ["scatter", "repair"])
def test_tree_rounds_on_the_card_equal_the_cpu(cuda, commit):
    """The smoke engine's tree rounds (J=1 through the tree machinery, J=2,
    J=3) commit the same tokens on the card (kernels only) as on the CPU
    (plain versions), with the reference's host syncs per round."""
    from repro_torch.configs import get_config
    from repro_torch.core.draws import RoundDraws, TreeDraws
    from repro_torch.serving import SpecEngine

    tcfg = get_config("qwen2.5-3b").smoke()
    dcfg = tcfg.replace(num_layers=1, d_model=32, num_heads=2, num_kv_heads=1,
                        head_dim=16, d_ff=64, name="draft-smoke")
    prompts = torch.from_numpy(
        np.random.default_rng(1).integers(0, 257, (3, 10)).astype(np.int32))
    out = {}
    for dev in ("cpu", cuda):
        eng = SpecEngine(tcfg, dcfg, max_len=96, cache_kind="paged",
                         tree_commit=commit, device=dev)
        eng.init_params(0)
        if dev != "cpu":
            eng.t_params, eng.d_params = params
        else:
            params = (_to(eng.t_params, cuda), _to(eng.d_params, cuda))
        st = eng.start(prompts.to(dev))
        ops.reset_counts()
        syncs = []
        for r, (J, lengths) in enumerate(((1, [4, 2, 3]), (2, [3, 4, 2]),
                                          (3, [2, 3, 4]), (2, [4, 4, 1]))):
            L = max(lengths)
            draws = (RoundDraws.sample(r, 3, L, 64, 257, device="cpu") if J == 1
                     else TreeDraws.sample(r, 3, J, L, 64, 257, device="cpu"))
            h0 = eng.host_syncs
            st, _, _ = eng.spin_round(st, np.asarray(lengths), draws.to(dev),
                                      draft_width=J, tree=True)
            syncs.append(eng.host_syncs - h0)
            eng.t_pages.check_invariants()
            eng.d_pages.check_invariants()
        out[str(dev)] = ([list(map(int, c)) for c in st.committed], syncs,
                         eng.pool_stats(), ops.counts())
    cpu, card = out["cpu"], out[str(cuda)]
    assert card[:3] == cpu[:3]
    assert card[1] == [2] + [3 if commit == "repair" else 2] * 3
    for name in ("paged_attention", "paged_tree_attention",
                 "gather_softmax_prob", "residual_sample"):
        assert card[3][name]["kernel"] > 0 and card[3][name]["plain"] == 0
        assert cpu[3][name]["plain"] > 0


# ---------------------------------------------------------------------------
# the contiguous layout's kernels
# ---------------------------------------------------------------------------

CONTIGUOUS_TREE_SHAPES = [
    # (B, J, L, H, KV, D, S, ctx): T = J*L + 1
    (3, 2, 3, 4, 2, 16, 64, 40),        # smoke, GQA
    (3, 3, 4, 8, 2, 64, 96, 70),        # MQA-ish, a ragged key tile
    (8, 2, 6, 32, 32, 128, 1024, 512),  # llama2-7b tree window (T = 13)
    (8, 6, 8, 32, 32, 128, 1024, 512),  # the scheme's ceiling (T = 49)
    (2, 7, 9, 4, 1, 32, 128, 100),      # T = 64, the kernel's limit
    (8, 2, 6, 16, 16, 256, 1024, 512),  # gemma-7b tree window (D = 256)
    (4, 2, 6, 8, 1, 256, 512, 400),     # paligemma-3b: G = 8, 64-row tiles
]


@pytest.mark.parametrize("shape", CONTIGUOUS_TREE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chain", [False, True])
def test_tree_attention_kernel_matches_plain(cuda, shape, dtype, chain):
    """Tree masks from ``build_token_tree``; a chain mask must also equal
    the paged kernel over the same keys laid out in 16-key pages."""
    args = cases.contiguous_tree_case(*shape, dtype=dtype, device=cuda,
                                      chain=chain)
    got = ta.tree_attention_cuda(*args)
    want = cases.contiguous_tree_held(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    rtol, atol = cases.PAGED_TOL[dtype]
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)
    if chain:
        q, kc, vc, ln, mask = args
        kp, vp, table = cases.as_pages(kc, vc)
        assert torch.equal(got, pta.paged_tree_attention_cuda(
            q, kp, vp, table, ln, mask))


def test_tree_attention_sees_no_key_past_the_cache(cuda):
    """A window written at an offset past S - T lands at S - T (the cache
    write clamps), and the kernel reads no key at or past S: it agrees with
    the plain version on rows whose lengths reach the end."""
    q, kc, vc, ln, mask = cases.contiguous_tree_case(
        3, 2, 3, 4, 2, 16, 64, 40, torch.float32, cuda)
    ln = torch.tensor([60, 64, 10], dtype=torch.int32, device=cuda)
    got = ta.tree_attention_cuda(q, kc, vc, ln, mask)
    want = cases.contiguous_tree_held(q, kc, vc, ln, mask)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_tree_attention_refuses_a_65_token_window(cuda):
    args = cases.contiguous_tree_case(1, 8, 8, 4, 2, 16, 128, 40,
                                      torch.float32, cuda)
    with pytest.raises(ValueError, match="at most 64"):
        ta.tree_attention_cuda(*args)
    q, kc, vc, ln, mask = cases.contiguous_tree_case(1, 2, 2, 4, 2, 16, 64, 40,
                                                     torch.float32, cuda)
    with pytest.raises(ValueError, match="bool"):
        ta.tree_attention_cuda(q, kc, vc, ln, mask.to(torch.uint8))
    with pytest.raises(ValueError, match="int32"):
        ta.tree_attention_cuda(q, kc, vc, ln.long(), mask)


@pytest.mark.parametrize("case", cases.TREE_SPLIT_CASES,
                         ids=[c[0] for c in cases.TREE_SPLIT_CASES])
@pytest.mark.parametrize("chain", [False, True])
def test_tree_attention_splits_its_keys(cuda, case, chain):
    """B6 on the grids of ``cases.TREE_SPLIT_CASES`` over an S = keys cache; a
    chain mask equals B3 over the same keys in 16-key pages, bit for bit,
    the two cut at the same keys."""
    _, (B, J, L, H, KV, D), lengths, S = case
    args = cases.contiguous_tree_case(B, J, L, H, KV, D, S, 0, torch.bfloat16,
                                      cuda, chain=chain, lengths=lengths)
    plan = ta.split_plan(args[0], args[1], pa.sm_count(cuda))
    got = _check_split_case(ta.tree_attention_cuda, args,
                            cases.contiguous_tree_held, plan)
    if chain:
        q, kc, vc, ln, mask = args
        kp, vp, table = cases.as_pages(kc, vc)
        assert pta.split_plan(q, kp, table, pa.sm_count(cuda)) == plan
        assert torch.equal(got, pta.paged_tree_attention_cuda(
            q, kp, vp, table, ln, mask))


def test_tree_kernels_refuse_misaligned_bf16(cuda):
    """The bf16 tensor-core kernels stage 16-byte rows: a tensor that does
    not start on 16 bytes is refused before anything is allocated."""
    q, kp, vp, pt, ln, mask = cases.tree_case(2, 2, 2, 4, 2, 16, 16, 40,
                                              torch.bfloat16, cuda)
    off = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:]
    q_off = off.view(q.shape).copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pta.paged_tree_attention_cuda(q_off, kp, vp, pt, ln, mask)
    q, kc, vc, ln, mask = cases.contiguous_tree_case(2, 2, 2, 4, 2, 16, 64, 40,
                                                     torch.bfloat16, cuda)
    q_off = off.view(q.shape).copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ta.tree_attention_cuda(q_off, kc, vc, ln, mask)


SSD_SHAPES = [
    # (b, s, h, p, g, n, chunk)
    (2, 32, 8, 16, 1, 16, 8),          # smoke widths (p = n = 16, chunk 8)
    (8, 128, 80, 64, 1, 64, 64),       # zamba2-2.7b prefill
    (8, 128, 24, 64, 1, 128, 64),      # mamba2-130m heads, big state
    (2, 64, 4, 32, 2, 16, 16),         # grouped B/C (bf16: p cut in two)
    (1, 128, 80, 64, 1, 64, 64),       # zamba2-2.7b, one row (bf16: p cut)
]


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_scan_kernel_matches_plain(cuda, shape, dtype, init):
    """y and the final state within the bands; the bf16 tensor-core kernel,
    which cuts p across blocks where the grid would have fewer blocks than
    SMs, gives the same bits on a second call."""
    b, s, h, p, g, n, chunk = shape
    x, dt, A, B, C, st = cases.ssd_case(b, s, h, p, g, n, dtype, cuda,
                                        init=init)
    y, fs = ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=chunk, initial_state=st)
    y_want, fs_want = cases.ssd_scan_held(x, dt, A, B, C, chunk, st)
    torch.cuda.synchronize()
    assert y.dtype == dtype and fs.dtype == torch.float32
    rtol, atol = cases.SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), y_want, rtol=rtol, atol=atol)
    rtol, atol = cases.SSD_STATE_TOL
    torch.testing.assert_close(fs, fs_want, rtol=rtol, atol=atol)
    if dtype == torch.bfloat16:
        y2, fs2 = ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=chunk,
                                    initial_state=st)
        assert torch.equal(y, y2) and torch.equal(fs, fs2)


@pytest.mark.parametrize("init", [False, True])
def test_ops_ssd_scan_pads_a_ragged_sequence(cuda, init):
    """A sequence that is not a chunk multiple is padded with dt = 0 on the
    card as on the CPU: y and the final state agree."""
    args = cases.ssd_case(2, 27, 4, 16, 1, 16, torch.float32, cuda, init=init)
    ops.reset_counts()
    y, fs = ops.ssd_scan(*args[:5], chunk=8, initial_state=args[5])
    cpu = [None if t is None else t.cpu() for t in args]
    y_cpu, fs_cpu = ops.ssd_scan(*cpu[:5], chunk=8, initial_state=cpu[5])
    assert y.shape == (2, 27, 4, 16)
    assert ops.counts()["ssd_scan"] == {"kernel": 1, "plain": 1}
    torch.testing.assert_close(y.cpu(), y_cpu, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(fs.cpu(), fs_cpu, rtol=1e-4, atol=1e-4)


def test_ssd_scan_refuses_what_the_kernel_does_not_take(cuda):
    x, dt, A, B, C, _ = cases.ssd_case(1, 16, 2, 16, 1, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=5)
    with pytest.raises(ValueError, match="float32"):
        ssd.ssd_scan_cuda(x, dt.double(), A, B, C, chunk=8)
    with pytest.raises(ValueError, match="shared memory"):
        big = cases.ssd_case(1, 128, 1, 128, 1, 256, torch.float32, cuda)
        ssd.ssd_scan_cuda(*big[:5], chunk=128)
    # the bf16 tensor-core kernel: n = 48, a chunk of 128, p = 24
    for (s, p, n), chunk in (((16, 16, 48), 8), ((128, 16, 16), 128),
                             ((16, 24, 16), 8)):
        args = cases.ssd_case(1, s, 2, p, 1, n, torch.bfloat16, cuda)
        with pytest.raises(ValueError, match="bfloat16 takes"):
            ssd.ssd_scan_cuda(*args[:5], chunk=chunk)


CONTIGUOUS_ROUNDS = {
    # target arch: [(J, tree, lengths), ...]
    "qwen2.5-3b": [(1, False, [4, 2, 3]), (1, False, [1, 4, 4]),
                   (1, False, [3, 3, 2]), (1, True, [4, 2, 3]),
                   (2, True, [3, 4, 2]), (3, True, [2, 3, 4])],
    "mamba2-130m": [(1, False, [4, 2, 3]), (1, False, [1, 4, 4]),
                    (1, False, [3, 3, 2])],
    "zamba2-2.7b": [(1, False, [4, 2, 3]), (1, False, [1, 4, 4]),
                    (1, False, [3, 3, 2])],
}


@pytest.mark.parametrize("arch", sorted(CONTIGUOUS_ROUNDS))
def test_contiguous_rounds_on_the_card_equal_the_cpu(cuda, arch):
    """The contiguous smoke engines (dense J=1 and tree rounds, mamba2 and
    zamba2 targets) commit the same tokens on the card (kernels only) as on
    the CPU (plain versions), with the reference's host syncs per round."""
    from repro_torch.configs import get_config
    from repro_torch.core.draws import RoundDraws, TreeDraws
    from repro_torch.serving import SpecEngine

    tcfg = get_config(arch).smoke()
    dcfg = get_config("qwen2.5-3b").smoke().replace(
        num_layers=1, d_model=32, num_heads=2, num_kv_heads=1, head_dim=16,
        d_ff=64, name="draft-smoke")
    prompts = torch.from_numpy(
        np.random.default_rng(1).integers(0, 257, (3, 10)).astype(np.int32))
    out = {}
    for dev in ("cpu", cuda):
        eng = SpecEngine(tcfg, dcfg, max_len=96, device=dev)
        eng.init_params(0)
        if dev != "cpu":
            eng.t_params, eng.d_params = params
        else:
            params = (_to(eng.t_params, cuda), _to(eng.d_params, cuda))
        ops.reset_counts()
        st = eng.start(prompts.to(dev))      # the SSD scan runs in prefill
        syncs = []
        for r, (J, tree, lengths) in enumerate(CONTIGUOUS_ROUNDS[arch]):
            L = max(lengths)
            draws = (RoundDraws.sample(r, 3, L, 64, 257, device="cpu") if J == 1
                     else TreeDraws.sample(r, 3, J, L, 64, 257, device="cpu"))
            h0 = eng.host_syncs
            st, _, _ = eng.spin_round(st, np.asarray(lengths), draws.to(dev),
                                      draft_width=J, tree=tree)
            syncs.append(eng.host_syncs - h0)
        out[str(dev)] = ([list(map(int, c)) for c in st.committed], syncs,
                         eng.pool_stats(), ops.counts())
    cpu, card = out["cpu"], out[str(cuda)]
    assert card[:3] == cpu[:3]
    assert card[1] == [2 if tree else 1 for _, tree, _ in CONTIGUOUS_ROUNDS[arch]]
    used = {"qwen2.5-3b": ("tree_attention", "fused_verify_sample",
                           "gather_softmax_prob", "residual_sample"),
            "mamba2-130m": ("ssd_scan", "fused_verify_sample"),
            "zamba2-2.7b": ("ssd_scan", "fused_verify_sample")}[arch]
    # every engine's draft prefills through B8 and steps through B7
    used += ("decode_attention", "flash_attention")
    for name in used:
        assert card[3][name]["kernel"] > 0 and cpu[3][name]["plain"] > 0
    assert all(c["plain"] == 0 for c in card[3].values())


# ---------------------------------------------------------------------------
# decode attention (B7) and flash attention (B8), the plain serving engine
# ---------------------------------------------------------------------------

DECODE_SHAPES = [
    # (B, H, KV, D, S, lengths): lengths a (lo, hi) range or the rows' list
    (3, 4, 2, 16, 40, (1, 40)),                 # smoke step, GQA
    (8, 32, 4, 64, 1024, (128, 520)),           # tinyllama draft step
    (8, 32, 32, 80, 1024, (128, 300)),          # zamba2 shared-attention step
    (8, 32, 32, 128, 1024, (127, 190)),         # llama2-7b plain decode
    (4, 32, 4, 64, 1024, [1, 1024, 1100, 700]),  # lengths 1, S, past S
    (3, 8, 1, 80, 100, [1, 100, 130]),          # G = 8 at D = 80, ragged tile
    (8, 32, 32, 96, 256, (1, 256)),             # D = 96, 256 blocks: no split
    (8, 16, 16, 256, 1024, (128, 160)),         # gemma-7b step (D = 256)
    (8, 8, 1, 256, 1024, (384, 416)),           # paligemma-3b step, G = 8
]


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain(cuda, shape, dtype):
    args = cases.decode_case(*shape, dtype=dtype, device=cuda)
    got = da.decode_attention_cuda(*args)
    want = cases.decode_attention_held(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    rtol, atol = cases.PAGED_TOL[dtype]
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


def test_decode_attention_returns_zero_for_a_dead_row(cuda):
    """A row of length 0 sees no key: 0, as the Pallas kernel (the plain
    version keeps the oracle's mean there); the live rows still match."""
    q, kc, vc, _ = cases.decode_case(3, 8, 2, 64, 64, (1, 64), torch.float32,
                                     cuda)
    ln = torch.tensor([0, 64, 7], dtype=torch.int32, device=cuda)
    got = da.decode_attention_cuda(q, kc, vc, ln)
    want = cases.decode_attention_held(q, kc, vc, ln)
    assert not got[0].any()
    torch.testing.assert_close(got[1:], want[1:], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", cases.DECODE_SPLIT_CASES + [
    ("no split at D=80", (8, 32, 32, 80, 1024), [1, 1024, 1100, 0, 5, 64, 65,
                                                  300]),
    ("no split at D=96", (8, 32, 32, 96, 256), [256, 0, 1, 17, 300, 64, 128,
                                                200]),
], ids=lambda c: c[0])
def test_decode_attention_bf16_splits_its_keys(cuda, case):
    """bf16 B7 (the window body) splits its key axis only on a grid of
    fewer blocks than SMs; within ``PAGED_TOL`` on the rows that see a
    key, 0 on a row of length 0, and a second call gives the same bits."""
    _, (B, H, KV, D, S), lengths = case
    q, kc, vc, ln = cases.decode_case(B, H, KV, D, S, lengths, torch.bfloat16,
                                      cuda)
    plan = da.split_plan(q, kc, pa.sm_count(cuda))
    assert (plan[2] > 1) == (B * KV < pa.sm_count(cuda))
    got = da.decode_attention_cuda(q, kc, vc, ln)
    want = cases.decode_attention_held(q, kc, vc, ln)
    torch.cuda.synchronize()
    live = ln > 0
    rtol, atol = cases.PAGED_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float()[live], want[live], rtol=rtol,
                               atol=atol)
    assert not got[~live].any()
    assert torch.equal(got, da.decode_attention_cuda(q, kc, vc, ln))


@pytest.mark.parametrize("shape", [
    (8, 32, 4, 64, 1024, (128, 520)),            # draft step: 8 splits
    (4, 32, 4, 64, 1024, [1, 1024, 1100, 700]),  # 16 splits
    (8, 32, 32, 128, 1024, (127, 190)),          # Llama-2-7B step: no split
    (2, 32, 4, 128, 1024, [5, 900]),             # 16 splits at D = 128
    (3, 4, 2, 16, 96, [1, 96, 40]),              # smoke widths
    (2, 8, 1, 256, 1024, [1000, 7]),             # D = 256, G = 8, splits
])
def test_decode_attention_equals_tree_attention_at_one_row(cuda, shape):
    """bf16 B7 at lengths l equals B6 with a one-row window, mask [[1]], at
    lengths l - 1 over the same cache, bit for bit, on every row with
    1 <= l <= S: one body, one key locator, the same split plan and the same
    visible keys."""
    B, H, KV, D, S, lengths = shape
    q, kc, vc, ln = cases.decode_case(B, H, KV, D, S, lengths, torch.bfloat16,
                                      cuda)
    n_sm = pa.sm_count(cuda)
    assert da.split_plan(q, kc, n_sm) == ta.split_plan(q[:, None], kc, n_sm)
    got = da.decode_attention_cuda(q, kc, vc, ln)
    b6 = ta.tree_attention_cuda(q[:, None].contiguous(), kc, vc, ln - 1,
                                torch.ones((B, 1, 1), dtype=torch.bool,
                                           device=cuda))[:, 0]
    rows = (ln >= 1) & (ln <= S)
    assert rows.any()
    assert torch.equal(got[rows], b6[rows])


FLASH_SHAPES = [
    # (B, Sq, Skv, H, KV, D, causal)
    (2, 9, 9, 4, 2, 16, True),            # smoke prefill (16-row tiles)
    (8, 127, 127, 32, 32, 128, True),     # llama2-7b prefill
    (8, 127, 127, 32, 4, 64, True),       # tinyllama prefill
    (8, 127, 127, 32, 32, 80, True),      # zamba2 shared-attention prefill
    (2, 70, 200, 8, 2, 64, True),         # Sq < Skv: bottom-right diagonal
    (2, 100, 100, 8, 2, 80, False),       # non-causal
    (2, 128, 128, 16, 16, 256, True),     # gemma-7b prefill (D = 256)
    (2, 384, 384, 8, 1, 256, True),       # paligemma-3b prefill, MQA
    (2, 1500, 1500, 20, 20, 64, False),   # whisper-large-v3 encoder
    (2, 1, 1500, 20, 20, 64, False),      # whisper cross-attention step
]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, shape, dtype):
    B, Sq, Skv, H, KV, D, causal = shape
    q, k, v = cases.flash_case(B, Sq, Skv, H, KV, D, dtype, cuda)
    got = fa.flash_attention_cuda(q, k, v, causal=causal)
    want = cases.flash_attention_held(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    rtol, atol = cases.PAGED_TOL[dtype]
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("Sq,Skv,causal", [(127, 127, True), (65, 65, True),
                                           (40, 130, True), (64, 90, False)])
def test_flash_attention_bf16_at_every_head_dim(cuda, D, Sq, Skv, causal):
    """The tensor-core kernel at each head dim: two tiles with a ragged
    last one, a tile edge, Sq < Skv and non-causal."""
    q, k, v = cases.flash_case(2, Sq, Skv, 8, 2, D, torch.bfloat16, cuda, seed=D)
    got = fa.flash_attention_cuda(q, k, v, causal=causal)
    want = cases.flash_attention_held(q, k, v, causal=causal)
    torch.cuda.synchronize()
    rtol, atol = cases.PAGED_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


def test_b7_b8_refuse_what_the_kernels_do_not_take(cuda):
    q, k, v = cases.flash_case(1, 8, 4, 4, 2, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="see no key"):
        fa.flash_attention_cuda(q, k, v, causal=True)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_cuda(*cases.flash_case(1, 4, 4, 2, 1, 48,
                                                  torch.float32, cuda))
    q, kc, vc, ln = cases.decode_case(1, 34, 2, 16, 8, (1, 8), torch.float32,
                                      cuda)
    with pytest.raises(ValueError, match="at most 16"):
        da.decode_attention_cuda(q, kc, vc, ln)
    q, kc, vc, ln = cases.decode_case(1, 4, 2, 16, 8, (1, 8), torch.float32,
                                      cuda)
    with pytest.raises(ValueError, match="int32"):
        da.decode_attention_cuda(q, kc, vc, ln.long())


Q8_SHAPES = [
    # (B, H, KV, D, S, lengths): lengths a (lo, hi) range or the rows' list
    (3, 4, 2, 16, 40, (1, 40)),                 # smoke step, GQA
    (8, 32, 32, 128, 1024, (127, 190)),         # llama2-7b plain decode
    (8, 32, 4, 64, 1024, (128, 520)),           # tinyllama draft step
    (8, 32, 32, 80, 1024, (128, 160)),          # zamba2 shared-attention step
    (4, 8, 4, 64, 512, [256] * 4),              # the JAX kernel bench's shape
    (4, 32, 4, 64, 1024, [1, 1024, 1100, 700]),  # lengths 1, S, past S
    (3, 8, 1, 80, 100, [1, 100, 130]),          # G = 8 at D = 80, ragged tile
    (8, 16, 16, 256, 1024, (128, 160)),         # gemma-7b step (D = 256)
    (8, 8, 1, 256, 1024, [1, 1024, 1100, 5, 400, 401, 402, 403]),  # MQA
]


@pytest.mark.parametrize("shape", Q8_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_q8_kernel_matches_plain(cuda, shape, dtype):
    args = cases.q8_case(*shape, dtype=dtype, device=cuda)
    got = daq.decode_attention_q8_cuda(*args)
    want = cases.q8_held(*args)
    exact = da.decode_attention_cuda(*cases.decode_case(*shape, dtype=dtype,
                                                        device=cuda))
    torch.cuda.synchronize()
    assert got.dtype == dtype
    rtol, atol = cases.PAGED_TOL[dtype]
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)
    assert (got.float() - exact.float()).abs().max() < 0.05   # int8 budget


@pytest.mark.parametrize("shape", [
    (8, 32, 4, 64, 1024, (128, 520)),              # draft step: 8 splits
    (4, 32, 4, 64, 1024, [1, 1024, 1100, 0]),      # 16 splits, a dead row
    (8, 32, 32, 80, 1024, (128, 160)),             # Zamba2 step: no split
    (2, 8, 1, 80, 320, [300, 65]),                 # D = 80, split
    (8, 32, 32, 128, 1024, (127, 190)),            # Llama-2-7B step: no split
    (2, 32, 4, 128, 1024, [5, 900]),               # D = 128, 16 splits
    (8, 16, 16, 256, 1024, (128, 160)),            # gemma-7b step (D = 256)
    (2, 8, 1, 256, 1024, [1000, 0]),               # D = 256, G = 8, split
])
def test_decode_attention_q8_bf16_is_b7_on_the_codes(cuda, shape):
    """bf16 B9 runs B7's window body over int8 rows with B7's split: at
    unit scales it equals bf16 B7 on ``codes.to(bfloat16)`` bit for bit on
    every row (dead rows and rows past S included); at the quantizer's
    scales it is within ``PAGED_TOL`` of the float32 plain version on the
    live rows, 0 on a dead row, and a second call gives the same bits."""
    q, kq, vq, ks, vs, ln = cases.q8_case(*shape, dtype=torch.bfloat16,
                                          device=cuda)
    B, _, KV, _, S, _ = shape
    plan = da.split_plan(q, kq, pa.sm_count(cuda))
    assert (plan[2] > 1) == (B * KV < pa.sm_count(cuda))
    ones = torch.ones_like(ks)
    unit = daq.decode_attention_q8_cuda(q, kq, vq, ones, ones, ln)
    b7 = da.decode_attention_cuda(q, kq.to(torch.bfloat16),
                                  vq.to(torch.bfloat16), ln)
    got = daq.decode_attention_q8_cuda(q, kq, vq, ks, vs, ln)
    want = cases.q8_held(q, kq, vq, ks, vs, ln)
    torch.cuda.synchronize()
    assert torch.equal(unit, b7)
    live = ln > 0
    rtol, atol = cases.PAGED_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float()[live], want[live], rtol=rtol,
                               atol=atol)
    assert not got[~live].any()
    assert torch.equal(got, daq.decode_attention_q8_cuda(q, kq, vq, ks, vs,
                                                         ln))


def test_decode_attention_q8_returns_zero_for_a_dead_row(cuda):
    """A row of length 0 sees no key: 0, as the Pallas kernel (the plain
    version keeps the oracle's mean there); the live rows still match."""
    q, kq, vq, ks, vs, _ = cases.q8_case(3, 8, 2, 64, 64, (1, 64),
                                         torch.float32, cuda)
    ln = torch.tensor([0, 64, 7], dtype=torch.int32, device=cuda)
    got = daq.decode_attention_q8_cuda(q, kq, vq, ks, vs, ln)
    want = cases.q8_held(q, kq, vq, ks, vs, ln)
    assert not got[0].any()
    torch.testing.assert_close(got[1:], want[1:], rtol=2e-5, atol=2e-5)


def test_decode_attention_q8_refuses_what_the_kernel_does_not_take(cuda):
    q, kq, vq, ks, vs, ln = cases.q8_case(2, 4, 2, 16, 8, (1, 8),
                                          torch.float32, cuda)
    before = daq.launches

    def refused(match, **swap):
        args = dict(q=q, k_cache=kq, v_cache=vq, k_scale=ks, v_scale=vs,
                    lengths=ln)
        args.update(swap)
        with pytest.raises(ValueError, match=match):
            daq.decode_attention_q8_cuda(**args)

    refused("CUDA", k_scale=ks.cpu())
    refused("contiguous", q=q.transpose(0, 1).contiguous().transpose(0, 1))
    refused("int8", k_cache=kq.float())
    refused("one shape", v_cache=vq[:, :4].contiguous())
    refused("scales", v_scale=vs.double())
    refused("scales", k_scale=ks[:1].contiguous())
    refused("at most 16", q=torch.zeros((2, 34, 16), device=cuda))
    refused("head dim", q=q[..., :8].contiguous(),
            k_cache=kq[..., :8].contiguous(), v_cache=vq[..., :8].contiguous())
    shifted = torch.empty(kq.numel() + 1, dtype=torch.int8, device=cuda)[1:]
    refused("aligned", k_cache=shifted.view(kq.shape).copy_(kq))
    refused("int32", lengths=ln.long())
    assert daq.launches == before        # a refusal launches nothing
    daq.decode_attention_q8_cuda(q, kq, vq, ks, vs, ln)
    assert daq.launches == before + 1


def test_serving_engine_on_the_card_equals_the_cpu(cuda):
    """The plain engine on the smoke config commits the same tokens on the
    card (B8 in start, B7 every step) as on the CPU (plain versions),
    greedy and sampled with the same noise."""
    from repro_torch.configs import get_config
    from repro_torch.serving import ServingEngine

    cfg = get_config("deepseek-7b").smoke()
    prompts = torch.from_numpy(
        np.random.default_rng(2).integers(0, 257, (3, 9)).astype(np.int32))
    noise = -torch.empty((6, 3, cfg.vocab_size)).exponential_(
        generator=torch.Generator().manual_seed(4)).log()
    out = {}
    for dev in ("cpu", cuda):
        eng = ServingEngine(cfg, max_len=48, device=dev)
        eng.init_params(0)
        if dev != "cpu":
            eng.params = params
        else:
            params = _to(eng.params, cuda)
        ops.reset_counts()
        greedy = eng.generate(prompts.to(dev), 6, temperature=0)
        sampled = eng.generate(prompts.to(dev), 6, noise.to(dev),
                               temperature=0.8)
        out[str(dev)] = ([list(map(int, c)) for c in greedy],
                         [list(map(int, c)) for c in sampled], ops.counts())
    cpu, card = out["cpu"], out[str(cuda)]
    assert card[:2] == cpu[:2]
    for name in ("decode_attention", "flash_attention"):
        assert card[2][name]["kernel"] > 0 and card[2][name]["plain"] == 0
        assert cpu[2][name]["plain"] == card[2][name]["kernel"]


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return [_to(v, device) for v in tree]


@pytest.mark.parametrize("num_kv_heads", [1, 2])
def test_mesh_route_equals_plain_on_the_card(cuda, num_kv_heads):
    """Phase 19(b) of ``chip_smoke.py`` at smoke widths: a one-rank NCCL
    group and the (1, 1) mesh; a bf16 prefill and 6 greedy T=1 steps with
    params, caches and inputs placed by the sharding rules equal the plain
    run bit for bit, with the same B7/B8 launches, no plain call and no
    collective."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import build_model
    from repro_torch.roofline.analysis import record_collectives

    cfg = get_config("qwen2.5-3b").smoke().replace(
        num_kv_heads=num_kv_heads, param_dtype="bfloat16",
        compute_dtype="bfloat16")
    model = build_model(cfg, device=cuda)
    K, M, steps = 3, 20, 6
    prompts = torch.from_numpy(
        np.random.default_rng(5).integers(0, 257, (K, M)).astype(np.int32)
    ).to(cuda)

    def run(params, cache, put):
        out = []
        with torch.no_grad():
            logits, cache, _ = model.prefill(params, put(prompts), cache)
            last = logits[:, -1]
            last = last.full_tensor() if hasattr(last, "full_tensor") else last
            out.append(last)
            for i in range(steps):
                nxt = last.argmax(-1).to(torch.int32)[:, None]
                pos = torch.full((K,), M + i, dtype=torch.int32, device=cuda)
                logits, cache = model.forward_window(params, put(nxt), cache,
                                                     put(pos))
                last = logits[:, -1]
                last = (last.full_tensor() if hasattr(last, "full_tensor")
                        else last)
                out.append(last)
        return out

    params = model.init(0)
    ops.reset_counts()
    plain = run(params, model.init_cache(K, 64, torch.bfloat16), lambda t: t)
    plain_counts = ops.counts()
    torch.cuda.set_device(0)            # NCCL's device, before the group
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_smoke_mesh()
        dparams = shd.distribute_tree(params,
                                      shd.param_shardings(mesh, params))
        cache = model.init_cache(K, 64, torch.bfloat16)
        cache = shd.distribute_tree(
            cache, shd.cache_shardings(mesh, cache, model.CACHE_BATCH_AXES))

        def put(t):
            return shd.distribute_tree(t, shd.batch_shardings(mesh, t))

        ops.reset_counts()
        with shd.use_mesh(mesh), record_collectives() as coll:
            sharded = run(dparams, cache, put)
    finally:
        dist.destroy_process_group()
    counts = ops.counts()
    assert all(torch.equal(a, b) for a, b in zip(sharded, plain))
    for c in (counts, plain_counts):
        assert c["flash_attention"]["kernel"] == cfg.num_layers
        assert c["decode_attention"]["kernel"] == cfg.num_layers * steps
        assert all(v["plain"] == 0 for v in c.values())
    assert sum(coll.counts.values()) == 0
