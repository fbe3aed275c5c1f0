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
``cases.residual_boundary_ok`` checks in float64.  Tree attention is held
like paged attention; ``gather_softmax_prob`` within 2e-5 relative
(``cases.GATHER_TOL``); ``residual_sample`` tokens may differ only at a CDF
step (``cases.cdf_step_ok``).  This file imports no jax.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import cases
from repro_torch.kernels import fused_verify_sample as fvs
from repro_torch.kernels import gather_softmax_prob as gsp
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import paged_tree_attention as pta
from repro_torch.kernels import residual_sample as rs
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


def test_ops_route_cuda_tensors_to_the_kernels(cuda):
    ops.reset_counts()
    args = paged_case(2, 3, 4, 2, 16, 16, 20, torch.float32, cuda)
    ops.paged_attention(*args)
    ops.fused_verify_sample(*verify_case(2, 3, 300, 8, cuda))
    ops.paged_tree_attention(*cases.tree_case(2, 2, 2, 4, 2, 16, 16, 20,
                                              torch.float32, cuda))
    ops.gather_softmax_prob(*cases.softmax_case(3, 300, cuda))
    ops.residual_sample(*cases.residual_case(3, 300, cuda))
    assert ops.counts() == {
        "paged_attention": {"kernel": 1, "plain": 0},
        "fused_verify_sample": {"kernel": 1, "plain": 0},
        "paged_tree_attention": {"kernel": 1, "plain": 0},
        "gather_softmax_prob": {"kernel": 1, "plain": 0},
        "residual_sample": {"kernel": 1, "plain": 0}}


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
]


@pytest.mark.parametrize("shape", TREE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chain", [False, True])
def test_paged_tree_attention_kernel_matches_plain(cuda, shape, dtype, chain):
    """Tree masks from ``build_token_tree`` (with B > 2 the last row is
    retired and gives 0); a chain mask must also equal paged attention at
    lengths + 1."""
    args = cases.tree_case(*shape, dtype=dtype, device=cuda, chain=chain)
    got = pta.paged_tree_attention_cuda(*args)
    want = cases.tree_attention_held(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    rtol, atol = cases.PAGED_TOL[dtype]
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)
    if shape[0] > 2:
        assert torch.all(got[-1] == 0)
    if chain:
        q, kp, vp, pt, ln, _ = args
        assert torch.equal(got, pa.paged_attention_cuda(q, kp, vp, pt, ln + 1))


def test_paged_tree_attention_refuses_a_65_token_window(cuda):
    args = cases.tree_case(1, 8, 8, 4, 2, 16, 16, 40, torch.float32, cuda)
    with pytest.raises(ValueError, match="at most 64"):
        pta.paged_tree_attention_cuda(*args)
    with pytest.raises(ValueError, match="bool"):
        pta.paged_tree_attention_cuda(*cases.tree_case(
            1, 2, 2, 4, 2, 16, 16, 40, torch.float32, cuda)[:5],
            torch.ones((1, 5, 5), dtype=torch.uint8, device=cuda))


@pytest.mark.parametrize("N,V", [(5, 300), (96, 32000), (384, 32000),
                                 (96, 151936), (3, 1)])
def test_gather_softmax_prob_kernel_matches_plain(cuda, N, V):
    logits, ids = cases.softmax_case(N, V, cuda)
    got = gsp.gather_softmax_prob_cuda(logits, ids)
    want = gsp.gather_softmax_prob_plain(logits, ids)
    rtol, atol = cases.GATHER_TOL
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("N,V", [(8, 300), (8, 32000), (8, 151936), (5, 4097)])
def test_residual_sample_kernel_matches_plain(cuda, N, V):
    """Reject rows, two zero-residual rows (the first of tied maxima wins)
    and a row where nothing crosses (V - 1)."""
    p, q, u = cases.residual_case(N, V, cuda)
    got = rs.residual_sample_cuda(p, q, u)
    want = rs.residual_sample_plain(p, q, u)
    rep = cases.compare_residual(got, want, p, q, u)
    assert rep["diff_rows_at_cdf_step"], rep
    tok = got.cpu()
    assert int(tok[0]) == int(p[0].argmax()) and int(tok[2]) == V - 1
    tied = (p[1] == p[1].max()).nonzero().flatten().cpu()
    assert len(tied) == 2 and int(tok[1]) == int(tied[0])


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


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return [_to(v, device) for v in tree]
