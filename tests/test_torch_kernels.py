"""The port's kernel ops on the CPU: plain versions against the JAX oracles.

Same numpy inputs (fixed seeds) through ``repro.kernels.ref`` (the JAX
package's oracles, as ``tests/test_kernels.py`` holds its Pallas kernels to
them) and through ``repro_torch.kernels`` with CPU tensors.  Tolerances are
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
from repro_torch.kernels import fused_verify_sample as tfvs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref

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
    assert tops.counts() == {
        "paged_attention": {"kernel": 0, "plain": 1},
        "fused_verify_sample": {"kernel": 0, "plain": 1}}
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
    assert tpa.launches == 0 and tfvs.launches == 0


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
