"""Int8-KV decode attention (B9) and ``quantize_kv`` on the CPU against the
JAX package.

Inputs are made from a numpy seed and handed to both packages.  The port's
``quantize_kv`` must give the JAX function's int8 codes and float32 scales
bit for bit.  ``ops.decode_attention_q8`` (the plain version on a CPU
tensor) is held against ``repro.kernels.ref.decode_attention_quantized_ref``
within 2e-5 at a float32 q and within ``cases.PAGED_TOL[bfloat16]`` after
the oracle's float32 output is cast to bfloat16, and against
``decode_attention_q8_pallas`` in interpret mode on its live rows.  The
three places where the port picks a side (ROADMAP §C) each have a test:
the output dtype is q's (as the Pallas kernel; the oracle promotes to
float32), a row past S attends exactly S keys (as the oracle; the Pallas
kernel also attends its zero padding when S is not a multiple of its
block), and a row of length 0 is the oracle's mean in the plain version
and 0 in the Pallas kernel (the CUDA kernel returns 0, tested on the card).
The bf16 CUDA route's arithmetic (B7's window body over the codes as
bf16, ``k_scale`` in the score scale, ``v_scale`` on the output, B7's split
of the key axis) is emulated in plain torch and held against the oracle; at
unit scales it is the B7 emulation on the codes, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_q8_pallas
from repro_torch.kernels import cases
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from test_torch_kernels import _merge_splits

JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(zip(("rtol", "atol"),
                                cases.PAGED_TOL[torch.bfloat16]))}


def _inputs(B, S, H, KV, D, lengths, dtype, seed):
    """(q, k, v, lengths) as torch tensors from a numpy seed: q, v ~ N(0, 1),
    k ~ 3 N(0, 1) (a wider spread than v, as RoPE'd keys), in ``dtype``."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = 3 * rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    return (torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
            torch.from_numpy(v).to(dtype),
            torch.tensor(lengths, dtype=torch.int32))


def _jax(t: torch.Tensor):
    """The same values as a jax array (bfloat16 passes exactly via float32)."""
    if t.dtype in JDTYPE:
        return jnp.asarray(t.float().numpy()).astype(JDTYPE[t.dtype])
    return jnp.asarray(t.numpy())


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_same_quantization(k, v):
    got = tops.quantize_kv(k, v)
    want = jref.quantize_kv(_jax(k), _jax(v))
    for g, w in zip(got, want):
        assert g.dtype == (torch.int8 if w.dtype == jnp.int8 else torch.float32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("D", [64, 80])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_kv_equals_jax_bit_for_bit(D, dtype):
    """Codes and scales are identical, ties to even included: a row of
    exact half-steps (x = (n + 1/2) * scale) rounds as ``jnp.round``."""
    _, k, v, _ = _inputs(3, 40, 4, 2, D, [40] * 3, dtype, seed=D)
    _assert_same_quantization(k, v)
    half = torch.arange(-5, 6, dtype=torch.float32) + 0.5
    k = torch.zeros((1, 2, 1, D))
    k[0, 0, 0, :11] = half
    k[0, 1, 0, 0] = 127.0                  # scale 1: x / scale is x itself
    _assert_same_quantization(k.to(dtype), k.to(dtype))


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_q8_plain_matches_jax_oracle(G, dtype):
    """Rows at lengths 1, S, past S and in between; the oracle's float32
    output is cast to q's dtype first (the port's output dtype)."""
    KV, S = 2, 48
    q, k, v, ln = _inputs(4, S, G * KV, KV, 64, [1, S, S + 12, 23], dtype,
                          seed=10 * G)
    kq, ks, vq, vs = tops.quantize_kv(k, v)
    tops.reset_counts()
    got = tops.decode_attention_q8(q, kq, vq, ks, vs, ln)
    assert tops.counts()["decode_attention_q8"] == {"kernel": 0, "plain": 1}
    want = jref.decode_attention_quantized_ref(
        _jax(q), _jax(kq), _jax(vq), _jax(ks), _jax(vs), _jax(ln))
    want = _np(jnp.asarray(want).astype(JDTYPE[dtype]))
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


def test_output_dtype_is_q_dtype():
    """For a bfloat16 q the JAX oracle returns float32 (its dequantized
    caches promote the product), the Pallas kernel bfloat16; the port
    returns q's dtype, as the Pallas kernel and B7."""
    q, k, v, ln = _inputs(2, 32, 4, 2, 64, [32, 9], torch.bfloat16, seed=3)
    kq, ks, vq, vs = tops.quantize_kv(k, v)
    jargs = tuple(_jax(t) for t in (q, kq, vq, ks, vs, ln))
    assert jref.decode_attention_quantized_ref(*jargs).dtype == jnp.float32
    assert decode_attention_q8_pallas(*jargs, bs=16,
                                      interpret=True).dtype == jnp.bfloat16
    assert tops.decode_attention_q8(q, kq, vq, ks, vs, ln).dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_q8_plain_matches_pallas_interpret(dtype):
    """The interpreter walks S = 48 in three 16-key tiles (S a multiple of
    its block).  Live rows agree; a row of length 0 is 0 in the Pallas
    kernel and the oracle's mean of its S values in the plain version."""
    S = 48
    q, k, v, ln = _inputs(5, S, 8, 2, 64, [1, S, S + 5, 17, 0], dtype, seed=7)
    kq, ks, vq, vs = tops.quantize_kv(k, v)
    got = tops.decode_attention_q8(q, kq, vq, ks, vs, ln).float().numpy()
    jargs = tuple(_jax(t) for t in (q, kq, vq, ks, vs, ln))
    pallas = _np(decode_attention_q8_pallas(*jargs, bs=16, interpret=True))
    live = ln.numpy() > 0
    np.testing.assert_allclose(got[live], pallas[live], **TOL[dtype])
    assert not pallas[~live].any(), "the Pallas kernel returns 0 for a dead row"
    oracle = _np(jref.decode_attention_quantized_ref(*jargs))
    np.testing.assert_allclose(got[~live], oracle[~live], **TOL[dtype])
    assert np.abs(got[~live]).max() > 0


def test_rows_past_s_attend_exactly_s_keys():
    """At S = 40 the Pallas kernel pads the caches to its 16-key block and a
    row past S also attends the 8 zero keys of the padding; the oracle and
    the port attend exactly S.  Rows below S agree on all three."""
    S = 40
    q, k, v, ln = _inputs(3, S, 4, 2, 64, [S + 9, 30, S], torch.float32,
                          seed=5)
    kq, ks, vq, vs = tops.quantize_kv(k, v)
    got = tops.decode_attention_q8(q, kq, vq, ks, vs, ln).numpy()
    jargs = tuple(_jax(t) for t in (q, kq, vq, ks, vs, ln))
    oracle = _np(jref.decode_attention_quantized_ref(*jargs))
    pallas = _np(decode_attention_q8_pallas(*jargs, bs=16, interpret=True))
    np.testing.assert_allclose(got, oracle, **TOL[torch.float32])
    np.testing.assert_allclose(got[1:], pallas[1:], **TOL[torch.float32])
    assert np.abs(got[0] - pallas[0]).max() > 1e-3, "padding attended"


@pytest.mark.parametrize("G", [1, 4])
def test_int8_route_stays_within_the_budget_of_exact_kv(G):
    """The int8 route against exact attention on the unquantized caches:
    within 0.05 (the budget of ``tests/test_kernels.py``'s
    ``test_quantized_kv_close_to_exact``), unit-normal K/V."""
    B, S, KV, D = 2, 256, 4 // G, 64
    rng = np.random.default_rng(12 + G)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, G * KV, D), (B, S, KV, D), (B, S, KV, D)))
    ln = torch.full((B,), S, dtype=torch.int32)
    kq, ks, vq, vs = tops.quantize_kv(k, v)
    quant = tops.decode_attention_q8(q, kq, vq, ks, vs, ln).numpy()
    exact = _np(jref.decode_attention_ref(_jax(q), _jax(k), _jax(v), _jax(ln)))
    err = np.abs(quant - exact).max()
    assert 0 < err < 0.05, err


def test_quantize_a_prefilled_bf16_cache_slab():
    """Each layer's (B, S, KV, D) bfloat16 K/V view of a ``DecoderLM``
    contiguous cache after a smoke prefill quantizes to the JAX function's
    codes and scales exactly; the view is what the int8 path on the card
    quantizes."""
    from repro_torch import configs as tcfgs
    from repro_torch.models import build_model

    cfg = tcfgs.get_config("deepseek-7b").smoke()
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (3, 9)).astype(np.int32))
    cache = model.init_cache(3, 16, torch.bfloat16)
    _, cache, _ = model.prefill(params, toks, cache)
    for layer in range(cfg.num_layers):
        k, v = cache["k"][layer], cache["v"][layer]
        assert k.dtype == torch.bfloat16 and k.is_contiguous()
        assert k[:, :9].abs().amax() > 0 and not k[:, 9:].any()
        _assert_same_quantization(k, v)


# name, (B, H, KV, D, S), lengths, SMs: B9's bf16 grids, split (fewer
# blocks than SMs) and not
Q8_SPLIT_CASES = [
    ("split, a row of length 0", (3, 8, 2, 16, 256), [0, 200, 37], 132),
    ("split, lengths past S", (2, 8, 4, 32, 192), [250, 192], 132),
    ("split, G = 8 at D = 80", (2, 8, 1, 80, 320), [300, 65], 132),
    ("no split at D = 128", (3, 4, 2, 128, 130), [130, 1, 64], 4),
]


@pytest.mark.parametrize("case", Q8_SPLIT_CASES,
                         ids=[c[0] for c in Q8_SPLIT_CASES])
def test_q8_window_arithmetic_matches_jax_oracle(case):
    """The bf16 route of B9 in plain torch: the int8 codes as bf16 (exact),
    ``k_scale`` joined to the score scale, ``v_scale`` on the output, B7's
    split plan and merge (``_merge_splits``).  Against the JAX oracle:
    within the float32 band, and within the bf16 band once the output is
    rounded to bf16 as the kernel stores it; a row of length 0 gives 0.  At
    unit scales it equals the B7 emulation on the codes bit for bit."""
    name, (B, H, KV, D, S), lengths, n_sm = case
    q, k, v, ln = _inputs(B, S, H, KV, D, lengths, torch.bfloat16,
                          seed=len(name))
    kq, ks, vq, vs = tops.quantize_kv(k, v)
    _, _, n_split, split_keys = tda.split_plan(q, kq, n_sm)
    assert (n_split > 1) == (B * KV < n_sm)
    ranges = tpa.window_split_ranges(S, n_split, split_keys)
    seen = (torch.arange(S)[None] < ln.long()[:, None])[:, None]
    qf = q.float()[:, None]
    kc, vc = (c.to(torch.bfloat16).float() for c in (kq, vq))
    got = _merge_splits(qf, kc, vc, seen, ranges, ks, vs)[:, 0]
    live = ln > 0
    want = _np(jref.decode_attention_quantized_ref(
        *(_jax(t) for t in (q, kq, vq, ks, vs, ln))))[live.numpy()]
    np.testing.assert_allclose(got[live].numpy(), want, **TOL[torch.float32])
    np.testing.assert_allclose(got.to(torch.bfloat16).float()[live].numpy(),
                               want, **TOL[torch.bfloat16])
    assert not got[~live].any()
    ones = torch.ones_like(ks)
    assert torch.equal(_merge_splits(qf, kc, vc, seen, ranges, ones, ones),
                       _merge_splits(qf, kc, vc, seen, ranges))
