"""Decode attention (B7), flash attention (B8), their routes on the
contiguous layout and the plain ``ServingEngine``, on the CPU against the
JAX package.

The plain versions are held against ``repro.kernels.ref`` and against the
Pallas kernels in interpret mode: float32 within 2e-5 and bfloat16 within
2e-2 (``_tol`` of ``tests/test_kernels.py``).  Decode rows cover lengths 1,
S, past S and in between; a row of length 0 equals the oracle (the mean of
its values) and is 0 in the Pallas kernel, so the interpreter is compared
on live rows only.  The layer routes (a contiguous prefill through
``ops.flash_attention``, T = 1 windows through ``ops.decode_attention``) of
the dense and hybrid smoke models give the JAX model's logits and caches
within 2e-5.  The port's ``ServingEngine`` commits the tokens of
``repro.serving.engine.ServingEngine`` on the deepseek-7b smoke config,
greedy and sampled with the reference's own Gumbel draws replayed; the
reference engine runs in a subprocess (this file as a script), as in
``tests/test_torch_engine.py``.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ssm import _model_pair

from repro.kernels import ref as jref
from repro_torch import configs as tcfgs
from repro_torch.kernels import cases
from repro_torch.kernels import ops as tops

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _jax(t: torch.Tensor, dtype):
    return jnp.asarray(t.float().numpy()).astype(dtype)


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# plain versions against the JAX oracle and the Pallas interpreter
# ---------------------------------------------------------------------------

# lengths of one S = 48 cache: 1, S, past S, in between, and a dead row
DECODE_LENGTHS = [1, 48, 60, 23, 0]


@pytest.mark.parametrize("D", [64, 80])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_plain_matches_jax(D, dtype):
    """GQA (G = 4 query heads per kv head) over 48 cache slots, walked by
    the interpreter in three 16-key tiles."""
    from repro.kernels.decode_attention import decode_attention_pallas

    q, kc, vc, ln = cases.decode_case(5, 8, 2, D, 48, DECODE_LENGTHS, dtype,
                                      "cpu", seed=D)
    got = tops.decode_attention(q, kc, vc, ln).float().numpy()
    jd = JDTYPE[dtype]
    jargs = (_jax(q, jd), _jax(kc, jd), _jax(vc, jd), jnp.asarray(ln.numpy()))
    want = _np(jref.decode_attention_ref(*jargs))
    np.testing.assert_allclose(got, want, **TOL[dtype])
    pallas = _np(decode_attention_pallas(*jargs, bs=16, interpret=True))
    live = ln.numpy() > 0
    np.testing.assert_allclose(got[live], pallas[live], **TOL[dtype])
    assert not pallas[~live].any(), "the Pallas kernel returns 0 for a dead row"


FLASH_CASES = [
    # (B, Sq, Skv, H, KV, D, causal)
    (2, 20, 20, 8, 2, 64, True),      # the prefill: Sq = Skv
    (2, 12, 20, 8, 2, 80, True),      # Sq < Skv: the bottom-right diagonal
    (2, 20, 20, 8, 2, 64, False),     # non-causal
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_plain_matches_jax(case, dtype):
    """The interpreter walks 8 x 8 tiles with padding on both axes and
    skips the tiles above the diagonal."""
    from repro.kernels.flash_attention import flash_attention_pallas

    B, Sq, Skv, H, KV, D, causal = case
    q, k, v = cases.flash_case(B, Sq, Skv, H, KV, D, dtype, "cpu", seed=Sq)
    got = tops.flash_attention(q, k, v, causal=causal).float().numpy()
    jd = JDTYPE[dtype]
    jargs = (_jax(q, jd), _jax(k, jd), _jax(v, jd))
    want = _np(jref.flash_attention_ref(*jargs, causal=causal))
    np.testing.assert_allclose(got, want, **TOL[dtype])
    pallas = _np(flash_attention_pallas(*jargs, causal=causal, bq=8, bk=8,
                                        interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL[dtype])


def test_decode_attention_is_the_last_row_of_the_prefill():
    """Attention of the last query of a causal prefill over its keys equals
    decode attention over those keys at lengths Skv."""
    q, k, v = cases.flash_case(3, 9, 9, 8, 2, 16, torch.float32, "cpu")
    full = tops.flash_attention(q, k, v)
    last = tops.decode_attention(q[:, -1].contiguous(), k, v,
                                 torch.full((3,), 9, dtype=torch.int32))
    torch.testing.assert_close(last, full[:, -1], **TOL[torch.float32])


# ---------------------------------------------------------------------------
# the routes of the contiguous layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-7b", "zamba2-2.7b"])
def test_contiguous_prefill_and_steps_route_through_b7_b8(arch):
    """A contiguous prefill runs ``ops.flash_attention`` once per attention
    layer (the dense stack's layers, the hybrid's shared-block
    invocations) and a window of two T = 1 steps ``ops.decode_attention``
    once per layer and step (the dense model takes them as two calls, the
    hybrid as one window of per-token steps); one row's step lies past the
    end of the cache, where the write lands at S - 1 and all S keys are
    seen.  Logits and caches equal the JAX model's, which runs
    ``gqa_attention`` over the whole cache under its mask."""
    cfg, jm, jp, tm, tp = _model_pair(arch)
    n_attn = (cfg.num_layers // cfg.hybrid_group if cfg.family == "hybrid"
              else cfg.num_layers)
    rng = np.random.default_rng(9)
    Bm, M, S = 3, 10, 20
    toks = rng.integers(0, cfg.vocab_size, (Bm, M)).astype(np.int32)
    jc = jm.init_cache(Bm, S, jnp.float32)
    tc = tm.init_cache(Bm, S, torch.float32)
    jl_, jc, _ = jm.prefill(jp, jnp.asarray(toks), jc)
    tops.reset_counts()
    tl_, tc, _ = tm.prefill(tp, torch.from_numpy(toks), tc)
    c = tops.counts()
    assert c["flash_attention"]["plain"] == n_attn
    assert c["decode_attention"]["plain"] == 0
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), **TOL[torch.float32])
    for leaf in ("k", "v"):
        np.testing.assert_allclose(tc[leaf].numpy(), np.asarray(jc[leaf]),
                                   **TOL[torch.float32])
    pos = np.array([M, M - 4, S + 1], np.int32)      # row 2 past the end
    steps = rng.integers(0, cfg.vocab_size, (Bm, 2)).astype(np.int32)
    tops.reset_counts()
    if cfg.family == "hybrid":
        jl_, jc = jm.forward_window(jp, jnp.asarray(steps), jc, jnp.asarray(pos))
        tl_, tc = tm.forward_window(tp, torch.from_numpy(steps), tc,
                                    torch.from_numpy(pos))
    else:
        jls, tls = [], []
        for t in range(2):
            out, jc = jm.forward_window(jp, jnp.asarray(steps[:, t:t + 1]), jc,
                                        jnp.asarray(pos + t))
            jls.append(np.asarray(out))
            out, tc = tm.forward_window(tp, torch.from_numpy(steps[:, t:t + 1]),
                                        tc, torch.from_numpy(pos + t))
            tls.append(out.numpy())
        jl_, tl_ = np.concatenate(jls, 1), torch.from_numpy(np.concatenate(tls, 1))
    c = tops.counts()
    assert c["decode_attention"]["plain"] == 2 * n_attn
    assert c["flash_attention"]["plain"] == 0
    assert all(v["kernel"] == 0 for v in c.values())
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), **TOL[torch.float32])
    for leaf in jc:
        np.testing.assert_allclose(tc[leaf].numpy(), np.asarray(jc[leaf]),
                                   **TOL[torch.float32])


def test_contiguous_verify_window_keeps_its_mask():
    """A T > 1 sequential window at per-row offsets (the J=1 verify window)
    still runs ``gqa_attention`` under its mask, and refuses to run without
    one."""
    from repro_torch.models.layers import attention_apply

    cfg, _, _, tm, tp = _model_pair("deepseek-7b")
    cache = tm.init_cache(2, 16, torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (2, 3),
                         generator=torch.Generator().manual_seed(0))
    tops.reset_counts()
    tm.forward_window(tp, toks, cache, torch.tensor([4, 6]))
    assert all(v == {"kernel": 0, "plain": 0} for v in tops.counts().values())
    x = torch.zeros((2, 3, cfg.d_model))
    with pytest.raises(ValueError, match="needs its mask"):
        attention_apply(tp["blocks"][0]["attn"], x, num_heads=cfg.num_heads,
                        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                        positions=torch.zeros((2, 3), dtype=torch.long),
                        rope_theta=cfg.rope_theta,
                        kv_cache=(cache["k"][0], cache["v"][0]),
                        cache_offset=torch.tensor([4, 6]))


# ---------------------------------------------------------------------------
# the plain serving engine (reference in a subprocess: this file as a script)
# ---------------------------------------------------------------------------

ARCH, MAX_LEN, N_TOKENS, TEMPERATURE = "deepseek-7b", 48, 6, 0.8


def _prompts():
    return np.random.default_rng(12).integers(0, 257, (3, 9)).astype(np.int32)


def _reference(out_path):
    from repro.configs import get_config
    from repro.serving.engine import ServingEngine

    cfg = get_config(ARCH).smoke()
    eng = ServingEngine(cfg, max_len=MAX_LEN)
    eng.init_params(jax.random.PRNGKey(0))
    prompts = jnp.asarray(_prompts())
    key = jax.random.PRNGKey(5)
    out = {"params": jax.tree.map(np.asarray, eng.params),
           "greedy": eng.generate(prompts, N_TOKENS, key, temperature=0),
           "sampled": eng.generate(prompts, N_TOKENS, key,
                                   temperature=TEMPERATURE),
           # the draws jax.random.categorical takes in each decode step
           "gumbel": np.stack([np.asarray(jax.random.gumbel(
               k, (prompts.shape[0], cfg.vocab_size), jnp.float32))
               for k in jax.random.split(key, N_TOKENS)])}
    for name in ("greedy", "sampled"):
        out[name] = [[int(t) for t in row] for row in out[name]]
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_ref") / "ref.pkl"
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.setdefault("JAX_PLATFORMS", "cpu")
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "reference", str(path)], env=env, cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, f"reference run failed:\n{res.stdout}\n{res.stderr}"
    with open(path, "rb") as f:
        return pickle.load(f)


def _port_engine(ref):
    from repro_torch.serving import ServingEngine

    eng = ServingEngine(tcfgs.get_config(ARCH).smoke(), max_len=MAX_LEN,
                        device="cpu")
    eng.load_params(ref["params"])
    return eng


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_serving_engine_matches_reference(ref, mode):
    """Greedy, and sampled at temperature 0.8 with the reference's Gumbel
    draws replayed: identical committed tokens, the prefill through
    ``ops.flash_attention`` and every step through
    ``ops.decode_attention``, one host fetch a step."""
    eng = _port_engine(ref)
    cfg = eng.cfg
    tops.reset_counts()
    if mode == "greedy":
        got = eng.generate(torch.from_numpy(_prompts()), N_TOKENS, temperature=0)
    else:
        got = eng.generate(torch.from_numpy(_prompts()), N_TOKENS,
                           torch.from_numpy(ref["gumbel"]),
                           temperature=TEMPERATURE)
    assert [[int(t) for t in row] for row in got] == ref[mode]
    c = tops.counts()
    assert c["flash_attention"]["plain"] == cfg.num_layers
    assert c["decode_attention"]["plain"] == N_TOKENS * cfg.num_layers
    assert eng.host_syncs == N_TOKENS
    assert ref["greedy"] != ref["sampled"]


def test_serving_engine_samples_from_a_generator(ref):
    """``generate`` draws its noise from a ``torch.Generator``: the same
    seed gives the same tokens, a sampled step needs noise."""
    eng = _port_engine(ref)
    prompts = torch.from_numpy(_prompts())
    a = eng.generate(prompts, 4, torch.Generator().manual_seed(3))
    b = eng.generate(prompts, 4, torch.Generator().manual_seed(3))
    assert a == b and all(len(row) == 9 + 4 for row in a)
    st = eng.start(prompts)
    with pytest.raises(ValueError, match="Gumbel noise"):
        eng.decode_step(st)


if __name__ == "__main__":
    assert sys.argv[1] == "reference"
    _reference(sys.argv[2])
