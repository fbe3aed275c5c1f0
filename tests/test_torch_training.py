"""The port's training path on the CPU against the JAX package's.

Inputs are numpy with fixed seeds and go through both packages; parameters
cross with ``bridge.params_from_jax`` and gradients come back for the
comparison with ``bridge.params_to_jax``.  Tolerances:

* ``apply_gradients`` and ``schedule`` (float32 arithmetic on both sides):
  rtol 1e-6 on every output, bfloat16 moments included.
* ``lm_loss`` and its gradient per family (float32 smoke configs): the loss
  within rtol 1e-5; each gradient leaf within ``GRAD_TOL`` of
  ``jax.value_and_grad``'s, atol scaled by the leaf's largest entry: the
  two sum the same products in other orders.
* A few AdamW steps in both packages: losses within rtol 1e-5; parameters
  within an absolute 2 * lr * steps only, since Adam turns rounding noise in
  a near-zero gradient into an update of order lr (one sign flip moves a
  weight by up to 2 lr a step).

Training behaviour mirrors ``tests/test_training.py`` on the port:
microbatches equal the full batch, the loss falls, and a restart from a
checkpoint reproduces the uninterrupted run bit for bit; ``cfg.remat``
leaves the gradients unchanged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import build_model as jbuild_model
from repro.training import OptimizerConfig as JOptimizerConfig
from repro.training import apply_gradients as japply_gradients
from repro.training import init_optimizer as jinit_optimizer
from repro.training import lm_loss as jlm_loss
from repro.training import make_train_step as jmake_train_step
from repro.training.optimizer import schedule as jschedule
from repro_torch.bridge import params_from_jax, params_to_jax
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import build_model, has_prefix_embeds
from repro_torch.models.model_zoo import prefix_len
from repro_torch.training import (
    DataConfig,
    OptimizerConfig,
    SyntheticLMDataset,
    apply_gradients,
    init_optimizer,
    make_train_step,
)
from repro_torch.training.optimizer import schedule, tree_leaves
from repro_torch.training.train_loop import value_and_grad

GRAD_TOL = dict(rtol=1e-4, atol_scale=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(t):
    return t.detach().to(torch.float32).numpy()


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

def _opt_inputs(state_dtype, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (16, 8), "b": (8,), "emb": {"table": (32, 4)}}

    def draw(scale, positive=False):
        def leaf(shape):
            a = rng.standard_normal(shape).astype(np.float32) * scale
            return np.abs(a) if positive else a
        return jax.tree.map(leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))

    params, grads = draw(0.5), draw(0.4)         # global norm ~ 7: clipped
    m, v = draw(0.01), draw(1e-3, positive=True)
    return params, grads, m, v


def _to_torch(tree, dtype=None):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32))
                        .to(dtype or torch.float32), tree)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [3, 150])
def test_apply_gradients_matches_reference(state_dtype, step):
    """Warmup (step 3) and cosine decay (step 150), clipping active."""
    kw = dict(learning_rate=1e-2, warmup_steps=100, decay_steps=400,
              state_dtype=state_dtype)
    params, grads, m, v = _opt_inputs(state_dtype)
    jdt = jnp.bfloat16 if state_dtype == "bfloat16" else jnp.float32
    jstate = {"m": jax.tree.map(lambda a: jnp.asarray(a, jdt), m),
              "v": jax.tree.map(lambda a: jnp.asarray(a, jdt), v),
              "step": jnp.asarray(step, jnp.int32)}
    jp, js, jm = japply_gradients(JOptimizerConfig(**kw),
                                  jax.tree.map(jnp.asarray, params),
                                  jax.tree.map(jnp.asarray, grads), jstate)
    tdt = getattr(torch, state_dtype)
    # the same (rounded) moments on the port's side
    tstate = {"m": _to_torch(jax.tree.map(np.asarray, jstate["m"]), tdt),
              "v": _to_torch(jax.tree.map(np.asarray, jstate["v"]), tdt),
              "step": torch.tensor(step, dtype=torch.int32)}
    tp, ts, tm = apply_gradients(OptimizerConfig(**kw), _to_torch(params),
                                 _to_torch(grads), tstate)
    assert float(jm["grad_norm"]) > 1.0                  # clipping is on
    for want, got in ((jp, tp), (js["m"], ts["m"]), (js["v"], ts["v"])):
        for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
            np.testing.assert_allclose(_np(b), np.asarray(a, np.float32),
                                       rtol=1e-6)
    assert ts["m"]["w"].dtype == tdt and ts["step"].dtype == torch.int32
    assert int(ts["step"]) == step + 1
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 100, 2550, 5000, 10000, 20000])
def test_schedule_matches_reference(step):
    """Start, warmup's end, mid-decay, the decay's end and past it."""
    kw = dict(learning_rate=1e-3, warmup_steps=100, decay_steps=10000)
    want = float(jschedule(JOptimizerConfig(**kw), jnp.asarray(step)))
    got = schedule(OptimizerConfig(**kw), torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# lm_loss and its gradient, per family
# ---------------------------------------------------------------------------

FAMILIES = ["tinyllama-1.1b", "moonshot-v1-16b-a3b", "paligemma-3b",
            "mamba2-130m", "zamba2-2.7b", "whisper-large-v3"]


def _pair(arch, **over):
    cfg = get_config(arch).smoke().replace(**over)
    jm = jbuild_model(JModelConfig(**dataclasses.asdict(cfg)))
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    tparams = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return cfg, jm, jparams, tm, tparams


def _batch(cfg, B=2, S=12, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    prefix = (rng.standard_normal((B, prefix_len(cfg), cfg.d_model))
              .astype(np.float32) if has_prefix_embeds(cfg) else None)
    return tokens, prefix


def _assert_grads_close(jgrads, tgrads_jax_layout):
    flat = dict(jax.tree_util.tree_flatten_with_path(jgrads)[0])
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat.items()}
    got = {jax.tree_util.keystr(k): _np(v) for k, v in
           jax.tree_util.tree_flatten_with_path(tgrads_jax_layout)[0]}
    assert want.keys() == got.keys()
    for k, w in want.items():
        atol = GRAD_TOL["atol_scale"] * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[k], w, rtol=GRAD_TOL["rtol"],
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_loss_and_grads_match_jax(arch):
    cfg, jm, jparams, tm, tparams = _pair(arch)
    tokens, prefix = _batch(cfg)
    jprefix = None if prefix is None else jnp.asarray(prefix)
    (jloss, (jnll, _)), jgrads = jax.value_and_grad(
        lambda p: jlm_loss(jm, p, jnp.asarray(tokens), prefix_embeds=jprefix),
        has_aux=True)(jparams)
    tprefix = None if prefix is None else torch.from_numpy(prefix)
    loss, nll, grads = value_and_grad(tm, tparams, torch.from_numpy(tokens),
                                      tprefix)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(nll), float(jnll), rtol=1e-5)
    _assert_grads_close(jgrads, params_to_jax(cfg, grads))
    # the caller's parameters are left as they were
    assert not any(p.requires_grad for p in tree_leaves(tparams))


def test_train_steps_track_reference():
    """Three AdamW steps, two microbatches, dense smoke model."""
    cfg, jm, jparams, tm, tparams = _pair("tinyllama-1.1b")
    kw = dict(learning_rate=3e-3, warmup_steps=1, decay_steps=50)
    jstep = jax.jit(jmake_train_step(jm, JOptimizerConfig(**kw),
                                     microbatches=2))
    tstep = make_train_step(tm, OptimizerConfig(**kw), microbatches=2)
    jstate = jinit_optimizer(JOptimizerConfig(**kw), jparams)
    tstate = init_optimizer(OptimizerConfig(**kw), tparams)
    ds = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                       global_batch=8))
    steps = 3
    for s in range(steps):
        toks = ds.batch(s)["tokens"]
        jparams, jstate, jmet = jstep(jparams, jstate,
                                      {"tokens": jnp.asarray(toks)})
        tparams, tstate, tmet = tstep(tparams, tstate,
                                      {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
    atol = 2 * kw["learning_rate"] * steps
    got = params_to_jax(cfg, tparams)
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(got)):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# Training behaviour (tests/test_training.py on the port)
# ---------------------------------------------------------------------------

def _dense():
    cfg = get_config("tinyllama-1.1b").smoke()
    model = build_model(cfg, device="cpu")
    return cfg, model


def test_train_step_learns_on_synthetic_data():
    cfg, model = _dense()
    params = model.init(0)
    opt_cfg = OptimizerConfig(learning_rate=3e-3, warmup_steps=5,
                              decay_steps=200)
    opt_state = init_optimizer(opt_cfg, params)
    ds = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                       global_batch=8))
    step_fn = make_train_step(model, opt_cfg)
    losses = []
    for step in range(30):
        batch = {"tokens": torch.from_numpy(ds.batch(step)["tokens"])}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses[::10]
    assert np.isfinite(losses).all()


def test_microbatched_grads_match_full_batch():
    cfg, model = _dense()
    params = model.init(0)
    opt_cfg = OptimizerConfig(warmup_steps=0)
    ds = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                       global_batch=8))
    batch = {"tokens": torch.from_numpy(ds.batch(0)["tokens"])}
    full = make_train_step(model, opt_cfg, microbatches=1)
    micro = make_train_step(model, opt_cfg, microbatches=4)
    p1, _, m1 = full(params, init_optimizer(opt_cfg, params), batch)
    p2, _, m2 = micro(params, init_optimizer(opt_cfg, params), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-4, atol=2e-5)


def test_restart_resumes_training_bitexact(tmp_path):
    """Kill-and-restart: training from a checkpoint reproduces the
    uninterrupted run exactly (the data pipeline is step-indexed)."""
    cfg, model = _dense()
    opt_cfg = OptimizerConfig(warmup_steps=0)
    ds = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                       global_batch=4))
    step_fn = make_train_step(model, opt_cfg, microbatches=2)

    params = model.init(0)
    opt_state = init_optimizer(opt_cfg, params)
    mgr = CheckpointManager(str(tmp_path))
    for s in range(6):
        if s == 3:
            mgr.save_async(s, {"params": params, "opt": opt_state})
        batch = {"tokens": torch.from_numpy(ds.batch(s)["tokens"])}
        params, opt_state, _ = step_fn(params, opt_state, batch)
    mgr.wait()
    fresh = model.init(1)
    restored, meta = mgr.restore_latest(
        {"params": fresh, "opt": init_optimizer(opt_cfg, fresh)})
    p2, o2 = restored["params"], restored["opt"]
    assert meta["step"] == 3 and int(o2["step"]) == 3
    for s in range(meta["step"], 6):
        batch = {"tokens": torch.from_numpy(ds.batch(s)["tokens"])}
        p2, o2, _ = step_fn(p2, o2, batch)
    for a, b in zip(tree_leaves(params) + tree_leaves(opt_state),
                    tree_leaves(p2) + tree_leaves(o2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-large-v3"])
def test_train_step_is_repeatable_bit_for_bit(arch):
    """One step twice from the same state, 1,024 tokens on two threads:
    the same bits (the embedding backward sums repeated ids in a fixed
    order; advanced indexing's backward races here)."""
    cfg = get_config(arch).smoke()
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    opt_cfg = OptimizerConfig(warmup_steps=0)
    state = init_optimizer(opt_cfg, params)
    tokens, prefix = _batch(cfg, B=8, S=128)
    batch = {"tokens": torch.from_numpy(tokens)}
    if prefix is not None:
        batch["prefix_embeds"] = torch.from_numpy(prefix)
    step = make_train_step(model, opt_cfg, microbatches=2,
                           has_prefix=has_prefix_embeds(cfg))
    a, b = step(params, state, batch), step(params, state, batch)
    for x, y in zip(tree_leaves(a[:2]), tree_leaves(b[:2])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "moonshot-v1-16b-a3b",
                                  "mamba2-130m", "zamba2-2.7b",
                                  "whisper-large-v3"])
def test_remat_gives_the_same_grads(arch):
    """``cfg.remat`` recomputes each block in the backward: same loss, same
    gradients."""
    cfg = get_config(arch).smoke()
    tokens, prefix = _batch(cfg)
    tokens = torch.from_numpy(tokens)
    prefix = None if prefix is None else torch.from_numpy(prefix)
    out = []
    for remat in (False, True):
        model = build_model(cfg.replace(remat=remat), device="cpu")
        params = model.init(0)
        out.append(value_and_grad(model, params, tokens, prefix))
    (l0, _, g0), (l1, _, g1) = out
    assert float(l0) == float(l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-6, atol=1e-9)


def test_kernel_ops_refuse_grad_only_on_the_card():
    """The CPU route stays differentiable (the plain version); the guard the
    CUDA route runs refuses an input that requires grad under grad mode."""
    x = torch.randn(2, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops._no_grad_through("ssd_scan", x, None)
    with torch.no_grad():
        ops._no_grad_through("ssd_scan", x, None)
    ops._no_grad_through("ssd_scan", x.detach(), None)
    cfg = get_config("mamba2-130m").smoke()
    model = build_model(cfg, device="cpu")
    tokens, _ = _batch(cfg)
    ops.reset_counts()
    _, _, grads = value_and_grad(model, model.init(0),
                                 torch.from_numpy(tokens))
    assert float(grads["blocks"][0]["in_proj"].abs().sum()) > 0
    assert ops.counts()["ssd_scan"]["plain"] > 0
