"""The plain reference against the port's plain CPU path at test width:
the same weights (``lib/weights.py``, float32 here) give the same logits
through the port's full forward, its prefill and its verify window; the
reference's samplers agree with the port's plain residual sampler; the fp8
control moves the logits."""

import json

import numpy as np
import pytest
import torch

import smoke
from perfbench.lib import weights
from perfbench.lib.config import models
from perfbench.reference import accept

CFG = json.loads((smoke.DATA / "smoke_config.json").read_text())


def _pair(seed=5):
    """``(arch, dims, raw)`` of the smoke pair's target and draft, each
    through its architecture's module."""
    out = []
    for model, role in zip(models(CFG), ("target", "draft")):
        raw = weights.make(model, seed, role, "cpu", dtype=torch.float32)
        out.append((*model, raw))
    return out


@pytest.mark.parametrize("role", [0, 1], ids=["target", "draft"])
def test_reference_matches_the_ports_forward(role):
    from repro_torch.models.transformer import DecoderLM

    arch, m, raw = _pair()[role]
    model = DecoderLM(arch.port_config(m, "float32"), device="cpu")
    params = arch.port_tree(m, raw)
    seq = np.random.default_rng(1).integers(0, 500, 40).tolist()
    port, _ = model.apply(params, torch.tensor([seq]))
    ref = arch.Reference(m, raw, "cpu").logits_at([seq], [list(range(40))])[0]
    torch.testing.assert_close(ref, port[0], rtol=1e-4, atol=1e-4)


def test_reference_matches_prefill_then_window():
    from repro_torch.models.transformer import DecoderLM

    arch, m, raw = _pair()[0]
    model = DecoderLM(arch.port_config(m, "float32"), device="cpu")
    params = arch.port_tree(m, raw)
    seq = np.random.default_rng(2).integers(0, 500, 30).tolist()
    cache = model.init_cache(1, 64, torch.float32)
    _, cache, _ = model.prefill(params, torch.tensor([seq[:24]]), cache)
    win, _ = model.forward_window(params, torch.tensor([seq[24:]]), cache,
                                  torch.tensor([24]))
    ref = arch.Reference(m, raw, "cpu").logits_at(
        [seq], [list(range(24, 30))])[0]
    torch.testing.assert_close(ref, win[0], rtol=1e-4, atol=1e-4)


def test_control_moves_the_logits():
    arch, m, raw = _pair()[0]
    seq = list(range(1, 33))
    pos = [list(range(32))]
    a = arch.Reference(m, raw, "cpu").logits_at([seq], pos)[0]
    b = arch.Reference(m, raw, "cpu", fp8=True).logits_at([seq], pos)[0]
    assert 1e-4 < float((a - b).abs().max()) < 1.0


def test_samplers_agree_with_the_ports_plain_residual_sampler():
    from repro_torch.core.verification import truncate_renormalize
    from repro_torch.kernels.ref import residual_sample_ref

    g = torch.Generator().manual_seed(3)
    p_log = torch.randn(64, 3000, generator=g, dtype=torch.float64)
    q_log = torch.randn(64, 3000, generator=g, dtype=torch.float64) * 2
    u = torch.rand(64, generator=g, dtype=torch.float64)
    idx, val = truncate_renormalize(torch.softmax(q_log, -1), 16)
    q = torch.zeros(64, 3000, dtype=torch.float64).scatter_(1, idx.long(), val)
    port = residual_sample_ref(torch.softmax(p_log, -1), q, u)
    mine = accept.residual_token(p_log, q_log, 16, u)
    assert (port.long() == mine).float().mean() > 0.95
    assert float(accept.residual_miss(p_log, q_log, 16, u, port).max()) < 1e-5
    assert float(accept.residual_miss(p_log, q_log, 16, u, mine).max()) == 0
    wrong = (mine + 7) % 3000
    assert float(accept.residual_miss(p_log, q_log, 16, u, wrong).max()) > 1e-4


def test_gap_is_zero_at_the_argmax_only():
    lg = torch.tensor([[0.0, 2.0, 1.5], [3.0, -1.0, 0.0]])
    assert accept.gap(lg, lg.argmax(-1)).tolist() == [0.0, 0.0]
    assert accept.gap(lg, torch.tensor([2, 1])).tolist() == [0.5, 4.0]
