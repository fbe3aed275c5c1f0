"""Values pinned when Qwen2 moved into ``perfbench/arch/qwen2forcausallm.py``,
recorded on the CPU with the harness as it was before the move: the smoke
pair's weights (seed 0, float32) and its reference logits, in float32 and
in the fp8 control, as SHA-256 of their bytes; the FLOPs of drafting,
verifying and prefilling, and the B1 totals of one round and one prefill,
at the smoke pair's dims and at every configuration's published ones; and
the ``models.mfu`` and ``paged_attention_roofline`` readers on a fixed
profile.  Any drift in the arithmetic fails here."""

import hashlib
import json

import numpy as np
import pytest
import torch

import smoke
from perfbench.costs import model as cost
from perfbench.costs import paged_attention as pa
from perfbench.lib import manifest, peaks, weights
from perfbench.lib.config import models

CONFIGS = {"smoke": smoke.DATA / "smoke_config.json",
           **{p.stem: p for p in (smoke.ROOT / "perfbench" / "configs")
              .glob("*.json")}}

WEIGHTS = {
    "target": "e7e90fc798bac938cb4dd797a476cc8eab997434346006e45b60b6fbefa22510",
    "draft": "8436ff9d3bc3f4f0b66c8a0d1e8ebc69e093f9491f20cd0a1d3fcc9584e5607f",
}
LOGITS = {  # (fp8, role): digest, logits[(0, 0), (1, 100), (2, 511)]
    (False, "target"): (
        "527519f5b1b9e1b07496519599ad5186d8a08ef49b628c6836bfeaf4ec3ce3b0",
        [0.08774200826883316, -0.14345577359199524, -0.022497931495308876]),
    (True, "target"): (
        "b86d6812649db15f0b028677a4e2f6c5456bb5368a3ee751a1844b901c31ce66",
        [0.07932611554861069, -0.13801006972789764, -0.018257703632116318]),
    (False, "draft"): (
        "4d09f57238abbe4a7923f944292225ef1c5f14626fca3be1e7ab1b51cf2f1687",
        [0.07434439659118652, 0.1570318043231964, 0.04918227717280388]),
    (True, "draft"): (
        "cabec7c1fe1321f173d73b9e4219f146ab423b0fadc6537a379cea469f39bb69",
        [0.07215418666601181, 0.15349391102790833, 0.05090555176138878]),
}
# (pos, L): [draft_needed, verify_needed]; "prefill": prefill_needed of the
# pair at M = 2, 129, 3000; "round" (pos 5, 130, 999, 15000; L 6) and
# "prefill_b1" (bucket 2048): B1 [flops, bytes, least seconds] summed
FLOPS = {
    "smoke": {
        (0, 1): [70016.0, 427520.0], (37, 4): [248832.0, 1167360.0],
        (1000, 8): [1585792.0, 6547968.0],
        (12000, 3): [6317312.0, 25433088.0],
        "prefill": [166528.0, 26517504.0, 3376538112.0],
        "round": [72352000.0, 11427132.0, 3.411084179104478e-06],
        "prefill_b1": [1341521920.0, 1966668.0, 1.3564427906976742e-06]},
    "qwen2.5-3b_qwen2.5-0.5b": {
        (0, 1): [1703833600.0, 12343672832.0],
        (37, 4): [4684546048.0, 30915952640.0],
        (1000, 8): [9397047296.0, 58210025472.0],
        (12000, 3): [7809048576.0, 38844301312.0],
        "prefill": [6265098240.0, 805028757504.0, 20501491826688.0],
        "round": [43063910400.0, 1996448592.0, 0.0005959548035820896],
        "prefill_b1": [798473846784.0, 880404720.0, 0.0008073547490232548]},
    "qwen2.5-7b_qwen2.5-0.5b": {
        (0, 1): [1703833600.0, 28280512512.0],
        (37, 4): [4684546048.0, 70778552320.0],
        (1000, 8): [9397047296.0, 130887622656.0],
        (12000, 3): [7809048576.0, 75830214656.0],
        "prefill": [13766717440.0, 1766101614592.0, 43477600681984.0],
        "round": [55103283200.0, 2330395760.0, 0.0006956405253731333],
        "prefill_b1": [1021703094272.0, 1140320464.0, 0.001033066829395349]},
}
READERS = {  # [models.mfu, paged_attention_roofline] on PROFILE
    "qwen2.5-3b_qwen2.5-0.5b": [3.395252705801146, 3.318335263671319],
    "qwen2.5-7b_qwen2.5-0.5b": [7.230530073850219, 4.190444158187681],
}
PROFILE = {
    "busy_s": 0.5, "window_s": 0.75,
    "kernels": [("void paged_attention_kernel<1>", 0.125), ("other", 1.0)],
    "rounds": [{"pos": [5, 130, 999], "lengths": [3, 8, 1], "L": 8,
                "buckets": [], "prompts": []},
               {"pos": [6000, 14000], "lengths": [2, 5], "L": 5,
                "buckets": [1024, 4096], "prompts": [700, 3000]}]}


def _pair(name):
    return models(json.loads(CONFIGS[name].read_text()))


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for name, t in tensors:
        h.update(name.encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("role", ["target", "draft"])
def test_weights_and_reference_logits(role):
    model = _pair("smoke")[role == "draft"]
    raw = weights.make(model, 0, role, "cpu", dtype=torch.float32)
    assert _digest(raw.items()) == WEIGHTS[role]
    seq = np.random.default_rng(1).integers(0, 500, 40).tolist()
    for fp8 in (False, True):
        ref = model.arch.Reference(model.dims, raw, "cpu", fp8=fp8)
        lg = ref.logits_at([seq], [[0, 17, 39]])[0]
        digest, sample = LOGITS[(fp8, role)]
        assert [float(lg[i, j]) for i, j in ((0, 0), (1, 100), (2, 511))] \
            == sample
        assert hashlib.sha256(lg.numpy().tobytes()).hexdigest() == digest


def _b1_total(calls):
    fl = nb = least = 0.0
    for layer, rows in calls:
        f, b = pa.call_cost(layer, rows)
        fl += f
        nb += b
        least += peaks.least_seconds(f, b)
    return [fl, nb, least]


@pytest.mark.parametrize("name", sorted(FLOPS))
def test_flops_and_b1_totals(name):
    target, draft = _pair(name)
    want = FLOPS[name]
    for pos, L in ((0, 1), (37, 4), (1000, 8), (12000, 3)):
        assert [cost.draft_needed(draft, pos, L),
                cost.verify_needed(target, pos, L)] == want[(pos, L)]
    assert [cost.prefill_needed(target, M) + cost.prefill_needed(draft, M)
            for M in (2, 129, 3000)] == want["prefill"]
    assert _b1_total(pa.round_calls(target, draft, [5, 130, 999, 15000],
                                    6)) == want["round"]
    assert _b1_total(pa.prefill_calls(target, draft, 2048)) \
        == want["prefill_b1"]


@pytest.mark.parametrize("name", sorted(READERS))
def test_readers(name):
    ctx = {"profile": PROFILE, "models": _pair(name), "peaks": peaks}
    assert [manifest.reader("models.mfu")(ctx),
            manifest.reader("paged_attention_roofline")(ctx)] \
        == READERS[name]
