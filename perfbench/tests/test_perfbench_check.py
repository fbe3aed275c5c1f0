"""The check decides ``correct`` by comparison with the plain reference:
a sound run passes, the control (the fp8 reference in the program's place)
and each fault the cells can have (a commit that leaves the state
unchanged, half the batch verified on the other half's logits, a token
altered where it is produced) come out not correct.  One chip, so no
exchange between chips to leave out.  CPU, the smoke pair (``smoke.py``)."""

import pytest
import torch

from smoke import run


def test_sound_run_is_correct():
    out = run()
    assert out["correct"], out["check"]
    assert out["info"]["judged"]["bonus"] > 0
    assert out["info"]["judged"]["residual"] > 0
    assert out["check"]["count_miss"]["value"] == 0
    assert out["check"]["pages_leaked"]["value"] == 0


def test_control_is_not_correct():
    from perfbench.lib import check

    out = run(control=True)
    ctl = dict(out["control"], count_miss=0.0, pages_leaked=0.0)
    ok, table = check.judge(ctl, {k: v["limit"]
                                  for k, v in out["check"].items()})
    assert not ok, table


def test_commit_leaving_state_unchanged_is_caught(monkeypatch):
    from repro_torch.serving import compiled

    sound = compiled.commit_step

    def stale(pending, target_pos, draft_pos, *rest):
        emission = sound(pending, target_pos, draft_pos, *rest)[3]
        return pending.clone(), target_pos.clone(), draft_pos.clone(), emission

    monkeypatch.setattr(compiled, "commit_step", stale)
    assert not run()["correct"]


def test_half_the_batch_left_out_is_caught(monkeypatch):
    from repro_torch.serving import compiled

    sound = compiled.verify_drafts

    def half(tokens, probs, logits, *rest, **kw):
        B = logits.shape[0]
        keep = B - B // 2
        idx = torch.arange(B, device=logits.device) % keep
        return sound(tokens, probs, logits[idx], *rest, **kw)

    monkeypatch.setattr(compiled, "verify_drafts", half)
    assert not run()["correct"]


def test_token_altered_where_produced_is_caught(monkeypatch):
    from repro_torch.core.verification import VerifyResult
    from repro_torch.serving import compiled

    sound = compiled.verify_drafts

    def altered(*args, **kw):
        res = sound(*args, **kw)
        V = args[2].shape[-1]
        out = res.output_tokens.clone()
        n = res.accept_counts.long()[:, None]
        out.scatter_(1, n, (out.gather(1, n) + 1) % V)
        return VerifyResult(res.accept_counts, out, res.output_len,
                            res.accept_mask)

    monkeypatch.setattr(compiled, "verify_drafts", altered)
    assert not run()["correct"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    out = run(rounds=12, trace=trace)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "check"
    names = set(out["metrics"])
    if trace:
        assert {"cell.plan_ms", "backend.host_syncs",
                "engine.verify_ms"} <= names
        assert out["device"]["window_s"] > 0
    else:
        assert {"goodput_tok_s", "round_p95_ms", "setup_s"} <= names
