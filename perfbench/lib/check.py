"""How ``correct`` is decided: what the timed path served, judged by the
plain reference once the window has closed.

``gather`` reads, while the program still holds them, the served tokens of
a sample of requests drawn from the seed (the longest greedy request and
the longest sampled one among them), the accepted counts of every round,
and the page pools after every stream has been retired.  The program is
then freed, and ``readings`` runs the reference (each model's
architecture's ``Reference``, ``perfbench/arch/``) over each sampled prompt
with its served tokens:

* ``gap_draft``: the widest gap by which a greedy request's draft token
  lies below the reference draft's best logit (the draft steps: logits,
  top-vhat truncation, the argmax draw);
* ``gap_target``: the same for its bonus tokens under the reference target
  (the verify window with ``paged_attention`` inside, the bonus draw);
* ``resid_miss``: for a sampled request's residual tokens (the first
  rejected position), how far the round's uniform lies outside the
  reference's CDF interval of the served token (``fused_verify_sample``'s
  residual);
* ``count_miss``: greedy rounds whose accepted count is not the planned
  length + 1 (the accept count), and sampled requests whose rounds do not
  add up to their served tokens (the commit);
* ``pages_leaked``: pages not back in either pool once every stream is
  retired (the page accounting).

The control (``fp8=True``) reads the same positions: the token the fp8
reference puts first (or draws, at residual positions), judged by the
float32 reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.reference import accept

from .seeds import derive

NUMBERS = ("gap_draft", "gap_target", "resid_miss", "count_miss",
           "pages_leaked")


@dataclasses.dataclass
class Served:
    rid: int
    greedy: bool
    prompt: list
    tokens: list
    row: int
    segments: list        # (round, L_k, accepted) in round order


def gather(run, budget: dict) -> dict:
    """Everything the check needs from the program, before it is freed."""
    cell, backend, engine = run.cell, run.backend, run.engine
    sessions = run.mix.get("requests_per_device") is not None
    segs: dict[int, list] = {}
    count_miss = 0
    for r, rec in enumerate(cell.history):
        for i, rid in enumerate(rec.rids):
            rid = int(rid)
            tr = run.reqs[rid]
            L_k, acc = int(rec.lengths[i]), int(rec.accepted[i])
            segs.setdefault(rid, []).append((r, L_k, acc))
            if tr.spec.greedy and acc != L_k + 1:
                count_miss += 1
    pool = [tr for tr in run.reqs.values()
            if tr.first_round is not None and (tr.finished or sessions)]
    rng = np.random.default_rng(derive(run.seed, "sample"))
    chosen: list[Served] = []
    for greedy, tokens in ((True, budget["greedy_tokens"]),
                           (False, budget["sampled_tokens"])):
        kind = [tr for tr in pool if tr.spec.greedy == greedy]
        if not kind:
            continue
        kind.sort(key=lambda tr: (-len(backend.stream_tokens(tr.req.rid)),
                                  tr.req.rid))
        order = [kind[0]] + [kind[1:][i] for i in
                             rng.permutation(len(kind) - 1)]
        total = 0
        for tr in order[:budget["max_requests"]]:
            toks = backend.stream_tokens(tr.req.rid)
            chosen.append(Served(rid=tr.req.rid, greedy=greedy,
                                 prompt=list(tr.req.prompt), tokens=toks,
                                 row=tr.row, segments=segs[tr.req.rid]))
            total += len(toks)
            if total >= tokens:
                break
    for s in chosen:
        if sum(a for _, _, a in s.segments) != len(s.tokens):
            count_miss += 1
    # every stream out: each page must be back in both pools
    backend.release([r for r in cell.scheduler.active])
    ps = engine.pool_stats()
    leaked = max(engine.num_pages - ps["free_pages"],
                 0 if ps["used_bytes"] == 0 else 1)
    return {"served": chosen, "draws": list(run.draws.log),
            "count_miss": count_miss, "pages_leaked": int(leaked),
            "vhat": int(run.dep["vhat"])}


def _positions(s: Served):
    """Per sampled request: the positions (in prompt + served) whose
    logits score each judged token, and the token's role."""
    M = len(s.prompt)
    j = 0
    draft_pos, bonus_pos, resid = [], [], []
    for r, L_k, acc in s.segments:
        for k in range(acc):
            p = M + j + k - 1            # the position that predicts it
            if s.greedy:
                (draft_pos if k < L_k else bonus_pos).append((p, M + j + k))
            elif k == acc - 1 and acc - 1 < L_k:
                resid.append((p, M + j + k, r))
        j += acc
    return draft_pos, bonus_pos, resid


def readings(mat: dict, target, draft, raw_t, raw_d, device,
             control: bool = False) -> dict:
    """The program's readings (and the control's, with ``control``);
    ``target`` and ``draft`` are ``Model``s of ``lib/config.py``."""
    served = mat["served"]
    seqs = [s.prompt + s.tokens for s in served]
    plans = [_positions(s) for s in served]
    out = {"count_miss": float(mat["count_miss"]),
           "pages_leaked": float(mat["pages_leaked"])}
    ctl = {}

    def logits(model, raw, want, fp8):
        keep = [i for i, w in enumerate(want) if w]
        ref = model.arch.Reference(model.dims, raw, device, fp8=fp8)
        return dict(zip(keep, ref.logits_at(
            [seqs[i][:-1] for i in keep], [want[i] for i in keep])))

    def run_models(fp8):
        t_want = [sorted({p for p, _ in b} | {p for p, _, _ in r})
                  for _, b, r in plans]
        d_want = [sorted({p for p, _ in d} | {p for p, _, _ in r})
                  for d, _, r in plans]
        return (t_want, d_want, logits(target, raw_t, t_want, fp8),
                logits(draft, raw_d, d_want, fp8))

    ref = run_models(False)
    alt = run_models(True) if control else None
    gd, gt, rm = [], [], []
    cgd, cgt, crm = [], [], []
    t_want, d_want, t_log, d_log = ref
    t_at = [{p: k for k, p in enumerate(w)} for w in t_want]
    d_at = [{p: k for k, p in enumerate(w)} for w in d_want]
    for i, (dpos, bpos, resid) in enumerate(plans):
        seq = seqs[i]
        for poss, at, log, sink, csink in (
                (dpos, d_at, d_log, gd, cgd),
                (bpos, t_at, t_log, gt, cgt)):
            if not poss:
                continue
            rows = torch.as_tensor([at[i][p] for p, _ in poss])
            lg = log[i][rows.to(log[i].device)]
            toks = torch.as_tensor([seq[q] for _, q in poss],
                                   device=lg.device)
            sink.append(float(accept.gap(lg, toks).max()))
            if alt is not None:
                alog = (alt[3] if log is d_log else alt[2])[i]
                atok = alog[rows.to(alog.device)].argmax(dim=-1)
                csink.append(float(accept.gap(lg, atok).max()))
        if resid:
            tr = torch.as_tensor([t_at[i][p] for p, _, _ in resid])
            dr = torch.as_tensor([d_at[i][p] for p, _, _ in resid])
            plg = t_log[i][tr.to(t_log[i].device)]
            qlg = d_log[i][dr.to(d_log[i].device)]
            u = torch.stack([_u(mat, r, served[i].row, device)
                             for _, _, r in resid])
            toks = torch.as_tensor([seq[q] for _, q, _ in resid],
                                   device=plg.device)
            rm.append(float(accept.residual_miss(plg, qlg, mat["vhat"], u,
                                                 toks).max()))
            if alt is not None:
                ap = alt[2][i][tr.to(plg.device)]
                aq = alt[3][i][dr.to(plg.device)]
                atok = accept.residual_token(ap, aq, mat["vhat"], u)
                crm.append(float(accept.residual_miss(plg, qlg, mat["vhat"],
                                                      u, atok).max()))
    out["gap_draft"] = max(gd, default=0.0)
    out["gap_target"] = max(gt, default=0.0)
    out["resid_miss"] = max(rm, default=0.0)
    out["tokens_judged"] = {
        "draft": sum(len(p[0]) for p in plans),
        "bonus": sum(len(p[1]) for p in plans),
        "residual": sum(len(p[2]) for p in plans),
        "requests": len(served)}
    if control:
        ctl = {"gap_draft": max(cgd, default=0.0),
               "gap_target": max(cgt, default=0.0),
               "resid_miss": max(crm, default=0.0)}
        out["control"] = ctl
    return out


def _u(mat: dict, r: int, row: int, device) -> torch.Tensor:
    from .serve import Draws

    seed, B, _ = mat["draws"][r]
    return Draws.u_resid(seed, B, device)[row]


def judge(read: dict, limits: dict | None) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: every number at or under
    its limit; no limits file means not correct."""
    table = {}
    ok = limits is not None
    for name in NUMBERS:
        lim = None if limits is None else limits.get(name)
        table[name] = {"value": read[name], "limit": lim}
        if lim is None or not read[name] <= lim:
            ok = False
    return ok, table
