"""Compiled round path: the draft, verify and commit steps of a J=1 round,
built once per shape and replayed after that.

The port of ``repro.serving.compiled``.  The engine's three row-subset
round steps (``draft_rows`` / ``verify_rows`` / ``commit_rows``) bottom out
in the step functions built here.  Each takes the model params, the KV
cache, the page table, the stream-state tensors and the round's draws as
ARGUMENTS — nothing round-varying is captured from a closure:

  * ``draft``  — ``generate_drafts`` on the draft model
  * ``verify`` — the target's window pass AND ``verify_drafts``, one step
  * ``commit`` — ``commit_step``: pending / target_pos / draft_pos and the
    packed emission

What the reference's modes become here:

  * ``eager`` — the step functions themselves, run op by op; nothing is
    built and nothing recorded.
  * ``jit`` — on a CUDA device each (step, n, L) bucket is captured once as
    a ``torch.cuda.CUDAGraph`` and replayed after that (the counterpart of
    one XLA executable per bucket).  The round's values are copied into the
    graph's static input buffers before each replay (page table, pending,
    positions, ``draft_len``, rows, skip mask and every draw tensor of
    ``core.draws.RoundDraws``); they are never captured as constants.  The
    tensors handed back are copies out of the graph's output buffers, so a
    caller's tensors stay valid across later replays (a continuous engine
    holds several draft tickets of one bucket at once).
  * ``jit+donate`` — as ``jit``, and the commit updates the engine's state
    tensors in place: they ARE the graph's static buffers (one set per
    state shape).  As in the reference, the caller adopts the returned
    state and never reads an old reference again.

The KV pools and contiguous caches are written in place in every mode (the
port's model code always does), so a graph replays on the cache addresses
it was captured on; a step called with other params or cache tensors than
its graph's is captured anew.  The graphs of one ``RoundSteps`` share one
memory pool and one side stream: they run one after another, each on the
stream of its caller.  Before a capture the step runs once eagerly on that
side stream so that lazy initialisation (kernel libraries, split scratch,
cuBLAS) happens outside the capture: on a throwaway cache where the caller
gives one (``warm_kv``), else on the real one, whose window writes the
first replay then makes again with the same values (a donated commit runs
on copies of its buffers).  The split scratch a graph was captured with is
kept alive with it.  A step on a CUDA device is captured and replayed, or the
call raises: nothing falls back to the eager path.

On the CPU no graph is made: the same step functions run as they are, and
``record`` still fires once per new shape, so tests hold the contract.
``record((step, n, L))`` fires once per build of a shape, never per call
(the reference's fires at trace time).

``setup_compilation_cache`` is the counterpart of the reference's
persistent XLA cache: it points the kernel build directory at a directory
that outlives the process, so a restart loads the built kernels instead of
running nvcc.  CUDA graphs themselves cannot persist across processes:
each process captures its own.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Callable

import torch

from repro_torch.core.drafting import generate_drafts
from repro_torch.core.verification import verify_drafts
from repro_torch.kernels import build
from repro_torch.kernels import paged_attention as _pa
from repro_torch.obs import trace

COMPILE_MODES = ("eager", "jit", "jit+donate")
STEPS = ("draft", "verify", "commit")


def setup_compilation_cache(cache_dir: str | None = None) -> str | None:
    """Point the kernel build directory (``kernels.build.BUILD_DIR``, its
    libraries named by a hash of their sources and flags) at ``cache_dir``,
    or at ``REPRO_COMPILE_CACHE`` when that is None.  Makes the directory
    and returns its absolute path, or returns None (nothing changed) when
    neither is set.  A restart with the same directory loads the kernels
    built there instead of running nvcc; CUDA graphs are not persisted
    (a graph lives in its process)."""
    cache_dir = cache_dir or os.environ.get("REPRO_COMPILE_CACHE")
    if not cache_dir:
        return None
    cache_dir = os.path.abspath(os.path.expanduser(str(cache_dir)))
    os.makedirs(cache_dir, exist_ok=True)
    build.BUILD_DIR = Path(cache_dir)
    return cache_dir


def commit_step(pending: torch.Tensor, target_pos: torch.Tensor,
                draft_pos: torch.Tensor, rows: torch.Tensor,
                skip: torch.Tensor, output_tokens: torch.Tensor,
                accept_counts: torch.Tensor):
    """Row-subset commit, entirely on device.

    rows: (n,) int32 state-row index per ticket slot, ``-1`` = padding.
    skip: (n,) bool — padding / frozen / retired slots commit nothing.
    output_tokens: (n, L+1); accept_counts: (n,).

    Padding maps to row 0 with a zero delta (integer adds of zero are exact,
    so duplicated padding rows are harmless).  Returns new state tensors
    plus a packed ``(n, L+2)`` int32 emission — ``[advance, output_tokens...]``
    per slot — the ONE device->host fetch of a round.
    """
    safe = torch.where(rows < 0, torch.zeros_like(rows), rows).long()
    k = accept_counts.to(torch.int64)
    zero = torch.zeros((), dtype=torch.int32, device=rows.device)
    adv = torch.where(skip, zero, (k + 1).to(torch.int32))
    new_tok = output_tokens.gather(1, k[:, None])[:, 0]
    old = pending.index_select(0, safe)
    delta = torch.where(skip, torch.zeros_like(old),
                        new_tok.to(pending.dtype) - old)
    pending = pending.index_add(0, safe, delta)
    target_pos = target_pos.index_add(0, safe, adv.to(target_pos.dtype))
    draft_pos = draft_pos.index_add(0, safe, adv.to(draft_pos.dtype))
    emission = torch.cat([adv[:, None], output_tokens.to(torch.int32)], dim=1)
    return pending, target_pos, draft_pos, emission


def _commit_in_place(pending, target_pos, draft_pos, rows, skip,
                     output_tokens, accept_counts):
    """``commit_step`` writing the new state into its input tensors (the
    donated state buffers of ``jit+donate``)."""
    new = commit_step(pending, target_pos, draft_pos, rows, skip,
                      output_tokens, accept_counts)
    for buf, value in zip((pending, target_pos, draft_pos), new):
        buf.copy_(value)
    return pending, target_pos, draft_pos, new[3]


def _refs(fixed) -> tuple:
    """What a graph captured of its fixed arguments: a dict of tensors (a
    cache) by its tensors, anything else (a params tree, a tensor) by
    itself."""
    out = []
    for f in fixed:
        if isinstance(f, dict) and all(isinstance(v, torch.Tensor)
                                       for v in f.values()):
            out.extend(f.values())
        else:
            out.append(f)
    return tuple(out)


@dataclasses.dataclass
class _Build:
    refs: tuple                       # the fixed arguments it was built on
    graph: torch.cuda.CUDAGraph | None = None
    inputs: tuple = ()                # static input buffers (None kept)
    outputs: tuple = ()               # static output buffers
    keep: tuple = ()                  # split scratch the graph launches on


class StepGraphs:
    """The builds of one engine's round steps: per step and input signature
    a captured graph (CUDA) or a record (CPU), with their counters, the
    shared graph memory pool and side stream.

    ``captures[step]`` counts graphs captured, ``replays[step]`` graph
    launches: the kernels' launch counters (``kernels.ops``) tick in
    Python, once at the eager warm-up and once at capture, and never at a
    replay.

    With a tracer installed each call is a span ``compiled.<step>`` (args
    ``n``, ``L``) over the input copies, the replay and the output clones,
    and each build a span ``compiled.capture``.  On a CUDA device a pair of
    timing events brackets each traced replay on the current stream;
    ``settle()`` sets ``device_ms`` on the spans whose replays have
    finished, and, for an MoE target (``moe_counts`` gives its per-layer
    counts buffer), ``moe_rows`` / ``moe_hit`` on the last such verify."""

    def __init__(self, record: Callable[[tuple], None] | None,
                 moe_counts: Callable[[], torch.Tensor | None] | None = None):
        self.record = record
        self.moe_counts = moe_counts
        self.captures = dict.fromkeys(STEPS, 0)
        self.replays = dict.fromkeys(STEPS, 0)
        self.pool = None
        self._stream = None
        self._builds: dict = {}
        self._state: dict = {}
        self._timed: list = []        # (span, start event, end event)

    def state_buffers(self, *state: torch.Tensor) -> tuple:
        """The donated state buffers of this shape, holding ``state``'s
        values (copied in unless ``state`` already is them)."""
        key = tuple((tuple(t.shape), t.dtype, t.device) for t in state)
        bufs = self._state.get(key)
        if bufs is None:
            bufs = tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                         for t in state)
            self._state[key] = bufs
        for buf, t in zip(bufs, state):
            if t is not buf:
                buf.copy_(t)
        return bufs

    def call(self, step: str, fn, fixed: tuple, args: tuple,
             shape: tuple[int, int], static: dict | None = None,
             warm: Callable[[], tuple] | None = None, run: bool = True):
        """``fn(*fixed, *args, **static)`` through its build for this input
        signature, building it first when there is none (or when ``fixed``
        holds other tensors than the build's).  ``fixed`` are read and
        written at their addresses; ``args`` (tensors or None) are copied
        into the static inputs.  ``warm()`` gives the fixed arguments of
        the eager run before a capture (default: ``fixed``).  ``run=False``
        only builds.  Returns ``fn``'s tuple of outputs: fresh copies, and
        the fixed tensors themselves where ``fn`` returns them."""
        static = static or {}
        sig = (step, tuple(None if a is None else
                           (tuple(a.shape), a.dtype, a.device) for a in args),
               tuple(sorted(static.items())))
        refs = _refs(fixed)
        tracer = trace.active()
        b = self._builds.get(sig)
        if b is None or any(x is not y for x, y in zip(b.refs, refs)):
            with (trace.NULL_SPAN if tracer is None else tracer.span(
                    "compiled.capture", cat="compiled",
                    args={"step": step, "n": shape[0], "L": shape[1]})):
                b = self._build(step, fn, fixed, refs, args, static, warm)
            self._builds[sig] = b
            if self.record is not None:
                self.record((step,) + tuple(shape))
        if not run:
            return None
        if tracer is None:
            return self._run(b, step, fn, fixed, refs, args, static, None)
        with tracer.span("compiled." + step, cat="compiled",
                         args={"n": shape[0], "L": shape[1]}) as sp:
            return self._run(b, step, fn, fixed, refs, args, static, sp)

    def _run(self, b: _Build, step, fn, fixed, refs, args, static, sp):
        """One call through build ``b``: the step function itself without a
        graph, else the input copies, the replay and the output clones.  A
        traced replay (``sp``) on a CUDA device is bracketed by timing
        events."""
        if b.graph is None:
            return fn(*fixed, *args, **static)
        for buf, a in zip(b.inputs, args):
            if a is not None:
                buf.copy_(a)
        if sp is None:
            b.graph.replay()
        else:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            b.graph.replay()
            end.record()
            self._timed.append((sp, start, end))
        self.replays[step] += 1
        return tuple(o if any(o is r for r in refs) else o.clone()
                     for o in b.outputs)

    def settle(self) -> None:
        """Set ``device_ms`` on every traced replay's span whose end event
        has run; the others (a continuous engine's tickets in flight) wait
        for a later call.  ``query()`` never waits on the device."""
        if not self._timed:
            return
        waiting, verify = [], None
        for sp, start, end in self._timed:
            if end.query():
                sp.set(device_ms=start.elapsed_time(end))
                if sp.name == "compiled.verify":
                    verify = sp
            else:
                waiting.append((sp, start, end))
        self._timed = waiting
        counts = None if self.moe_counts is None else self.moe_counts()
        if verify is not None and counts is not None:
            # the last finished verify's counts (a traced read: the
            # commit's fetch drained the stream already)
            c = counts.cpu()
            verify.set(moe_rows=int(c.sum()), moe_hit=int((c > 0).sum()))

    def _build(self, step, fn, fixed, refs, args, static, warm) -> _Build:
        devices = {a.device for a in args if a is not None}
        if len(devices) != 1:
            raise ValueError(f"{step} step: tensors on {devices}")
        (device,) = devices
        if device.type == "cpu":
            return _Build(refs=refs)
        if device.type != "cuda":
            raise ValueError(f"{step} step: no graph for device {device}")
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(device)
        inputs = tuple(None if a is None else
                       torch.empty(a.shape, dtype=a.dtype,
                                   device=device).copy_(a) for a in args)
        s = self._stream
        s.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(s):
            fn(*(fixed if warm is None else warm()), *inputs, **static)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=self.pool, stream=s):
            outputs = fn(*fixed, *inputs, **static)
        torch.cuda.current_stream(device).wait_stream(s)
        self.captures[step] += 1
        return _Build(refs=refs, graph=g, inputs=inputs, outputs=outputs,
                      keep=_pa.scratch_buffers())


@dataclasses.dataclass
class RoundSteps:
    """The three step callables for one engine, one body each in every
    mode.  ``graphs`` holds the builds and their counters (None in eager
    mode, whose callables are the bare step functions)."""

    mode: str
    draft: Callable
    verify: Callable
    commit: Callable
    graphs: StepGraphs | None = None


def build_round_steps(target_model, draft_model, *, mode: str,
                      record: Callable[[tuple], None] | None = None,
                      ) -> RoundSteps:
    """Build the round-step callables for a (target, draft) model pair.

    ``record`` is called with a ``(step, n, L)`` shape key once per build
    of a step (a capture on a CUDA device, the first call of a shape on
    the CPU), never per call.

      * ``draft(params, kv, pages, pending, dpos, gumbel, *, L, vhat)`` ->
        ``(tokens, probs, q_idx, q_val)``
      * ``verify(params, kv, pages, win_pages, pending, tokens, probs,
        q_idx, q_val, tpos, draft_len, u_accept, u_resid, bonus_gumbel)`` ->
        the fields of a ``VerifyResult``; an MoE target counts each layer's
        routed rows of the rows' own tokens (``draft_len`` + 1 a row) into
        its ``moe_counts``
      * ``commit(pending, target_pos, draft_pos, rows, skip, output_tokens,
        accept_counts)`` -> ``(pending, target_pos, draft_pos, emission)``

    ``pages`` is the (n, n_slots) page table of a paged cache, None for a
    contiguous one, and ``win_pages`` a windowed target's window-layer
    table (None without window layers); ``kv`` is written in place.  In a
    compiled mode each also takes ``run=False`` (build only: draft and
    verify then return None, commit the state it would commit with an
    emission of None) and draft / verify a ``warm_kv`` for the eager run
    before a capture.
    """
    if mode not in COMPILE_MODES:
        raise ValueError(f"compile_mode must be one of {COMPILE_MODES}, "
                         f"got {mode!r}")

    def draft_step(params, kv, pages, pending, dpos, gumbel, *, L, vhat):
        cache = kv if pages is None else dict(kv, pages=pages)
        res = generate_drafts(draft_model, params, cache, pending, dpos, L,
                              gumbel, vhat=vhat)
        return res.tokens, res.probs, res.q_idx, res.q_val

    moe = getattr(target_model, "moe_cfg", None) is not None

    def verify_step(params, kv, pages, win_pages, pending, tokens, probs,
                    q_idx, q_val, tpos, draft_len, u_accept, u_resid,
                    bonus_gumbel):
        cache = kv if pages is None else dict(kv, pages=pages)
        if win_pages is not None:
            cache = dict(cache, win_pages=win_pages)
        window = torch.cat([pending[:, None].to(tokens.dtype), tokens], dim=1)
        count = None
        if moe:
            count = (torch.arange(window.shape[1], device=window.device)[None]
                     <= draft_len[:, None])
        logits, _ = target_model.forward_window(params, window, cache, tpos,
                                                count_tokens=count)
        res = verify_drafts(tokens, probs, logits, q_idx, q_val, u_accept,
                            u_resid, bonus_gumbel, draft_len=draft_len)
        return (res.accept_counts, res.output_tokens, res.output_len,
                res.accept_mask)

    if mode == "eager":
        return RoundSteps(mode=mode, draft=draft_step, verify=verify_step,
                          commit=commit_step)
    graphs = StepGraphs(record, (lambda: target_model.moe_counts)
                        if moe else None)
    donate = mode == "jit+donate"

    def draft(params, kv, pages, pending, dpos, gumbel, *, L, vhat,
              warm_kv=None, run=True):
        return graphs.call(
            "draft", draft_step, (params, kv), (pages, pending, dpos, gumbel),
            (pending.shape[0], L), static={"L": L, "vhat": vhat},
            warm=None if warm_kv is None else (lambda: (params, warm_kv)),
            run=run)

    def verify(params, kv, pages, win_pages, pending, tokens, probs, q_idx,
               q_val, tpos, draft_len, u_accept, u_resid, bonus_gumbel, *,
               warm_kv=None, run=True):
        return graphs.call(
            "verify", verify_step, (params, kv),
            (pages, win_pages, pending, tokens, probs, q_idx, q_val, tpos,
             draft_len, u_accept, u_resid, bonus_gumbel), tuple(tokens.shape),
            warm=None if warm_kv is None else (lambda: (params, warm_kv)),
            run=run)

    def commit(pending, target_pos, draft_pos, rows, skip, output_tokens,
               accept_counts, *, run=True):
        shape = (rows.shape[0], output_tokens.shape[1] - 1)
        if not donate:
            out = graphs.call(
                "commit", commit_step, (),
                (pending, target_pos, draft_pos, rows, skip, output_tokens,
                 accept_counts), shape, run=run)
            return out if run else (pending, target_pos, draft_pos, None)
        bufs = graphs.state_buffers(pending, target_pos, draft_pos)
        # the eager run before a capture commits into copies: the donated
        # buffers take this call's commit once, from the replay
        out = graphs.call(
            "commit", _commit_in_place, bufs,
            (rows, skip, output_tokens, accept_counts), shape,
            warm=lambda: tuple(b.clone() for b in bufs), run=run)
        return out if run else bufs + (None,)

    return RoundSteps(mode=mode, draft=draft, verify=verify, commit=commit,
                      graphs=graphs)
