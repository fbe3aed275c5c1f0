"""The port's SSE gateway (``repro_torch.serving.gateway``, a verbatim copy
of the JAX package's) in front of the port's paged ``SpecEngine`` on the
CPU, and the port's launcher (``repro_torch.launch.gateway``).

Live clients must see exactly what a batch ``run()`` of an identical cell
commits, a dropped client must hand its pages back, ``/metrics`` must carry
the engine's families, and ``--smoke`` must serve a loadgen burst with no
error and without loading jax.  Async tests run through ``asyncio.run``.
"""

import asyncio
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import (
    CellConfig,
    EngineBackend,
    GatewayClient,
    GatewayConfig,
    MultiSpinCell,
    MultiSpinGateway,
    Request,
    SpecEngine,
)
from repro_torch.configs import get_config

ROOT = Path(__file__).resolve().parents[1]
REQ_FIELDS = [dict(prompt_len=8, max_new_tokens=12, alpha=a, T_S=0.009)
              for a in (0.71, 0.74, 0.86, 0.8, 0.71, 0.74, 0.86, 0.8)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _engine_cell(B, max_len=128, **cfg_kw):
    """A smoke-size paged engine behind ``EngineBackend``, as the port's
    launcher builds it (seeded weights and start prompts)."""
    tcfg = get_config("qwen2.5-3b").smoke()
    dcfg = tcfg.replace(num_layers=1, d_model=32, num_heads=2, num_kv_heads=1,
                        head_dim=16, d_ff=64, name="draft-smoke")
    eng = SpecEngine(tcfg, dcfg, max_len=max_len, cache_kind="paged",
                     num_pages=B * 2 * (max_len // 16), device="cpu")
    eng.init_params(0)
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, tcfg.vocab_size, (B, 8), generator=gen,
                            dtype=torch.int32)
    backend = EngineBackend(eng, eng.start(prompts), keep_finished_tokens=True)
    cfg = CellConfig(scheme=cfg_kw.pop("scheme", "hete"), max_batch=B, seed=0,
                     t_ver_fix=0.035, t_ver_lin=0.0177, L_max=4, **cfg_kw)
    return MultiSpinCell(cfg, backend=backend, rng=np.random.default_rng(0))


async def _start(cell, **gw_kw):
    gw = MultiSpinGateway(cell, GatewayConfig(port=0, idle_wait_s=0.02,
                                              **gw_kw))
    await gw.start()
    return gw, GatewayClient(port=gw.port)


def test_concurrent_sse_clients_match_batch_run_on_the_engine():
    """8 concurrent SSE clients against a live gateway over the port's
    engine get EXACTLY the rounds of ``cell.run()`` on an identically built
    cell, and each client's streamed token ids are the batch engine's
    committed tokens of its stream, up to its cap."""

    async def live():
        gw, cli = await _start(_engine_cell(8), step_barrier=len(REQ_FIELDS))
        streams = []
        for f in REQ_FIELDS:
            gen = cli.stream_generate(**f)
            ev = await gen.__anext__()
            assert ev.event == "queued"
            streams.append((ev.data["rid"], gen))
        assert [rid for rid, _ in streams] == list(range(len(REQ_FIELDS)))

        async def collect(rid, gen):
            toks, done = [], False
            async for ev in gen:
                if ev.event == "round":
                    toks.extend(ev.data["tokens"])
                elif ev.event == "done":
                    done = True
            await gen.aclose()
            return rid, toks, done
        results = await asyncio.gather(
            *(collect(rid, gen) for rid, gen in streams))
        history = list(gw.cell.history)
        await gw.stop()
        return results, history

    results, live_history = asyncio.run(live())
    assert all(done for _, _, done in results)

    batch = _engine_cell(8)
    reqs = [Request(rid=i, **f) for i, f in enumerate(REQ_FIELDS)]
    for r in reqs:
        batch.submit(r)
    batch.run()
    assert len(live_history) == len(batch.history) > 1
    for a, b in zip(live_history, batch.history):
        np.testing.assert_array_equal(a.lengths, b.lengths)
        np.testing.assert_array_equal(a.accepted, b.accepted)
        np.testing.assert_array_equal(a.rids, b.rids)
        assert a.t_round == b.t_round
    for rid, toks, _ in results:
        cap = reqs[rid].max_new_tokens
        assert len(toks) == cap
        assert toks == batch.backend.stream_tokens(rid)[:cap]
    vocab = get_config("qwen2.5-3b").smoke().vocab_size
    assert all(0 <= t < vocab for _, toks, _ in results for t in toks)


def test_disconnect_returns_pages_on_the_engine():
    cell = _engine_cell(2, scheme="fixed", L_fixed=3)
    backend, eng = cell.backend, cell.backend.engine

    async def run():
        gw, cli = await _start(cell, step_barrier=2)
        a = asyncio.create_task(cli.generate(
            prompt_len=8, max_new_tokens=8, alpha=0.9, T_S=0.009))
        b = asyncio.create_task(cli.generate(
            prompt_len=8, max_new_tokens=10 ** 6, alpha=0.9, T_S=0.009,
            disconnect_after_rounds=1))
        res_a, res_b = await asyncio.gather(a, b)
        for _ in range(200):
            if not any(r.rid == res_b.rid for r in gw.cell.scheduler.active):
                break
            await asyncio.sleep(0.02)
        active = [r.rid for r in gw.cell.scheduler.active]
        await gw.stop()
        return res_a, res_b, active

    res_a, res_b, active = asyncio.run(run())
    assert res_a.done and len(res_a.tokens) == 8
    vocab = get_config("qwen2.5-3b").smoke().vocab_size
    assert all(isinstance(t, int) and 0 <= t < vocab for t in res_a.tokens)
    assert res_b.n_rounds == 1 and not res_b.done
    assert res_b.rid not in active and res_b.rid not in backend._row_of
    # B's row was retired: its pages are back, the allocator is clean
    row_b = 1 if res_a.rid == 0 else 0
    assert row_b in eng._retired
    assert (eng.t_pages.page_table([row_b]) == -1).all()
    assert (eng.d_pages.page_table([row_b]) == -1).all()
    eng.t_pages.check_invariants()
    eng.d_pages.check_invariants()


def test_metrics_scrape_reports_the_engine_families():
    async def run():
        gw, cli = await _start(_engine_cell(4))
        rs = await asyncio.gather(
            *(cli.generate(prompt_len=8, max_new_tokens=6, alpha=0.8,
                           T_S=0.009) for _ in range(4)))
        text = await cli.metrics()
        stats = await cli.stats()
        await gw.stop()
        return rs, text, stats

    rs, text, stats = asyncio.run(run())
    assert all(r.done for r in rs)
    line_re = re.compile(r"^(#.*|[a-z_]+(\{[^}]*\})? [0-9.eE+-]+)$")
    for line in text.strip().splitlines():
        assert line_re.match(line), f"unparseable metrics line: {line!r}"

    def value(name):
        m = re.search(rf"^{name} ([0-9.eE+-]+)$", text, re.M)
        assert m, f"metric {name} missing"
        return float(m.group(1))

    assert value("multispin_rounds_total") >= 1
    assert value("multispin_tokens_committed_total") >= 4 * 6
    assert value("multispin_pool_free_pages") > 0      # a real page pool
    assert value("multispin_ttft_seconds_count") == 4
    for fam in ("multispin_acceptance_rate", "multispin_queue_depth",
                "multispin_draft_width", "multispin_round_seconds_count",
                "multispin_goodput_committed_tokens_per_s"):
        value(fam)
    assert re.search(r'^multispin_round_phase_seconds\{phase="verify"\} ',
                     text, re.M)
    assert stats["scheduler"]["completed"] == 4


def test_launcher_smoke_serves_on_cpu_without_jax():
    """``python -m repro_torch.launch.gateway --smoke --backend engine
    --smoke-arch --device cpu``: a loadgen burst with no error, and jax
    never loaded."""
    code = ("import runpy, sys\n"
            "sys.argv = ['gateway', '--smoke', '--backend', 'engine',\n"
            "            '--smoke-arch', '--device', 'cpu']\n"
            "runpy.run_module('repro_torch.launch.gateway', run_name='__main__',\n"
            "                 alter_sys=True)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    report = json.loads(out.stdout[out.stdout.index("{"):])
    assert report["n_error"] == 0 and report["n_ok"] == 8
    assert report["tokens"] > 0 and report["rounds_total"] >= 1
