"""The traffic generator: the same requests for the same seed, the same
set of sizes in every block for every seed, the greedy share exact."""

import json
from collections import Counter
from pathlib import Path

import pytest

import smoke  # noqa: F401  (puts the repository on the path)
from perfbench.lib.traffic import Traffic

MIXES = sorted((Path(smoke.ROOT) / "perfbench" / "traffic").glob("*.json"))


def _take(mix, seed, n):
    t = Traffic(mix, seed, token_limit=151643, max_len=mix["max_len"])
    specs = t.initial()
    d = 0
    while len(specs) < n:
        s = t.next(d % t.K)
        d += 1
        if s is None:
            break
        specs.append(s)
    return t, specs


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_same_seed_same_requests(path):
    mix = json.loads(path.read_text())
    t1, a = _take(mix, 2 ** 40 + 3, 64)
    t2, b = _take(mix, 2 ** 40 + 3, 64)
    assert [(s.prompt_len, s.max_new_tokens, s.greedy, s.device) for s in a] \
        == [(s.prompt_len, s.max_new_tokens, s.greedy, s.device) for s in b]
    assert t1.prompt(a[5]) == t2.prompt(b[5])
    assert list(t1.alpha) == list(t2.alpha) and list(t1.T_S) == list(t2.T_S)
    t3, c = _take(mix, 2 ** 40 + 4, 64)
    # a mix with a trace seed sends one trace of sizes for every run seed;
    # the run seed draws the contents
    sizes = lambda specs: [(s.prompt_len, s.max_new_tokens, s.greedy)  # noqa: E731
                           for s in specs]
    assert ("trace_seed" in mix) == (sizes(a) == sizes(c))
    assert t1.prompt(a[5]) != t3.prompt(c[5])
    free = dict(mix)
    free.pop("trace_seed", None)
    _, d = _take(free, 2 ** 40 + 3, 64)
    _, e = _take(free, 2 ** 40 + 4, 64)
    assert sizes(d) != sizes(e)


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_every_block_holds_the_same_sizes(path):
    mix = json.loads(path.read_text())
    S = mix["devices"] if mix["requests_per_device"] else mix["block"]
    blocks = []
    for seed in (1, 99, 2 ** 33):
        _, specs = _take(mix, seed, S)
        blocks.append(Counter((s.prompt_len, s.greedy) for s in specs[:S]))
        outs = Counter(s.max_new_tokens for s in specs[:S])
        assert sum(s.greedy for s in specs[:S]) == round(S * mix["greedy_share"])
        if mix["output"]["dist"] != "fill":
            blocks_out = outs
    lens = [Counter(p for p, _ in b.elements()) for b in blocks]
    assert lens[0] == lens[1] == lens[2]
    if mix["output"]["dist"] != "fill":
        assert len(blocks_out) > 1
    for s in specs[:S]:
        assert mix["prompt"]["lo"] <= s.prompt_len <= mix["prompt"]["hi"]
        assert s.prompt_len + s.max_new_tokens + 9 <= mix["max_len"]


def test_long_sessions_give_greedy_sessions_the_shortest_contexts():
    mix = json.loads((Path(smoke.ROOT) / "perfbench" / "traffic"
                      / "longctx.k24.json").read_text())
    _, specs = _take(mix, 7, 100)
    assert len(specs) == mix["devices"]       # one session a device
    greedy = sorted(s.prompt_len for s in specs if s.greedy)
    rest = sorted(s.prompt_len for s in specs if not s.greedy)
    assert greedy and greedy[-1] < rest[0]
