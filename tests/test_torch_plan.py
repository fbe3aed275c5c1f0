"""The port's ``hete`` planner against the reference's, on the CPU.

``repro_torch.core.draft_control.solve_heterogeneous`` runs Algorithm 1's
inner steps through ``core/hete_solve.py``: W0 stopped per element at
convergence, Lemma 3 solved once per distinct length vector by Newton, the
reference's halvings replayed for the chosen vector.  Every seeded draw below
(2,052 across the cases) holds it to ``repro.core.draft_control``'s
``solve_heterogeneous``: the same lengths and grid point, bit-equal
bandwidth and equalized latency, goodput within 1e-12 relative.  Unit tests
hold each part to the reference routine it replaces, and one timing guard
holds the speed-up.
"""

import functools
import time
import warnings

import numpy as np
import pytest

from repro.core import draft_control as ref
from repro_torch.core import draft_control as dc
from repro_torch.core import hete_solve as hs
from repro_torch.core.bandwidth import solve_equalized_phi
from repro_torch.core.channel import ChannelConfig, ChannelState
from repro_torch.core.goodput import goodput_from_equalized_latency
from repro_torch.core.lambertw import lambert_w0

CH = ChannelConfig()
Q_TOK, BW = CH.q_tok_bits, CH.total_bandwidth_hz


def _rates(rng, K):
    ch = ChannelState.sample(CH, K, rng)
    for _ in range(int(rng.integers(0, 4))):
        ch = ch.refade(rng)
    return ch.rates


def _cell(rng, K):
    """The benchmark cells' devices: alpha from {0.71, 0.74, 0.86}, T_S =
    9 ms x U(0.85, 1.15), the default channel after Rayleigh refades."""
    return (rng.choice([0.71, 0.74, 0.86], K),
            0.009 * rng.uniform(0.85, 1.15, K), _rates(rng, K))


def _wide(rng, K):
    """Any acceptance rate in [0.01, 0.995] and T_S from 2 to 50 ms."""
    return (rng.uniform(0.01, 0.995, K), rng.uniform(0.002, 0.05, K),
            _rates(rng, K))


def _edges(rng, K):
    """Acceptance rates at the ends of the range."""
    alphas, T_S, r = _wide(rng, K)
    return (rng.choice([0.01, 0.02, 0.98, 0.995], K), T_S, r)


def _extreme(rng, K):
    """Rates from 1e-300 to 1e300, and one device at 0, at a subnormal, or
    at inf: the grid reaches inf and Proposition 1 gives NaN lengths."""
    alphas, T_S, r = _wide(rng, K)
    r = r * 10.0 ** rng.uniform(-300, 300, K)
    r[rng.integers(K)] = rng.choice([0.0, 1e-310, np.inf])
    return alphas, T_S, r


# (name, profile, K values, L_max values, (n_phi, n_lam) or None for the
#  cells' 40 x 40, seeded draws per (K, L_max))
CASES = [
    ("cell", _cell, [24], [8], None, 40),
    ("K", _wide, list(range(1, 33)), [8], (12, 12), 25),
    ("L_max", _wide, [3, 11, 24], [1, 8, 25], (10, 14), 84),
    ("alphas", _edges, [2, 9, 32], [8, 25], (12, 10), 34),
    ("rates", _extreme, [1, 5, 17], [8, 25], (8, 12), 42),
]
N_DRAWS = sum(len(k) * len(l) * n for _, _, k, l, _, n in CASES)


def _t_ver(K):
    return 0.035 + K * 0.0177


def _grid(rng, size):
    if size is None:
        return 40, 40
    return (int(rng.integers(size[0] // 2, size[0] + 1)),
            int(rng.integers(size[1] // 2, size[1] + 1)))


def _bits(x):
    return np.asarray(x, dtype=np.float64).tobytes()


def _assert_same(port, want):
    np.testing.assert_array_equal(port.lengths, want.lengths)
    assert port.lengths.dtype == want.lengths.dtype
    assert _bits(port.meta["grid_best"]) == _bits(want.meta["grid_best"])
    assert _bits(port.meta["phi_grid"]) == _bits(want.meta["phi_grid"])
    assert _bits(port.meta["lam_grid"]) == _bits(want.meta["lam_grid"])
    assert _bits(port.bandwidth) == _bits(want.bandwidth)
    assert _bits(port.equalized_latency) == _bits(want.equalized_latency)
    if np.isfinite(want.goodput):
        assert port.goodput == pytest.approx(want.goodput, rel=1e-12, abs=0)
    else:
        assert port.goodput == want.goodput
    assert port.meta["scheme"] == want.meta["scheme"]


def test_the_cases_hold_two_thousand_draws():
    assert N_DRAWS >= 2000, N_DRAWS


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plan_matches_the_reference(case):
    name, profile, Ks, L_maxes, size, n = case
    nan_lengths = 0
    for K in Ks:
        for L_max in L_maxes:
            for s in range(n):
                rng = np.random.default_rng([2_147_483_659, K, L_max, s])
                alphas, T_S, r = profile(rng, K)
                n_phi, n_lam = _grid(rng, size)
                args = (alphas, T_S, r, Q_TOK, BW, _t_ver(K))
                kw = dict(L_max=L_max, n_phi=n_phi, n_lam=n_lam)
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", RuntimeWarning)
                    want = ref.solve_heterogeneous(*args, **kw)
                    port = dc.solve_heterogeneous(*args, **kw)
                    if name == "rates":
                        phis, lams = ref.search_grids(alphas, T_S, r, Q_TOK,
                                                      BW, L_max, n_phi, n_lam)
                        L_t = ref.heterogeneous_lengths(
                            phis[:, None, None], lams[None, :, None],
                            alphas, T_S, r, Q_TOK)
                        nan_lengths += bool(np.isnan(L_t).any())
                _assert_same(port, want)
    if name == "rates":
        assert nan_lengths >= n, nan_lengths


def test_a_tie_goes_to_the_first_grid_point():
    """Two alike devices, and rows that swap their lengths: the goodputs tie
    up to rounding.  ``best_grid_point`` picks what ``np.argmax`` picks over
    the reference's bisection of every row; rows all alike pick index 0."""
    alphas = np.array([0.8, 0.8, 0.7])
    T_S = np.array([0.01, 0.01, 0.012])
    r = np.array([2.0, 2.0, 3.0])
    rows = np.array([[2, 3, 4], [3, 2, 4], [1, 1, 1], [2, 3, 4], [3, 2, 4],
                     [1, 1, 2], [2, 1, 1]], dtype=np.float64)
    for perm in ([0, 1, 2, 3, 4, 5, 6], [1, 0, 2, 4, 3, 6, 5],
                 [5, 6, 1, 0, 2, 3, 4], [2, 2, 2, 2, 2, 2, 2]):
        L_int = rows[perm]
        phi, _ = solve_equalized_phi(L_int, T_S[None, :], r[None, :], Q_TOK,
                                     BW)
        tau = goodput_from_equalized_latency(alphas[None, :], L_int, phi,
                                             0.1)
        want = int(np.argmax(np.where(np.isfinite(tau), tau, -np.inf)))
        best, _, n_rows = hs.best_grid_point(alphas, L_int, T_S, r, Q_TOK,
                                             BW, 0.1, L_max=4)
        assert best == want
        assert n_rows == len({tuple(x) for x in L_int})


def test_zero_rates_tie_every_row_at_zero_goodput():
    """A device with no rate puts every phi at inf: each row's goodput is 0,
    and the reference's argmax takes grid point 0."""
    rng = np.random.default_rng(7)
    alphas, T_S, r = _cell(rng, 6)
    r[2] = 0.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = ref.solve_heterogeneous(alphas, T_S, r, Q_TOK, BW, 0.1, L_max=8)
        port = dc.solve_heterogeneous(alphas, T_S, r, Q_TOK, BW, 0.1, L_max=8)
    assert want.goodput == 0.0
    _assert_same(port, want)


# ---------------------------------------------------------------------------
# the parts
# ---------------------------------------------------------------------------

def test_w0_is_the_reference_lambert_w0_within_four_ulp():
    rng = np.random.default_rng(3)
    y = np.concatenate([np.linspace(-700.0, 700.0, 200_001),
                        rng.uniform(-700.0, 700.0, 50_000),
                        rng.uniform(-8.0, 25.0, 50_000), [np.nan]])
    w, iters = hs.w0_of_exp(y)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = lambert_w0(np.exp(y))
    assert np.isnan(w[-1]) and np.isnan(want[-1])
    ulp = np.abs(w[:-1] - want[:-1]) / np.spacing(want[:-1])
    assert ulp.max() <= 4.0, (ulp.max(), y[np.argmax(ulp)])
    assert iters == 1


def test_w0_of_nan_takes_one_step_and_stays_nan():
    w, iters = hs.w0_of_exp(np.full((3, 2), np.nan))
    assert np.isnan(w).all() and w.shape == (3, 2) and iters == 1


def _distinct(seed, K=24, L_max=8):
    rng = np.random.default_rng(seed)
    alphas, T_S, r = _cell(rng, K)
    phis, lams = dc.search_grids(alphas, T_S, r, Q_TOK, BW, L_max)
    L_t, _ = hs.proposition1_lengths(phis[:, None, None], lams[None, :, None],
                                     alphas, T_S, r, Q_TOK)
    L_int = dc.round_lengths(np.nan_to_num(L_t, nan=1.0), L_max).reshape(-1, K)
    return L_int[hs.distinct_rows(L_int, L_max)], T_S, r


@pytest.mark.parametrize("seed", range(8))
def test_newton_roots_match_the_bisection(seed, monkeypatch):
    U, T_S, r = _distinct(seed)
    want, _ = solve_equalized_phi(U, T_S[None, :], r[None, :], Q_TOK, BW)

    def no_fallback(*a, **k):
        raise AssertionError("a row fell back to the bisection")

    monkeypatch.setattr(hs, "solve_equalized_phi", no_fallback)
    got = hs.lemma3_roots(U, T_S, r, Q_TOK, BW)
    assert len(U) > 100
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)


def test_an_iteration_cap_of_one_falls_back_to_the_bisection(monkeypatch):
    U, T_S, r = _distinct(11)
    want, _ = solve_equalized_phi(U, T_S[None, :], r[None, :], Q_TOK, BW)
    fell = []

    def counted(L, *a, **k):
        fell.append(len(L))
        return solve_equalized_phi(L, *a, **k)

    monkeypatch.setattr(hs, "solve_equalized_phi", counted)
    got = hs.lemma3_roots(U, T_S, r, Q_TOK, BW, max_iter=1)
    assert fell == [len(U)]         # no row of 24 devices converges in one
    assert _bits(got) == _bits(want)

    # the whole plan, every root through the fallback
    monkeypatch.setattr(hs, "lemma3_roots",
                        functools.partial(hs.lemma3_roots, max_iter=1))
    rng = np.random.default_rng(12)
    alphas, T_S, r = _cell(rng, 24)
    args = (alphas, T_S, r, Q_TOK, BW, _t_ver(24))
    _assert_same(dc.solve_heterogeneous(*args, L_max=8),
                 ref.solve_heterogeneous(*args, L_max=8))


@pytest.mark.parametrize("seed", range(4))
def test_replayed_halvings_are_the_reference_bit_for_bit(seed):
    """Every distinct row of a cell's grid, from its Newton root and from
    roots 1e-13 to either side: the reference's phi and bandwidth, bit for
    bit."""
    U, T_S, r = _distinct(100 + seed)
    roots = hs.lemma3_roots(U, T_S, r, Q_TOK, BW)
    for row, root in zip(U, roots):
        want = solve_equalized_phi(row, T_S, r, Q_TOK, BW)
        for rel in (0.0, 1e-13, -1e-13):
            got = hs.equalized_phi(row, T_S, r, Q_TOK, BW, root * (1.0 + rel))
            assert _bits(got[0]) == _bits(want[0])
            assert _bits(got[1]) == _bits(want[1])


def test_distinct_rows_refuse_lengths_past_a_byte():
    with pytest.raises(ValueError, match="L_max=256"):
        hs.distinct_rows(np.ones((4, 3)), L_max=256)


def test_port_takes_at_most_half_the_reference_time():
    """Best of 7 interleaved calls at K = 24 on the 40 x 40 grid; the
    planner's inner steps save 4x or more, so half leaves a loaded host
    room."""
    rng = np.random.default_rng(24)
    alphas, T_S, r = _cell(rng, 24)
    args = (alphas, T_S, r, Q_TOK, BW, _t_ver(24))
    t_port, t_ref = [], []
    for _ in range(7):
        for fn, out in ((dc.solve_heterogeneous, t_port),
                        (ref.solve_heterogeneous, t_ref)):
            t0 = time.perf_counter()
            fn(*args, L_max=8, n_phi=40, n_lam=40)
            out.append(time.perf_counter() - t0)
    assert min(t_port) <= 0.5 * min(t_ref), (min(t_port), min(t_ref))
