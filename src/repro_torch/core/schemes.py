"""Structured Observation→RoundPlan draft-control scheme API.

Every multi-access draft-control scheme is a registered ``Scheme`` class:
the cell assembles a ``CellObservation`` each round (acceptance estimates,
device speeds, channel rates, latency models, spectrum budget, deadline
info) and the scheme returns a ``RoundPlan`` (per-device draft lengths,
bandwidth shares, verification mode, multi-draft width, predicted goodput).
The CLI, benchmarks, and docs enumerate ``available_schemes()`` and derive
``--scheme-arg`` parsing, help text, and the README table from each
scheme's declared ``Params`` dataclass and capability flags — nothing can
drift.

Registering a scheme is one decorated class::

    @register_scheme
    class MyScheme(Scheme):
        name = "my-scheme"

        @dataclasses.dataclass(frozen=True)
        class Params:
            boost: float = 1.0

        def plan(self, obs: CellObservation) -> RoundPlan:
            ...

The analytic solvers themselves live in ``draft_control``/``beyond``; the
classes here adapt the observation record onto them and annotate the
solution with the plan-level control surface (verification mode, J,
server-drafting latency) the cell executes.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np

from .draft_control import (
    DraftControlSolution,
    solve_centralized,
    solve_fixed,
    solve_heterogeneous,
    solve_homogeneous_exhaustive,
    solve_p2p,
    solve_uniform_bandwidth,
)
from .goodput import expected_accepted_tokens

VERIFICATION_MODES = ("padded", "packed")


class SchemeCapabilityError(ValueError):
    """A scheme was asked to plan outside its declared capabilities."""


# ---------------------------------------------------------------------------
# The two structured records of the control API
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CellObservation:
    """Everything the controller knows at the start of a round (paper
    Fig. 2, step 1), as one immutable record.

    Device axis arrays are row-aligned with the cell's active set.  The
    latency models are carried as their affine coefficients so the record
    stays numpy/JSON friendly: verification ``T_ver(K) = t_ver_fix +
    K*t_ver_lin`` (paper eq. 7) and server-side drafting (Cen-SPIN)
    ``t_draft_fix + K*t_draft_lin`` per drafted token.
    """

    alphas: np.ndarray            # per-device acceptance estimates
    T_S: np.ndarray               # per-device SLM per-token latency [s]
    rates: np.ndarray             # uplink spectrum efficiencies [bit/s/Hz]
    q_tok_bits: float             # per-token uplink payload (paper eq. 9)
    bandwidth_hz: float           # total OFDMA bandwidth budget B
    t_ver_fix: float              # verification latency model (eq. 7)
    t_ver_lin: float
    t_draft_fix: float = 0.0      # server drafting model (Cen-SPIN)
    t_draft_lin: float = 0.0
    L_max: int = 25               # admissible draft-length ceiling
    n_phi: int = 40               # Algorithm-1 grid resolution
    n_lam: int = 40
    deadline_factor: float | None = None  # straggler deadline x median T_ma

    @property
    def K(self) -> int:
        return len(self.alphas)

    def t_ver(self, K: int | None = None) -> float:
        """Batched verification latency for ``K`` sequences (eq. 7)."""
        return self.t_ver_fix + (self.K if K is None else K) * self.t_ver_lin

    def t_draft_per_token(self, K: int | None = None) -> float:
        """Server-side per-token draft latency for a K-sequence batch."""
        return self.t_draft_fix + (self.K if K is None else K) * self.t_draft_lin

    def take(self, idx) -> "CellObservation":
        """Sub-observation over a subset of devices (pipelined halves)."""
        return dataclasses.replace(
            self, alphas=np.asarray(self.alphas)[idx],
            T_S=np.asarray(self.T_S)[idx], rates=np.asarray(self.rates)[idx])


@dataclasses.dataclass
class RoundPlan:
    """Controller output for one Multi-SPIN round — the full control
    surface the cell executes, replacing the bare ``DraftControlSolution``
    downstream.
    """

    lengths: np.ndarray                # integer draft lengths L_k*
    bandwidth: np.ndarray              # B_k* [Hz] (zeros: no uplink involved)
    goodput: float                     # predicted sum goodput [tokens/s]
    equalized_latency: float           # phi* / predicted T_ma [s]
    verification_mode: str = "padded"  # "padded" | "packed" server batching
    draft_width: int = 1               # multi-draft J (drafts per device)
    t_ver: float | None = None         # scheme-predicted verification latency
                                       # (None -> cell uses its affine model)
    expected_tokens: float | None = None  # predicted accepted tokens / round
    per_device_latency: np.ndarray | None = None  # draft+upload override
                                       # (server-drafting schemes: no uplink)
    meta: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_solution(cls, sol: DraftControlSolution, obs: CellObservation,
                      **kw) -> "RoundPlan":
        kw.setdefault("t_ver", sol.meta.get("t_ver"))
        kw.setdefault("expected_tokens", float(np.sum(
            expected_accepted_tokens(obs.alphas, sol.lengths))))
        return cls(lengths=np.asarray(sol.lengths, dtype=np.int64),
                   bandwidth=np.asarray(sol.bandwidth, dtype=np.float64),
                   goodput=float(sol.goodput),
                   equalized_latency=float(sol.equalized_latency),
                   meta=dict(sol.meta), **kw)


# ---------------------------------------------------------------------------
# Scheme base class + registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SchemeCapabilities:
    """Declarative capability flags enforced by the cell/config layer."""

    single_user_only: bool = False    # P2P: exactly one device per cell
    server_drafting: bool = False     # Cen-SPIN: no uplink, server drafts
    packed_verification: bool = False  # ragged token-budget verification
    multi_draft: bool = False         # J > 1 drafts per device

    def flags(self) -> tuple[str, ...]:
        return tuple(f.name for f in dataclasses.fields(self)
                     if getattr(self, f.name))


@dataclasses.dataclass(frozen=True)
class _NoParams:
    pass


class Scheme:
    """Base class for registered draft-control schemes.

    Subclasses declare a ``name``, a ``Params`` dataclass (the schema that
    drives ``CellConfig.scheme_params`` validation and ``--scheme-arg``
    parsing), optional ``capabilities`` flags, and implement
    ``plan(obs) -> RoundPlan``.
    """

    name: ClassVar[str]
    Params: ClassVar[type] = _NoParams
    capabilities: ClassVar[SchemeCapabilities] = SchemeCapabilities()

    def __init__(self, **params):
        try:
            self.params = self.Params(**params)
        except TypeError as e:
            valid = {f.name for f in dataclasses.fields(self.Params)}
            unknown = sorted(set(params) - valid)
            if unknown:
                raise ValueError(
                    f"unknown scheme parameter(s) {unknown} for scheme "
                    f"{self.name!r}; valid parameters: "
                    f"{', '.join(sorted(valid)) or '(none)'}") from None
            # e.g. a Params field without a default left unset
            raise ValueError(
                f"invalid scheme_params for scheme {self.name!r}: {e}") \
                from None

    def plan(self, obs: CellObservation) -> RoundPlan:
        raise NotImplementedError

    # -- shared helpers -------------------------------------------------

    def _check(self, obs: CellObservation):
        if self.capabilities.single_user_only and obs.K != 1:
            raise SchemeCapabilityError(
                f"scheme {self.name!r} is single-user (capability "
                f"'single_user_only'): it plans for exactly one device, "
                f"got K={obs.K}")

    def _verifier(self, obs: CellObservation):
        from .beyond import TokenBudgetVerifier
        return TokenBudgetVerifier.from_affine(
            obs.t_ver_fix, obs.t_ver_lin, L_ref=self.params.L_ref,
            kv_fraction=self.params.kv_fraction)


_REGISTRY: dict[str, type[Scheme]] = {}


def register_scheme(cls: type[Scheme]) -> type[Scheme]:
    """Class decorator: register ``cls`` under its declared ``name``."""
    name = getattr(cls, "name", None)
    if not isinstance(name, str) or not name:
        raise ValueError(f"{cls.__name__} must declare a string 'name'")
    if name in _REGISTRY:
        raise ValueError(f"scheme {name!r} already registered")
    if not dataclasses.is_dataclass(cls.Params):
        raise ValueError(f"{cls.__name__}.Params must be a dataclass")
    _REGISTRY[name] = cls
    return cls


def get_scheme(name: str) -> type[Scheme]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown scheme {name!r}; available: "
                       f"{', '.join(available_schemes())}") from None


def build_scheme(name: str, params: dict | None = None) -> Scheme:
    """Instantiate the registered scheme with validated parameters."""
    return get_scheme(name)(**(params or {}))


def available_schemes() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# Schema-driven CLI parsing / help / docs
# ---------------------------------------------------------------------------

def scheme_param_fields(name: str) -> tuple[dataclasses.Field, ...]:
    return dataclasses.fields(get_scheme(name).Params)


def _coerce(annotation: str, value: str):
    """Coerce a CLI string to a Params field type (annotations are strings
    under ``from __future__ import annotations``)."""
    ann = str(annotation)
    if value.lower() in ("none", "null") and "None" in ann:
        return None
    if "bool" in ann:
        if value.lower() in ("1", "true", "yes"):
            return True
        if value.lower() in ("0", "false", "no"):
            return False
        raise ValueError(f"expected a boolean, got {value!r}")
    if "int" in ann:
        return int(value)
    if "float" in ann:
        return float(value)
    return value


def parse_scheme_args(name: str, kvs: list[str] | None) -> dict:
    """Parse ``--scheme-arg key=val`` pairs against the scheme's schema."""
    fields = {f.name: f for f in scheme_param_fields(name)}
    out: dict = {}
    for kv in kvs or []:
        key, sep, val = kv.partition("=")
        if not sep:
            raise ValueError(f"--scheme-arg expects key=value, got {kv!r}")
        if key not in fields:
            valid = ", ".join(sorted(fields)) or "(none)"
            raise ValueError(f"scheme {name!r} has no parameter {key!r}; "
                             f"valid parameters: {valid}")
        out[key] = _coerce(fields[key].type, val)
    return out


def _param_summary(name: str) -> str:
    return " ".join(f"{f.name}={f.default!r}" for f in scheme_param_fields(name))


def scheme_help_text() -> str:
    """Per-scheme parameter/capability help for CLI epilogs."""
    lines = ["registered schemes (--scheme-arg key=val per parameter):"]
    for name in available_schemes():
        cls = get_scheme(name)
        caps = ", ".join(cls.capabilities.flags()) or "-"
        params = _param_summary(name) or "-"
        lines.append(f"  {name:26s} params: {params:34s} capabilities: {caps}")
    return "\n".join(lines)


def scheme_table_markdown() -> str:
    """README scheme table, generated from the registry."""
    rows = ["| scheme | parameters | capabilities |", "|---|---|---|"]
    for name in available_schemes():
        cls = get_scheme(name)
        params = ", ".join(f"`{f.name}={f.default!r}`"
                           for f in scheme_param_fields(name)) or "—"
        caps = ", ".join(f"`{c}`" for c in cls.capabilities.flags()) or "—"
        rows.append(f"| `{name}` | {params} | {caps} |")
    return "\n".join(rows)


# ---------------------------------------------------------------------------
# Paper schemes (Sec. IV/V) + baselines (Sec. VI-A4)
# ---------------------------------------------------------------------------

@register_scheme
class HeteScheme(Scheme):
    """Algorithm 1: joint heterogeneous lengths + bandwidth (paper Sec. V)."""

    name = "hete"

    def plan(self, obs: CellObservation) -> RoundPlan:
        self._check(obs)
        sol = solve_heterogeneous(
            obs.alphas, T_S=obs.T_S, r=obs.rates, Q_tok=obs.q_tok_bits,
            B=obs.bandwidth_hz, T_ver=obs.t_ver(), L_max=obs.L_max,
            n_phi=obs.n_phi, n_lam=obs.n_lam)
        return RoundPlan.from_solution(sol, obs)


@register_scheme
class HomoScheme(Scheme):
    """Homo-Multi-SPIN: optimal uniform length, Lemma-1 bandwidth."""

    name = "homo"

    def plan(self, obs: CellObservation) -> RoundPlan:
        self._check(obs)
        sol = solve_homogeneous_exhaustive(
            obs.alphas, T_S=obs.T_S, r=obs.rates, Q_tok=obs.q_tok_bits,
            B=obs.bandwidth_hz, T_ver=obs.t_ver(), L_max=obs.L_max)
        return RoundPlan.from_solution(sol, obs)


@register_scheme
class UniBwScheme(Scheme):
    """Uni-BW Multi-SPIN: heterogeneous lengths under B_k = B/K."""

    name = "uni-bw"

    @dataclasses.dataclass(frozen=True)
    class Params:
        n_phi: int = 200       # 1-D latency sweep resolution

    def plan(self, obs: CellObservation) -> RoundPlan:
        self._check(obs)
        sol = solve_uniform_bandwidth(
            obs.alphas, T_S=obs.T_S, r=obs.rates, Q_tok=obs.q_tok_bits,
            B=obs.bandwidth_hz, T_ver=obs.t_ver(), L_max=obs.L_max,
            n_phi=self.params.n_phi)
        return RoundPlan.from_solution(sol, obs)


@register_scheme
class FixedScheme(Scheme):
    """Fixed BW&L baseline: L_k = L_fixed, B_k = B/K."""

    name = "fixed"

    @dataclasses.dataclass(frozen=True)
    class Params:
        L_fixed: int = 8

    def plan(self, obs: CellObservation) -> RoundPlan:
        self._check(obs)
        sol = solve_fixed(
            obs.alphas, T_S=obs.T_S, r=obs.rates, Q_tok=obs.q_tok_bits,
            B=obs.bandwidth_hz, T_ver=obs.t_ver(),
            L_fixed=self.params.L_fixed)
        return RoundPlan.from_solution(sol, obs)


@register_scheme
class P2PScheme(Scheme):
    """P2P-SPIN baseline: one device, full bandwidth, exhaustive L."""

    name = "p2p"
    capabilities = SchemeCapabilities(single_user_only=True)

    def plan(self, obs: CellObservation) -> RoundPlan:
        self._check(obs)
        sol = solve_p2p(
            float(obs.alphas[0]), float(obs.T_S[0]), float(obs.rates[0]),
            obs.q_tok_bits, obs.bandwidth_hz, T_ver_single=obs.t_ver(1),
            L_max=obs.L_max)
        return RoundPlan.from_solution(sol, obs)


@register_scheme
class CenScheme(Scheme):
    """Cen-SPIN baseline: the server drafts AND verifies for all K prompts
    (no uplink; per drafted token the server spends
    ``t_draft_fix + K*t_draft_lin``)."""

    name = "cen"
    capabilities = SchemeCapabilities(server_drafting=True)

    def plan(self, obs: CellObservation) -> RoundPlan:
        self._check(obs)
        if obs.t_draft_fix <= 0.0 and obs.t_draft_lin <= 0.0:
            raise ValueError(
                "scheme 'cen' needs the server draft-latency model: set "
                "t_draft_fix/t_draft_lin on the CellConfig (or controller)")
        sol = solve_centralized(obs.alphas, obs.t_ver(), obs.t_draft_fix,
                                obs.t_draft_lin, L_max=obs.L_max)
        # server drafting: the "multi-access" phase is the batched SLM
        # forward, identical for every device — no uplink to straggle on
        per_dev = sol.lengths.astype(np.float64) * obs.t_draft_per_token()
        return RoundPlan.from_solution(sol, obs, per_device_latency=per_dev)


# ---------------------------------------------------------------------------
# Beyond-paper schemes (core/beyond.py solvers)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _TokenBudgetParams:
    kv_fraction: float = 0.7   # length-agnostic share of T_lin (KV reads)
    L_ref: int = 8             # affine-model calibration draft length


@register_scheme
class HetePackedScheme(Scheme):
    """Heterogeneous lengths under ragged PACKED token-budget verification
    (no zero-pad compute; see ``core/beyond.py``)."""

    name = "hete-packed"
    Params = _TokenBudgetParams
    capabilities = SchemeCapabilities(packed_verification=True)

    def plan(self, obs: CellObservation) -> RoundPlan:
        self._check(obs)
        from .beyond import solve_heterogeneous_packed
        sol = solve_heterogeneous_packed(
            obs.alphas, T_S=obs.T_S, r=obs.rates, Q_tok=obs.q_tok_bits,
            B=obs.bandwidth_hz, verifier=self._verifier(obs),
            L_max=obs.L_max, n_phi=obs.n_phi, n_lam=obs.n_lam)
        return RoundPlan.from_solution(sol, obs, verification_mode="packed")


@register_scheme
class HetePaddedTokenBudgetScheme(Scheme):
    """Same token-budget verifier but ZERO-PADDED batching (paper layout):
    the honest baseline for measuring the packing gain."""

    name = "hete-padded-tokenbudget"
    Params = _TokenBudgetParams

    def plan(self, obs: CellObservation) -> RoundPlan:
        self._check(obs)
        from .beyond import solve_heterogeneous_padded_tokenbudget
        sol = solve_heterogeneous_padded_tokenbudget(
            obs.alphas, T_S=obs.T_S, r=obs.rates, Q_tok=obs.q_tok_bits,
            B=obs.bandwidth_hz, verifier=self._verifier(obs),
            L_max=obs.L_max, n_phi=obs.n_phi, n_lam=obs.n_lam)
        return RoundPlan.from_solution(sol, obs)


@register_scheme
class MultiDraftScheme(Scheme):
    """Joint (L, J) optimization in the uniform regime: each device uploads
    J i.i.d. drafts and the server keeps the longest-accepted one."""

    name = "multidraft"

    @dataclasses.dataclass(frozen=True)
    class Params:
        J_max: int = 6
        J_min: int = 1         # floor the searched widths (engine gates
                               # pin 2 so the tree path always exercises)
        kv_fraction: float = 0.7
        L_ref: int = 8

    capabilities = SchemeCapabilities(multi_draft=True)

    def plan(self, obs: CellObservation) -> RoundPlan:
        self._check(obs)
        from .beyond import solve_uniform_multidraft
        out = solve_uniform_multidraft(
            float(np.mean(obs.alphas)), obs.T_S, obs.rates, obs.q_tok_bits,
            obs.bandwidth_hz, self._verifier(obs), obs.K, L_max=obs.L_max,
            J_max=self.params.J_max, J_min=self.params.J_min)
        best = out["best"]
        K = obs.K
        lengths = np.full(K, int(best["L"]), dtype=np.int64)
        per_dev = np.full(K, float(best["t_ma"]), dtype=np.float64)
        return RoundPlan(
            lengths=lengths,
            bandwidth=np.asarray(out["bandwidth"], dtype=np.float64),
            goodput=float(best["goodput"]),
            equalized_latency=float(best["t_ma"]),
            draft_width=int(best["J"]),
            t_ver=float(best["t_ver"]),
            expected_tokens=float(K * best["E_N"]),
            per_device_latency=per_dev,
            meta={"scheme": "multidraft", "theta": out["theta"],
                  "single_draft": out["single_draft"], "gain": out["gain"]},
        )


if __name__ == "__main__":
    # the README scheme table is generated from here:
    #   PYTHONPATH=src python -m repro.core.schemes
    print(scheme_table_markdown())
