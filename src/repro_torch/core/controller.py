"""Server-side multi-access draft controller (paper protocol step 1).

Each round the server receives device profiles (acceptance rate, compute
speed), measures uplink channels, assembles a ``CellObservation``, and asks
the configured scheme for a ``RoundPlan``.  Also hosts the online
acceptance-rate estimator (EWMA over realized accept fractions) used when
task profiles are not declared a priori.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .schemes import (
    CellObservation,
    RoundPlan,
    available_schemes,
    get_scheme,
)

def __getattr__(name):
    # Derived live from the scheme registry — register new schemes in
    # ``repro.core.schemes``; a scheme registered after import (the
    # ``@register_scheme`` extension point) is visible here immediately.
    if name == "SCHEMES":
        return available_schemes()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclasses.dataclass
class VerificationLatencyModel:
    """T_ver(K) = T_fix + K T_lin (paper eq. 7), fitted per target model.

    The same affine-in-batch law models server-side drafting for Cen-SPIN
    (a batched SLM forward per drafted token)."""

    t_fix: float
    t_lin: float

    def __call__(self, K: int) -> float:
        return self.t_fix + K * self.t_lin


@dataclasses.dataclass
class MultiSpinController:
    scheme: str
    q_tok_bits: float
    bandwidth_hz: float
    t_ver_model: VerificationLatencyModel
    t_draft_model: VerificationLatencyModel | None = None  # Cen-SPIN drafting
    L_max: int = 25
    L_fixed: int = 8
    n_phi: int = 40
    n_lam: int = 40
    deadline_factor: float | None = None
    scheme_params: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        params = dict(self.scheme_params)
        # legacy knob: the fixed scheme's length rides on the controller, so
        # CellConfig(L_fixed=...) keeps working; scheme_params wins when set
        cls = get_scheme(self.scheme)
        if "L_fixed" in {f.name for f in dataclasses.fields(cls.Params)}:
            params.setdefault("L_fixed", self.L_fixed)
        self.scheme_obj = cls(**params)

    def observe(self, alphas: np.ndarray, T_S: np.ndarray,
                rates: np.ndarray) -> CellObservation:
        """Assemble the per-round observation record for the scheme."""
        td = self.t_draft_model
        return CellObservation(
            alphas=np.asarray(alphas, dtype=np.float64),
            T_S=np.asarray(T_S, dtype=np.float64),
            rates=np.asarray(rates, dtype=np.float64),
            q_tok_bits=self.q_tok_bits, bandwidth_hz=self.bandwidth_hz,
            t_ver_fix=self.t_ver_model.t_fix, t_ver_lin=self.t_ver_model.t_lin,
            t_draft_fix=(td.t_fix if td is not None else 0.0),
            t_draft_lin=(td.t_lin if td is not None else 0.0),
            L_max=self.L_max, n_phi=self.n_phi, n_lam=self.n_lam,
            deadline_factor=self.deadline_factor)

    def plan(self, alphas: np.ndarray, T_S: np.ndarray,
             rates: np.ndarray) -> RoundPlan:
        return self.scheme_obj.plan(self.observe(alphas, T_S, rates))

    def plan_pipelined(self, alphas: np.ndarray, T_S: np.ndarray,
                       rates: np.ndarray) -> dict:
        """Two-half-batch pipelined plan: {goodput, period, halves}."""
        from .beyond import pipelined_plan
        return pipelined_plan(self.scheme_obj,
                              self.observe(alphas, T_S, rates))


class AcceptanceEstimator:
    """Online EWMA estimate of per-device acceptance rates from realized
    verification outcomes (used when devices do not report task profiles)."""

    def __init__(self, K: int, prior: float = 0.8, decay: float = 0.9):
        self.prior = prior
        self.succ = np.full(K, prior)       # EWMA accepted Bernoulli trials
        self.trials = np.ones(K)            # EWMA total Bernoulli trials
        self.decay = decay

    def extend(self, n: int):
        """Open EWMA slots for ``n`` devices joining the cell."""
        self.succ = np.concatenate([self.succ, np.full(n, self.prior)])
        self.trials = np.concatenate([self.trials, np.ones(n)])

    def keep(self, keep_mask: np.ndarray):
        """Drop EWMA slots of devices leaving the cell."""
        keep_mask = np.asarray(keep_mask, dtype=bool)
        self.succ = self.succ[keep_mask]
        self.trials = self.trials[keep_mask]

    @property
    def alpha_hat(self) -> np.ndarray:
        return np.clip(self.succ / np.maximum(self.trials, 1e-9), 0.01, 0.995)

    @alpha_hat.setter
    def alpha_hat(self, value):
        self.succ = np.asarray(value, dtype=np.float64).copy()
        self.trials = np.ones_like(self.succ)

    def update(self, accept_counts: np.ndarray, lengths: np.ndarray,
               mask: np.ndarray | None = None):
        """Each accepted draft token is a Bernoulli success; the (at most one)
        rejection is a failure.  EWMA of successes and trials separately —
        the ratio-of-sums estimator is consistent for the truncated
        geometric, unlike the per-round mean of ratios.

        ``mask`` selects the devices that actually participated in the round:
        a deadline-dropped device reports accepted=0, which is NOT a run of
        rejections, so its EWMA state must be left untouched.
        """
        counts = np.asarray(accept_counts, dtype=np.float64)
        lengths = np.maximum(np.asarray(lengths, dtype=np.float64), 1.0)
        rejected = (counts < lengths).astype(np.float64)
        new_succ = self.decay * self.succ + (1 - self.decay) * counts
        new_trials = (self.decay * self.trials
                      + (1 - self.decay) * (counts + rejected))
        if mask is None:
            mask = np.ones_like(counts, dtype=bool)
        else:
            mask = np.asarray(mask, dtype=bool)
        self.succ = np.where(mask, new_succ, self.succ)
        self.trials = np.where(mask, new_trials, self.trials)
        return self.alpha_hat
