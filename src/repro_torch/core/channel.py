"""OFDMA uplink channel model (paper Sec. II-B).

Devices transmit with constant power spectral density (paper Sec. VI-A3), so
the per-Hz SNR — and therefore the spectrum efficiency r_k of eq. (8) — is
independent of the allocated bandwidth.  This is exactly why the paper can
treat r_k as a constant inside the draft-control optimization.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def dbm_to_watt(dbm: float) -> float:
    return 10.0 ** ((dbm - 30.0) / 10.0)


def db_to_linear(db: float) -> float:
    return 10.0 ** (db / 10.0)


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """System-level wireless parameters (paper Sec. VI-A3 defaults)."""

    total_bandwidth_hz: float = 10e6          # B = 10 MHz
    total_power_dbm: float = 23.0             # P = 23 dBm
    noise_psd_dbm_hz: float = -170.0          # N0 = -170 dBm/Hz
    retained_vocab: int = 1024                # |V^hat|
    prob_bits: int = 16                       # Q_B
    vocab_size: int = 32000                   # V (per target model)
    snr_lo_db: float = 18.2                   # avg received SNR range
    snr_hi_db: float = 22.2

    @property
    def power_psd(self) -> float:
        """Transmit PSD [W/Hz]: constant-PSD transmission."""
        return dbm_to_watt(self.total_power_dbm) / self.total_bandwidth_hz

    @property
    def noise_psd(self) -> float:
        return dbm_to_watt(self.noise_psd_dbm_hz)

    @property
    def q_tok_bits(self) -> float:
        """Q_tok = |V^hat| (Q_B + ceil(log2 V))   (paper eq. 9)."""
        return self.retained_vocab * (self.prob_bits + int(np.ceil(np.log2(self.vocab_size))))


def sample_average_gains(cfg: ChannelConfig, K: int, rng: np.random.Generator) -> np.ndarray:
    """Draw average channel power gains H̄_k such that the average received
    SNR is uniform in [snr_lo_db, snr_hi_db] (paper Sec. VI-A3)."""
    snr_db = rng.uniform(cfg.snr_lo_db, cfg.snr_hi_db, size=K)
    snr = db_to_linear(snr_db)
    # snr = PSD * H̄ / N0  =>  H̄ = snr * N0 / PSD
    return snr * cfg.noise_psd / cfg.power_psd


def sample_rayleigh_gains(avg_gains: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Block Rayleigh fading: H_k = |h_k|^2, h_k ~ CN(0, H̄_k).

    |h|^2 is exponential with mean H̄_k.
    """
    return rng.exponential(scale=avg_gains)


def spectrum_efficiency(cfg: ChannelConfig, gains: np.ndarray) -> np.ndarray:
    """r_k = log2(1 + PSD * H_k / N0)   (eq. 8 under constant-PSD power)."""
    snr = cfg.power_psd * np.asarray(gains) / cfg.noise_psd
    return np.log2(1.0 + snr)


@dataclasses.dataclass
class ChannelState:
    """One block-fading realization for K devices."""

    cfg: ChannelConfig
    avg_gains: np.ndarray
    gains: np.ndarray
    rates: np.ndarray  # spectrum efficiency r_k [bit/s/Hz]

    @classmethod
    def sample(cls, cfg: ChannelConfig, K: int, rng: np.random.Generator,
               avg_gains: np.ndarray | None = None) -> "ChannelState":
        if avg_gains is None:
            avg_gains = sample_average_gains(cfg, K, rng)
        gains = sample_rayleigh_gains(avg_gains, rng)
        return cls(cfg=cfg, avg_gains=avg_gains, gains=gains,
                   rates=spectrum_efficiency(cfg, gains))

    def refade(self, rng: np.random.Generator) -> "ChannelState":
        """New small-scale fading block with the same large-scale gains."""
        return ChannelState.sample(self.cfg, len(self.avg_gains), rng,
                                   avg_gains=self.avg_gains)

    def uplink_rate_bps(self, bandwidth_hz: np.ndarray) -> np.ndarray:
        """R_k = B_k r_k [bit/s]   (eq. 8)."""
        return np.asarray(bandwidth_hz) * self.rates
