"""Seed derivation: every random stream of a run is named, and its seed is
a hash of the run's ``--seed`` and that name, so streams never share state
and a seed past 32 bits is taken whole."""

from __future__ import annotations

import hashlib


def derive(seed: int, *parts) -> int:
    """A 63-bit seed for the stream ``parts`` of run ``seed``."""
    digest = hashlib.blake2b(repr((int(seed),) + parts).encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") & (2 ** 63 - 1)
