"""Seeds of a run's parts, drawn from ``--seed`` by name: the same seed
gives the same inputs, whatever the seed's size or sign."""

from __future__ import annotations

import hashlib


def derive(seed: int, part: str) -> int:
    """A 62-bit seed for ``part`` of the run of ``seed``."""
    h = hashlib.sha256(f"{int(seed)}:{part}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 2
