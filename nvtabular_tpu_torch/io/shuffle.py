"""Write-time shuffle options (counterpart of nvtabular_tpu/io/shuffle.py)."""

from __future__ import annotations

import enum


class Shuffle(enum.Enum):
    PER_PARTITION = "per_partition"
    PER_WORKER = "per_worker"
    FULL = "full"


def check_shuffle_arg(shuffle):
    """None/False → None, True → PER_WORKER, a name → its Shuffle."""
    if shuffle is None or shuffle is False:
        return None
    if shuffle is True:
        return Shuffle.PER_WORKER
    if isinstance(shuffle, str):
        return Shuffle(shuffle.lower())
    if isinstance(shuffle, Shuffle):
        return shuffle
    raise ValueError(f"Invalid shuffle argument: {shuffle!r}")
