"""Write-time shuffle options (counterpart of nvtabular_tpu/io/shuffle.py).
The shuffled writer itself is not ported yet (ROADMAP.md queue 1 item 1)."""

from __future__ import annotations

import enum


class Shuffle(enum.Enum):
    PER_PARTITION = "per_partition"
    PER_WORKER = "per_worker"
    FULL = "full"
