"""Configuration structs mirroring the reference's public config surface.

Reference: RavenLib/include/raven/graph/construct.h:13-20 (OverlapPhaseCfg),
RavenLib/include/raven/graph/polish.hpp:13-29 (AlignCfg/CudaCfg/PolishCfg),
RavenLib/src/graph.cc:7 (min_unitig_size global, settable via CLI `-u`).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class OverlapPhaseCfg:
    """Overlap-phase parameters (reference construct.h:13-20)."""

    kmer_len: int = 15
    window_len: int = 5
    freq: float = 0.001
    identity: float = 0.0
    max_num_overlaps: int = 32  # kMaxNumOverlaps
    use_minhash: bool = False  # useMinhash (`-M/--use-micromizers`)


@dataclasses.dataclass
class AlignCfg:
    """POA alignment scores (reference polish.hpp:13-17)."""

    match: int = 3
    mismatch: int = -5
    gap: int = -4


@dataclasses.dataclass
class DeviceCfg:
    """Accelerator batching knobs.

    Analog of the reference CudaCfg (polish.hpp:19-23): controls
    how many POA windows are batched per device dispatch and whether the
    device polishing path is used at all (0 = host path).
    """

    poa_batches: int = 0
    alignment_batches: int = 0
    banded_alignment: bool = False


@dataclasses.dataclass
class PolishCfg:
    """Consensus-phase parameters (reference polish.hpp:25-29)."""

    align_cfg: AlignCfg = dataclasses.field(default_factory=AlignCfg)
    device_cfg: DeviceCfg = dataclasses.field(default_factory=DeviceCfg)
    num_rounds: int = 2


# Global minimal unitig size, settable via CLI `-u` (reference graph.cc:7,
# main.cc:235).  A node assembled from >5 reads and longer than this is a
# "Utg", otherwise a "Ctg" (reference graph.cc:53).
MIN_UNITIG_SIZE_DEFAULT = 9999


class _Globals:
    min_unitig_size: int = MIN_UNITIG_SIZE_DEFAULT
    # host worker-process count for the fork pools (the analog of the
    # reference's `-t/--threads` ThreadPool size, main.cc:102-104);
    # None = auto (min(cpu, 8))
    num_threads: int | None = None


GLOBALS = _Globals()


def worker_count() -> int:
    """Fork-pool worker count: `-t` when given, else min(cpu, 8)."""
    import os

    if GLOBALS.num_threads is not None:
        return max(1, int(GLOBALS.num_threads))
    return min(os.cpu_count() or 1, 8)
