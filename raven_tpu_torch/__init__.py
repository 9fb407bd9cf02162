"""raven_tpu_torch: the raven-tpu assembler on PyTorch and CUDA.

A port of raven_tpu (JAX on a TPU) to PyTorch on an NVIDIA Hopper card.
The layout mirrors raven_tpu so each module's counterpart is easy to find:

  raven_tpu_torch.io        sequence I/O + 2-bit packed read sets
  raven_tpu_torch.ops       torch device ops and hand-written CUDA kernels
  raven_tpu_torch.overlap   minimizer index + mapping engine
  raven_tpu_torch.pile      pile-o-gram (coverage profile) engine
  raven_tpu_torch.graph     assembly graph: construct / assemble / serialization
  raven_tpu_torch.polish    racon-equivalent polisher (window consensus)
  raven_tpu_torch.parallel  device meshes, the hash-range-sharded index
  raven_tpu_torch.native    optional C++ accelerators (ctypes)
  raven_tpu_torch.csrc      CUDA kernel sources and their nvcc builder
  raven_tpu_torch.api       Python API mirroring the ravenpy bindings

Host-only modules are copies of raven_tpu's, so this package imports
nothing of raven_tpu and never imports jax.  Device work runs on the
device the caller names (raven_tpu_torch.device.resolve_device): CUDA by
default, the CPU only when asked for.  Polishing runs raven_tpu's three
device consensus engines: the shift-banded one (the default), the full-NW
one (DeviceCfg.poa_batches > 0) and the anchored banded one
(DeviceCfg.banded_alignment).  With more than one card visible, the
overlap index and the consensus votes spread over every card
(raven_tpu_torch.parallel), one Python process driving them all.
"""

__version__ = "0.1.0"

from raven_tpu_torch.config import (  # noqa: F401
    AlignCfg,
    DeviceCfg,
    OverlapPhaseCfg,
    PolishCfg,
)
