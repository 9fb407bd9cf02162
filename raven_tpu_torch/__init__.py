"""raven_tpu_torch: the raven-tpu assembler on PyTorch and CUDA.

A port of raven_tpu (JAX on a TPU) to PyTorch on an NVIDIA Hopper card.
The layout mirrors raven_tpu so each module's counterpart is easy to find:

  raven_tpu_torch.io        sequence I/O + 2-bit packed read sets
  raven_tpu_torch.ops       torch device ops and hand-written CUDA kernels
  raven_tpu_torch.overlap   minimizer index + mapping engine
  raven_tpu_torch.pile      pile-o-gram (coverage profile) engine
  raven_tpu_torch.graph     assembly graph: construct / assemble / serialization
  raven_tpu_torch.polish    racon-equivalent polisher (window consensus)
  raven_tpu_torch.native    optional C++ accelerators (ctypes)
  raven_tpu_torch.csrc      CUDA kernel sources and their nvcc builder

Host-only modules are copies of raven_tpu's, so this package imports
nothing of raven_tpu and never imports jax.  Device work runs on the
device the caller names (raven_tpu_torch.device.resolve_device): CUDA by
default, the CPU only when asked for.  Polishing runs with the full-NW
device consensus (DeviceCfg.poa_batches > 0); raven_tpu's other consensus
engines arrive in later slices.
"""

__version__ = "0.1.0"

from raven_tpu_torch.config import (  # noqa: F401
    AlignCfg,
    DeviceCfg,
    OverlapPhaseCfg,
    PolishCfg,
)
