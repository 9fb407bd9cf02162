"""Device resolution for the port's entry points.

Device work runs on the CUDA card unless the caller asks for the CPU
(`--device cpu` on the CLI, `device="cpu"` in Python).  There is no silent
fallback: asking for CUDA on a machine without it raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """torch.device for `device` (None means "cuda").  Raises RuntimeError
    when CUDA is asked for and absent, ValueError for any other kind."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "raven_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' (--device cpu) to run on "
                "the CPU"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")

