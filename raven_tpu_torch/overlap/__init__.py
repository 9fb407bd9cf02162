from raven_tpu_torch.overlap.engine import MinimizerIndex  # noqa: F401
from raven_tpu_torch.overlap.types import (  # noqa: F401
    OVERLAP_DTYPE,
    empty_overlaps,
    make_overlaps,
    overlap_length,
    overlap_reverse,
)
