from raven_tpu_torch.pile.pile import (  # noqa: F401
    K_PSS,
    Piles,
    find_slopes,
    merge_regions,
)
