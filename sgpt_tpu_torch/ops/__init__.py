# `short_attention` stays a submodule here (not re-exported as a function),
# so `from sgpt_tpu_torch.ops import short_attention` gives the module with
# its wrapper, plain version and launch counter.
from . import short_attention
from .pooling import (POOLERS, last_token_pool, mean_pool, normalize,
                      weighted_mean_pool)

__all__ = ["POOLERS", "last_token_pool", "mean_pool", "normalize",
           "weighted_mean_pool", "short_attention"]
