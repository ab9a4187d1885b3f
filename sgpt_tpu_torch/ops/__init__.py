# `short_attention` and `flash_attention` stay submodules here (not
# re-exported as functions), so `from sgpt_tpu_torch.ops import
# short_attention` gives the module with its wrapper, plain version and
# launch counter.
from . import flash_attention, short_attention
from .pooling import (POOLERS, last_token_pool, mean_pool, normalize,
                      weighted_mean_pool)

__all__ = ["POOLERS", "last_token_pool", "mean_pool", "normalize",
           "weighted_mean_pool", "flash_attention", "short_attention"]
