# `short_attention` and `flash_attention` stay submodules here (not
# re-exported as functions), so `from sgpt_tpu_torch.ops import
# short_attention` gives the module with its wrapper, plain version and
# launch counter.
from . import flash_attention, short_attention
from .pooling import (POOLERS, last_token_pool, mean_pool, normalize,
                      weighted_mean_pool)
from .quant import dequantize_weight, int8_project, quantize_decoder_params, quantize_weight

__all__ = ["POOLERS", "last_token_pool", "mean_pool", "normalize",
           "weighted_mean_pool", "flash_attention", "short_attention",
           "quantize_weight", "quantize_decoder_params", "int8_project",
           "dequantize_weight"]
