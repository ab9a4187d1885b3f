from .base import (Tokenizer, SimpleTokenizer, HFTokenizer, get_tokenizer,
                   TokenizerLoadError, check_specb_brackets, GPT2_BRACKET_IDS)
from .specb import SpecbCodec, BatchEncoding, encode_batch

__all__ = ["Tokenizer", "SimpleTokenizer", "HFTokenizer", "get_tokenizer",
           "TokenizerLoadError", "check_specb_brackets", "GPT2_BRACKET_IDS",
           "SpecbCodec", "BatchEncoding", "encode_batch"]
