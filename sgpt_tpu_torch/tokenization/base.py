"""Tokenizer protocol + implementations.

The port's own copy of `sgpt_tpu/tokenization/base.py`, with the same behaviour: the
port imports nothing of the JAX package.

The framework is tokenizer-agnostic: anything exposing `encode(text) -> List[int]`
and the bracket token ids works. `HFTokenizer` adapts a HuggingFace tokenizer
(the reference's path, beir_dense_retriever.py:138-152); `SimpleTokenizer` is a
self-contained hash-bucket word tokenizer so the full stack runs and is testable
with zero downloads.
"""
from __future__ import annotations

import hashlib
import logging
from typing import List, Optional, Protocol, Sequence, runtime_checkable

logger = logging.getLogger(__name__)


class TokenizerLoadError(RuntimeError):
    """A real (HF) tokenizer was required but could not be loaded/validated.

    Raised instead of silently falling back to the hash tokenizer: a fallback
    under real weights would encode garbage and report a plausible-but-wrong
    nDCG (the silent-wrong-result class the score-parity run must never hit).
    """


# GPT-2-family byte-BPE maps printable ASCII to ord(c) - 33, so the SPECB
# brackets have fixed single-token ids. The reference hardcodes the same
# tokenize-then-convert path (beir_dense_retriever.py:150-153: encode("[") etc.)
# and every GPT-2/Neo/J checkpoint shares this vocab; a tokenizer claiming
# vocab_size 50257 that disagrees is corrupt.
GPT2_BRACKET_IDS = {"[": [58], "]": [60], "{": [90], "}": [92]}
_GPT2_VOCAB_SIZE = 50257


def check_specb_brackets(tok: "Tokenizer", name: str = "?") -> None:
    """Preflight: GPT-2-family tokenizers must produce the reference bracket ids.

    No-op for other vocab sizes (BLOOM etc. have their own multi-token
    brackets, handled generically by SpecbCodec)."""
    if tok.vocab_size != _GPT2_VOCAB_SIZE:
        return
    got = {b: tok.bracket_ids(b) for b in "[]{}"}
    if got != GPT2_BRACKET_IDS:
        raise TokenizerLoadError(
            f"tokenizer {name!r} claims the GPT-2 vocab (50257) but its SPECB "
            f"bracket ids {got} differ from the reference's {GPT2_BRACKET_IDS} "
            f"(beir_dense_retriever.py:100-104,150-153) - refusing to encode "
            f"with a corrupt tokenizer")


@runtime_checkable
class Tokenizer(Protocol):
    vocab_size: int
    eos_id: int
    pad_id: int

    def encode(self, text: str) -> List[int]: ...

    def bracket_ids(self, bracket: str) -> List[int]:
        """Token ids for one of '[', ']', '{', '}' (SPECB brackets)."""
        ...


class SimpleTokenizer:
    """Deterministic hash-bucket word-level tokenizer (test / smoke usage).

    Ids 0..3 are reserved: 0=pad, 1=eos, and the four brackets get dedicated ids
    so SPECB semantics are exactly representable.
    """

    BRACKETS = {"[": 2, "]": 3, "{": 4, "}": 5}
    N_RESERVED = 6

    def __init__(self, vocab_size: int = 50257):
        self.vocab_size = vocab_size
        self.pad_id = 0
        self.eos_id = 1

    def encode(self, text: str) -> List[int]:
        out = []
        for word in text.split():
            h = int.from_bytes(hashlib.md5(word.lower().encode()).digest()[:4], "little")
            out.append(self.N_RESERVED + h % (self.vocab_size - self.N_RESERVED))
        return out

    def encode_batch(self, texts: Sequence[str]) -> List[List[int]]:
        """Batched encode (same ids as per-text encode); the word→id hash
        is memoized across the batch — corpora repeat words heavily."""
        if type(self).encode is not SimpleTokenizer.encode:
            # subclass overrode encode(): don't bypass it with the memo path
            return [self.encode(t) for t in texts]
        memo: dict = {}
        n = self.vocab_size - self.N_RESERVED
        out = []
        for text in texts:
            row = []
            for word in text.split():
                w = word.lower()
                i = memo.get(w)
                if i is None:
                    h = int.from_bytes(hashlib.md5(w.encode()).digest()[:4],
                                       "little")
                    i = memo[w] = self.N_RESERVED + h % n
                row.append(i)
            out.append(row)
        return out

    def bracket_ids(self, bracket: str) -> List[int]:
        return [self.BRACKETS[bracket]]


class HFTokenizer:
    """Adapter over a HuggingFace tokenizer.

    Mirrors the reference setup: GPT tokenizers get pad_token = eos_token
    (beir_dense_retriever.py:140-142) and brackets are encoded with the plain
    `encode` (beir_dense_retriever.py:151-155) so multi-token brackets work.
    """

    def __init__(self, hf_tokenizer):
        self.tok = hf_tokenizer
        if self.tok.pad_token is None:
            self.tok.pad_token = self.tok.eos_token
        self.vocab_size = len(self.tok)
        self.eos_id = self.tok.eos_token_id
        self.pad_id = self.tok.pad_token_id

    def encode(self, text: str) -> List[int]:
        # NOTE: verbatim — no newline munging here. The cross-encoder prompts
        # contain literal \n that must tokenize exactly (sgptce.py:74); the
        # bi-encoder path's newline→space cleanup happens in SpecbCodec.encode
        # (matching where the reference does it, beir_dense_retriever.py:170).
        tokens = self.tok.tokenize(text)
        return self.tok.convert_tokens_to_ids(tokens)

    def encode_batch(self, texts: Sequence[str]) -> List[List[int]]:
        """Batched encode: the fast (Rust) tokenizer parallelizes across host
        cores in one call — the ids are identical to per-text encode (no
        special tokens added either way). Slow tokenizers loop."""
        if not getattr(self.tok, "is_fast", False):
            return [self.encode(t) for t in texts]
        return self.tok(list(texts), add_special_tokens=False)["input_ids"]

    def bracket_ids(self, bracket: str) -> List[int]:
        return self.tok.encode(bracket)


def get_tokenizer(name_or_path: Optional[str] = None, *,
                  fallback: bool = True,
                  vocab_size: Optional[int] = None) -> Tokenizer:
    """HF tokenizer if loadable from a local path/cache, else SimpleTokenizer.

    fallback=False raises TokenizerLoadError instead of falling back - REQUIRED
    whenever real model weights were loaded (a hash tokenizer would silently
    mis-encode everything; see build_model). Loaded GPT-2-family tokenizers are
    preflighted against the reference's hardcoded bracket ids either way.

    vocab_size bounds the hash-fallback tokenizer to the MODEL's vocab — the
    50257 default overruns smaller embedding tables (T5: 32128), and the
    out-of-range gather is silent garbage/NaN, not an error.
    """
    if name_or_path:
        try:
            from transformers import AutoTokenizer
            tok = HFTokenizer(AutoTokenizer.from_pretrained(name_or_path))
        except Exception as e:
            if not fallback:
                raise TokenizerLoadError(
                    f"could not load HF tokenizer {name_or_path!r} ({e!r}); "
                    "refusing to fall back to the hash tokenizer because real "
                    "weights are in play - pass fallback=True only for "
                    "random-init/smoke runs") from e
            logger.warning(
                "FALLING BACK to the hash-bucket SimpleTokenizer: HF tokenizer "
                "%r failed to load (%r). Embeddings/scores from this run are "
                "NOT comparable to published numbers.", name_or_path, e)
            return SimpleTokenizer(vocab_size or 50257)
        check_specb_brackets(tok, name_or_path)
        return tok
    return SimpleTokenizer(vocab_size or 50257)
