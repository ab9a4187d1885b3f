"""The reference's tokenization: the hash word tokenizer, SGPT's SPECB
framing with truncation, and SGPT-CE's prompt G with its instruction-keeping
left truncation. Frozen copies of the published recipes (SGPT's
`beir_dense_retriever.py` and `sgptce.py`), written here so that the
reference reads nothing of the program.

Every id of the hash tokenizer is one whitespace-separated word: ids 0-5 are
reserved (0 pad, 1 eos, 2-5 the brackets `[ ] { }`), a word maps to 6 +
md5(word.lower())[:4] (little-endian) mod (vocab − 6).
"""
from __future__ import annotations

import hashlib
from typing import List, Tuple

N_RESERVED = 6
BRACKETS = {"[": 2, "]": 3, "{": 4, "}": 5}

PROMPT_G = ('Documents are searched to find matches with the same content.\n'
            'The document "{}" is a good search result for "')


def hash_ids(text: str, vocab: int) -> List[int]:
    out = []
    for w in text.split():
        h = int.from_bytes(hashlib.md5(w.lower().encode()).digest()[:4], "little")
        out.append(N_RESERVED + h % (vocab - N_RESERVED))
    return out


def doc_text(doc) -> str:
    """A BEIR document's text as the bi-encoder and SGPT-CE read it."""
    if isinstance(doc, str):
        return doc
    return (doc.get("title", "") + " " + doc.get("text", "")).strip()


def specb_row(text: str, vocab: int, max_seq_len: int, is_query: bool) -> List[int]:
    """SPECB: the body truncated to max_seq_len − 2 tokens, then `[`…`]`
    around a query, `{`…`}` around a document; newlines read as spaces."""
    body = hash_ids(text.replace("\n", " "), vocab)[:max_seq_len - 2]
    bos, eos = ("[", "]") if is_query else ("{", "}")
    return [BRACKETS[bos]] + body + [BRACKETS[eos]]


def specb_len(text: str, max_seq_len: int) -> int:
    """len(specb_row(...)) without hashing: one token a word."""
    return min(len(text.split()), max_seq_len - 2) + 2


def ce_row(query: str, doc: str, vocab: int, max_length: int) -> Tuple[List[int], List[int]]:
    """SGPT-CE's (input row, continuation) for a (query, document) pair under
    prompt G: context = the prompt around the document, continuation = the
    query; the input is (context + continuation)[:-1], left-truncated to
    max_length tokens, keeping the instruction before the document."""
    ctx = hash_ids(PROMPT_G.format(doc), vocab)
    cont = hash_ids(query, vocab)
    ilen = min(len(PROMPT_G[:PROMPT_G.index("{")].split()), len(ctx))
    if ilen + len(cont) > max_length + 1:
        raise ValueError("continuation longer than the room after the instruction")
    body = (ctx[ilen:] + cont)[-(max_length + 1 - ilen):]
    return (ctx[:ilen] + body)[:-1], cont


def ce_len(query: str, doc: str, max_length: int) -> Tuple[int, int]:
    """(input tokens, continuation tokens) of `ce_row` without hashing."""
    n_ctx = len(PROMPT_G.format(doc).split())
    n_cont = len(query.split())
    ilen = min(len(PROMPT_G[:PROMPT_G.index("{")].split()), n_ctx)
    body = min(n_ctx - ilen + n_cont, max_length + 1 - ilen)
    return ilen + body - 1, n_cont
