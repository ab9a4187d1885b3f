"""SGPT-CE prompt ablation registry.

The port's own copy of `sgpt_tpu/ce_prompts.py`, with the same registry and
shot selection: the port imports nothing of the JAX package. `build_ranker`
builds the port's rankers (`crossencoder.py`) on a `Decoder`.

The full prompt library from the reference's ablation study
(crossencoder/beir/crossencoder_beir_sgpt.ipynb, cells 10-17; the main paper
prompt "G" also lives at crossencoder/beir/sgptce.py:74):

  * A-I      zero-shot prompts — one {} slot for the document, the query is
             the scored continuation,
  * quoraA-D Quora-specific zero-shot ablations,
  * J, K, quoraE  few-shot prompts — (prompt_doc_start, prompt_doc) pairs:
             the start wraps the few-shot (doc, query) example once, the base
             wraps each scored document,
  * L, M     Yes/No classifier prompts (GPTYesRanker): two slots (doc, query),
             score = log P(continuation) with softmax restricted to the
             {Yes, No} vocabulary; M is the trailing-space variant.

`build_ranker` turns a prompt id into a ready CrossEncoderRanker/YesNoRanker;
`select_fewshot` reproduces the notebook's shortest-match shot selection
(get_match_len, cells 11/17).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

ZERO_SHOT: Dict[str, str] = {
    "A": "{} ",
    "B": "{}\n",
    "C": "Document:\n{}\n\nQuery:\n",
    "D": "Body:{}\n\nTitle:\n",
    "E": "selected document:\n{}\n\nrelevant query:\n",
    "F": "The selected text is:\n{}\n\nThe relevant query is:\n",
    "G": ('Documents are searched to find matches with the same content.\n'
          'The document "{}" is a good search result for "'),
    "H": ('Documents are searched to find matches with the same content.\n'
          'Document: "{}"\n\nThe above document is a good match for the '
          'query: "'),
    "I": ('# Get matching document and query with the same content\n'
          'get_document()\n{}\nget_query_matching_document()\n"'),
    # Quora ablations (run with --dataset quora)
    "quoraA": ('Questions are searched to find matches with the same '
               'content.\nThe question "{}" is a good search result for "'),
    "quoraB": ('Below are two similar questions asking the same thing.\n'
               'The question "{}" is similar to "'),
    "quoraC": "These two questions are the same: 1. {} 2.",
    "quoraD": "Question Body: {} Question Title:",
}

# id -> (prompt_doc_start with two slots, per-request prompt_doc)
FEW_SHOT: Dict[str, Tuple[str, str]] = {
    "J": ("Documents are searched to find matches with the same content.\n"
          "Document:\n{}\nQuery:\n{}\n", "Document:\n{}\nQuery:\n"),
    "K": ("Document:\n{}\nQuery:\n{}\n", "Document:\n{}\nQuery:\n"),
    "quoraE": ("Question Body: {} Question Title: {}\n",
               "Question Body: {} Question Title:"),
}

# id -> (prompt_start incl. instruction, per-request base prompt,
#        continuation, sub_select_voc)
YES_NO: Dict[str, Tuple[str, str, str, Tuple[str, str]]] = {
    "L": ('An intelligent, helpful bot is given. The bot responds "Yes" if '
          'the document is a fit to the query and "No" otherwise.\n###\n'
          'Document: {}\nQuery: {}\nBot:',
          "\nDocument: {}\nQuery: {}\nBot:", " Yes", (" Yes", " No")),
    "M": ('An intelligent, helpful bot is given. The bot responds "Yes" if '
          'the document is a fit to the query and "No" otherwise.\n###\n'
          'Document: {}\nQuery: {}\nBot: ',
          "\nDocument: {}\nQuery: {}\nBot: ", "Yes", ("Yes", "No")),
}

ALL_PROMPT_IDS = sorted([*ZERO_SHOT, *FEW_SHOT, *YES_NO])


def select_fewshot(corpus: dict, queries: dict, qrels: dict, tokenizer,
                   min_corp_query_len: int = 0) -> Tuple[str, str]:
    """Pick the (doc, query) few-shot example: the relevant pair with the
    smallest token length (score-weighted), per the notebook's get_match_len.
    min_corp_query_len: skip degenerate short pairs (the Quora guard)."""
    best = None
    for qid, rels in qrels.items():
        if qid not in queries:
            continue
        qlen = len(tokenizer.encode(queries[qid]))
        for did, score in rels.items():
            if did not in corpus:
                continue
            dlen = len(tokenizer.encode(corpus[did].get("text", "")))
            total = dlen + qlen
            if total <= min_corp_query_len:
                continue
            weighted = total / (score + 1e-10)
            if best is None or weighted < best[0]:
                best = (weighted, did, qid)
    if best is None:
        raise ValueError("no usable (doc, query) pair in qrels")
    _, did, qid = best
    return corpus[did].get("text", ""), queries[qid]


def build_ranker(prompt_id: str, model, cfg, tokenizer, *,
                 fewshots: Optional[Tuple[str, str]] = None, **kw):
    """Construct the right ranker for a prompt id (CLI: --prompt A|...|M).

    Few-shot prompts (J/K/quoraE) REQUIRE fewshots=(doc, query); zero-shot
    prompts ignore it unless explicitly provided (prompt_doc_start then
    defaults to the reference's '{}\\n{}\\n'). model: the port's
    `Decoder`; keywords (device, batch_size, max_length, pack_t, ...) go to
    the ranker."""
    from .crossencoder import CrossEncoderRanker, YesNoRanker

    if prompt_id in YES_NO:
        start, base, continuation, voc = YES_NO[prompt_id]
        if fewshots is not None:
            return YesNoRanker(model, cfg, tokenizer, prompt_doc=base,
                               prompt_doc_start=start, fewshots=fewshots,
                               continuation=continuation,
                               sub_select_voc=voc, **kw)
        return YesNoRanker(model, cfg, tokenizer, prompt_doc=start,
                           continuation=continuation, sub_select_voc=voc, **kw)
    if prompt_id in FEW_SHOT:
        start, base = FEW_SHOT[prompt_id]
        if fewshots is None:
            raise ValueError(
                f"prompt {prompt_id!r} is a few-shot ablation — pass "
                f"fewshots=(doc, query) (CLI: --fewshot)")
        return CrossEncoderRanker(model, cfg, tokenizer, prompt_doc=base,
                                  prompt_doc_start=start, fewshots=fewshots,
                                  **kw)
    if prompt_id in ZERO_SHOT:
        return CrossEncoderRanker(model, cfg, tokenizer,
                                  prompt_doc=ZERO_SHOT[prompt_id],
                                  fewshots=fewshots, **kw)
    raise ValueError(f"unknown prompt id {prompt_id!r}; choose from "
                     f"{ALL_PROMPT_IDS}")
