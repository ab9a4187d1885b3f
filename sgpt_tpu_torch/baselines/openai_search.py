"""OpenAI search-endpoint scoring replica.

Re-build of crossencoder/beir/openai_search_endpoint_functionality.py:16-79:
score(query, doc) = mean per-token log-prob of the query continuation under the
prompt '<|endoftext|>{doc}\\n\\n---\\n\\nThe above passage is related to: {query}'
× 100, minus the empty-document calibration score.

The completion client is injected: `complete_fn(prompts) -> list of
{"token_logprobs": [...], "text_offset": [...]}` (echo-mode logprobs).

The port's own copy of `sgpt_tpu/baselines/openai_search.py`, with the same
behaviour: the port imports nothing of the JAX package.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

SCORE_MULTIPLIER = 100.0


def construct_context(query: str, document: str) -> str:
    return ("<|endoftext|>{document}\n\n---\n\nThe above passage is related to: "
            "{query}").format(document=document, query=query)


def get_score(context: str, query: str, log_probs: Sequence[float],
              text_offsets: Sequence[int]) -> float:
    """Mean log-prob over the trailing tokens that cover the query span."""
    log_prob = 0.0
    count = 0
    cutoff = len(context) - len(query)
    for i in range(len(text_offsets) - 1, 0, -1):
        log_prob += log_probs[i]
        count += 1
        if text_offsets[i] <= cutoff and text_offsets[i] != text_offsets[i - 1]:
            break
    return log_prob / float(count) * SCORE_MULTIPLIER


def openai_search(query: str, documents: Sequence[str],
                  complete_fn: Callable[[Sequence[str]], List[Dict]]) -> List[Dict]:
    """Returns [{'document': idx, 'score': float}] with empty-doc calibration."""
    prompts = [construct_context(query, doc) for doc in ["", *documents]]
    choices = complete_fn(prompts)
    scores = [
        get_score(prompts[i], query, c["token_logprobs"], c["text_offset"])
        for i, c in enumerate(choices)
    ]
    calibrated = [s - scores[0] for s in scores[1:]]
    return [{"object": "search_result", "document": i, "score": round(s, 3)}
            for i, s in enumerate(calibrated)]
