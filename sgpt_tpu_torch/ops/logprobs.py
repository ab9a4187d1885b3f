"""Batched continuation log-probability scoring, the SGPT-CE scorer
(counterpart of `sgpt_tpu/ops/logprobs.py`).

Decoder forward → LM head → log-softmax in fp32 → the continuation tokens'
log-probs → masked sum, in the JAX functions' order: the vocab mask as
where(mask, logits, -inf), then the log-softmax, then the gather, then
where(target_mask, ·, 0) (not a product: with a vocab mask a masked target
is -inf, and -inf·0 is NaN), then an fp32 sum. The model is the port's
`Decoder`; attention goes through its kernels (K1 on the card), the rest is
plain PyTorch, as the JAX package computes it in XLA.

The log-softmax is taken as logit[target] − logsumexp(logits), with the
logsumexp computed in place in the fp32 logits: one (B, C, V) fp32 tensor
at a time, where log_softmax would hold a second.
"""
from __future__ import annotations

from typing import Optional

import torch


def _token_logprobs(model, hidden, targets, vocab_mask: Optional[torch.Tensor]):
    """log P(targets | ·) at each position of hidden (..., D) → (...) fp32."""
    lg = model.logits(hidden).float()  # a fresh tensor: the in-place ops are safe
    if vocab_mask is not None:
        lg.masked_fill_(~vocab_mask, float("-inf"))
    tok = lg.gather(-1, targets[..., None].long())[..., 0]
    m = lg.amax(-1, keepdim=True)
    lse = lg.sub_(m).exp_().sum(-1).log_() + m[..., 0]
    return tok - lse


def _gather_positions(h, positions):
    """h (B, T, D) at positions (B, C) → (B, C, D)."""
    return h.gather(1, positions[..., None].long().expand(-1, -1, h.shape[-1]))


def _masked_sum(tok_lp, mask):
    return torch.where(mask.bool(), tok_lp, torch.zeros((), device=tok_lp.device)).sum(1)


@torch.inference_mode()
def continuation_scores(model, input_ids, attention_mask, targets, target_mask,
                        vocab_mask: Optional[torch.Tensor] = None):
    """Sum of log P(target_t | prefix) over positions where target_mask == 1.

    input_ids, attention_mask: (B, T) the packed (context + continuation)[:-1]
    rows; targets: (B, T) token ids to score at each position (shifted by
    one); target_mask: (B, T) 1 on continuation positions; vocab_mask:
    optional (V,) bool that restricts the softmax to a vocab subset.
    Returns (B,) fp32."""
    h = model(input_ids, attention_mask)
    return _masked_sum(_token_logprobs(model, h, targets, vocab_mask), target_mask)


@torch.inference_mode()
def continuation_scores_gathered(model, input_ids, attention_mask, cont_positions,
                                 cont_targets, cont_mask,
                                 vocab_mask: Optional[torch.Tensor] = None):
    """`continuation_scores` with the LM head applied only at the scored
    positions: the hidden states are gathered to the (B, C) continuation
    windows before the head, so the (B, T, V) logits never exist.

    cont_positions: (B, C) input positions whose next-token log-probs are
    scored (in range also on padding slots); cont_targets, cont_mask: (B, C).
    Returns (B,) fp32."""
    h = model(input_ids, attention_mask)
    hc = _gather_positions(h, cont_positions)
    return _masked_sum(_token_logprobs(model, hc, cont_targets, vocab_mask), cont_mask)


@torch.inference_mode()
def continuation_scores_packed(model, input_ids, attention_mask, position_ids,
                               segment_ids, cont_positions, cont_targets, cont_mask,
                               cont_seg, n_seg: int,
                               vocab_mask: Optional[torch.Tensor] = None):
    """Per-segment continuation scores of sequence-packed rows: several
    (context, continuation) requests share a row, attention is
    block-diagonal over `segment_ids` and positions restart in each
    segment, so each segment scores as its own row would.

    cont_seg: (B, C) the segment slot in [0, n_seg) of each continuation
    slot (padding slots have cont_mask 0; a slot value outside the range
    counts for no segment, as JAX's one_hot gives it a zero row). Returns
    (B, n_seg) fp32; unused segment slots sum to 0."""
    h = model(input_ids, attention_mask, position_ids=position_ids,
              segment_ids=segment_ids)
    hc = _gather_positions(h, cont_positions)
    tok_lp = _token_logprobs(model, hc, cont_targets, vocab_mask)
    tok_lp = torch.where(cont_mask.bool(), tok_lp, torch.zeros((), device=tok_lp.device))
    onehot = cont_seg[..., None] == torch.arange(n_seg, device=cont_seg.device)
    # a product and a sum, not a contraction: TF32 may not round the scores
    return (tok_lp[..., None] * onehot).sum(1)


@torch.inference_mode()
def greedy_continuations(model, input_ids, attention_mask):
    """Argmax next-token ids (B, T), for greedy-match diagnostics."""
    return model.logits(model(input_ids, attention_mask)).argmax(-1)
