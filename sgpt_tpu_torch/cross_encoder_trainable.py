"""Trainable cross-encoder (counterpart of `sgpt_tpu/cross_encoder_trainable.py`).

The sentence-transformers CrossEncoder's trainable surface: a decoder scores
each concatenated (sentence1, sentence2) pair through a classification head,
trained with cross-entropy (num_labels > 1) or the logistic loss
(num_labels == 1), and five evaluators. Pairs tokenize as [s1; EOS; s2]
under longest-first truncation, the last token's state goes through the
linear head in fp32; the whole model and the head train with optax's AdamW
defaults (weight decay 1e-4 on every leaf) after a global-norm clip at 1.0,
on a warmup-linear schedule over ceil(len/B)·epochs steps.

Every training batch pads to `max_length` (2,048 at GPT-Neo's default), so
on the card each layer runs K1 forward and K2 backward at (B, max_length);
`predict` pads each batch to its length bucket and runs K1 alone.
"""
from __future__ import annotations

import logging
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .models.config import DecoderConfig
from .models.decoder import Decoder, check_token_ids
from .models.precision import matmul_precision
from .ops.pooling import last_token_pool
from .tokenization.base import Tokenizer
from .tokenization.specb import DEFAULT_BUCKETS, pick_bucket
from .training.schedules import make_schedule
from .training.trainer import clip_by_global_norm

logger = logging.getLogger(__name__)


def _pair_logits(model: Decoder, head_w: torch.Tensor, head_b: torch.Tensor,
                 ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, T) pair rows → (B, num_labels) fp32 logits: the last token's
    state, in fp32, through the head."""
    rep = last_token_pool(model(ids, mask), mask)
    return rep.float() @ head_w + head_b


def _pair_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's sigmoid_binary_cross_entropy (one output) or
    softmax_cross_entropy_with_integer_labels (several), batch mean."""
    if logits.shape[1] == 1:
        x, y = logits[:, 0], labels.float()
        return (-y * F.logsigmoid(x) - (1.0 - y) * F.logsigmoid(-x)).mean()
    return -torch.log_softmax(logits, -1).gather(1, labels.long()[:, None]).mean()


class CrossEncoderTrainable:
    def __init__(self, model: Decoder, cfg: DecoderConfig, tokenizer: Tokenizer, *,
                 num_labels: int = 1, max_length: Optional[int] = None,
                 batch_size: int = 16, seed: int = 0):
        """model: the port's `Decoder`, on the device to train and score on.
        The head is w (D, num_labels) 0.02·N(0, 1) from a host generator
        seeded with `seed` (the JAX class draws from a JAX key: parity checks
        carry its head over, `models.head_from_jax`) and b zeros, fp32."""
        if model.cfg != cfg:
            raise ValueError("CrossEncoderTrainable: cfg differs from the model's config")
        self.model = model
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.num_labels = num_labels
        self.max_length = max_length or cfg.max_position_embeddings
        self.batch_size = batch_size
        self.device = next(model.parameters()).device
        gen = torch.Generator().manual_seed(seed)
        self.head_w = (0.02 * torch.randn((cfg.hidden_size, num_labels), generator=gen)
                       ).to(self.device)
        self.head_b = torch.zeros((num_labels,), device=self.device)

    # ------------------------------------------------------------------
    def _tokenize_pairs(self, pairs: Sequence[Tuple[str, str]], pad_to=None):
        rows = []
        budget = self.max_length - 1  # one slot for the EOS separator
        for s1, s2 in pairs:
            ids1 = self.tokenizer.encode(s1)
            ids2 = self.tokenizer.encode(s2)
            # longest-first truncation, as the ST CrossEncoder's tokenizer
            # call: in closed form the trim-the-longer pop loop (ties pop s2)
            # keeps the shorter side whole; if both exceed half the budget
            # they meet at ceil/floor of budget/2
            a, b = len(ids1), len(ids2)
            if a + b > budget:
                a = min(a, max((budget + 1) // 2, budget - b))
                b = budget - a
            rows.append(ids1[:a] + [self.tokenizer.eos_id] + ids2[:b])
        maxlen = max(len(r) for r in rows)
        T = pad_to or max(pick_bucket(maxlen, DEFAULT_BUCKETS, self.max_length), maxlen)
        ids = np.full((len(rows), T), self.tokenizer.pad_id, np.int64)
        mask = np.zeros((len(rows), T), np.int32)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        check_token_ids(ids, self.cfg.vocab_size)
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device))

    def _logits(self, ids, mask) -> torch.Tensor:
        with matmul_precision(self.cfg.matmul_precision):
            return _pair_logits(self.model, self.head_w, self.head_b, ids, mask)

    @torch.no_grad()
    def predict(self, pairs: Sequence[Tuple[str, str]], apply_softmax: bool = False,
                **kw) -> np.ndarray:
        """num_labels == 1 → sigmoid scores (ST convention); else logits or,
        with apply_softmax, probabilities. A short last batch pads with
        empty pairs to the batch size, as the JAX class does."""
        if len(pairs) == 0:
            shape = (0,) if self.num_labels == 1 else (0, self.num_labels)
            return np.zeros(shape, np.float64)
        out = []
        B = self.batch_size
        for s in range(0, len(pairs), B):
            chunk = list(pairs[s: s + B])
            ids, mask = self._tokenize_pairs(chunk + [("", "")] * (B - len(chunk)))
            logits = self._logits(ids, mask)[: len(chunk)]
            out.append(logits.cpu().numpy().astype(np.float64))
        logits = np.concatenate(out, axis=0)
        if self.num_labels == 1:
            return 1.0 / (1.0 + np.exp(-logits[:, 0]))
        if apply_softmax:
            e = np.exp(logits - logits.max(-1, keepdims=True))
            return e / e.sum(-1, keepdims=True)
        return logits

    # ------------------------------------------------------------------
    def _build_optimizer(self, total_steps: int, lr: float, warmup_ratio: float):
        """AdamW as optax.adamw's defaults (weight decay 1e-4 on every leaf,
        the head included) with base lr 1, so that LambdaLR's factor is the
        warmup-linear schedule's lr."""
        schedule = make_schedule("warmuplinear", lr, int(warmup_ratio * total_steps),
                                 total_steps)
        for p in self.model.parameters():
            p.requires_grad_(True)
        for t in (self.head_w, self.head_b):
            t.requires_grad_(True)
        params = [*self.model.parameters(), self.head_w, self.head_b]
        opt = torch.optim.AdamW(params, lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)

    def _prep(self, batch) -> tuple:
        """InputExample-likes → (ids, mask, labels) on the device, every row
        padded to max_length."""
        ids, mask = self._tokenize_pairs([tuple(ex.texts[:2]) for ex in batch],
                                         pad_to=self.max_length)
        dtype = torch.float32 if self.num_labels == 1 else torch.int64
        labels = torch.tensor([ex.label for ex in batch], dtype=dtype, device=self.device)
        return ids, mask, labels

    def _step(self, opt, sched, ids, mask, labels) -> torch.Tensor:
        """One update; the loss as a device scalar. The backward's products
        run outside `Decoder.forward`, so the whole step takes the model's
        `matmul_precision`."""
        opt.zero_grad(set_to_none=True)
        with matmul_precision(self.cfg.matmul_precision):
            loss = _pair_loss(_pair_logits(self.model, self.head_w, self.head_b, ids, mask),
                              labels)
            loss.backward()
        clip_by_global_norm([p for g in opt.param_groups for p in g["params"]], 1.0)
        opt.step()
        sched.step()
        return loss.detach()

    def fit(self, train_samples: Sequence, *, epochs: int = 1, lr: float = 2e-5,
            warmup_ratio: float = 0.1, evaluator: Optional[Callable] = None,
            shuffle_seed: int = 0) -> List[dict]:
        """train_samples: InputExample-likes with .texts=(s1, s2) and .label.
        Each epoch shuffles them with np.random.default_rng(shuffle_seed), as
        the JAX class does, and a partial last batch is padded with the
        first samples. Returns the history: {"epoch", "loss"} a step and
        {"epoch", "eval_score"} after each epoch with an evaluator."""
        B = self.batch_size
        # ceil: the loop runs ceil(len/B) steps an epoch
        total = max(1, -(-len(train_samples) // B)) * epochs
        opt, sched = self._build_optimizer(total, lr, warmup_ratio)
        rng = np.random.default_rng(shuffle_seed)
        history = []
        samples = list(train_samples)
        self.model.train()
        for epoch in range(epochs):
            rng.shuffle(samples)
            for s in range(0, len(samples), B):
                batch = samples[s: s + B]
                if len(batch) < B:  # partial batch: pad with repeats (static shapes)
                    batch = batch + samples[: B - len(batch)]
                loss = self._step(opt, sched, *self._prep(batch))
                history.append({"epoch": epoch, "loss": float(loss)})
            if evaluator:
                score = float(evaluator(self))
                history.append({"epoch": epoch, "eval_score": score})
                logger.info("epoch %d eval %.4f", epoch, score)
        return history


class CECorrelationEvaluator:
    """Spearman between predicted pair scores and gold (ST CECorrelationEvaluator)."""

    def __init__(self, pairs: Sequence[Tuple[str, str]], scores: Sequence[float]):
        self.pairs, self.gold = list(pairs), list(scores)

    def __call__(self, model: CrossEncoderTrainable) -> float:
        from .evaluation.metrics import spearman
        pred = model.predict(self.pairs)
        pred = pred if pred.ndim == 1 else pred[:, -1]
        return spearman(pred.tolist(), self.gold)


class CEBinaryClassificationEvaluator:
    """Best-threshold accuracy over predicted scores (the ST fork's
    CEBinaryClassificationEvaluator picks the threshold itself); the
    fixed-threshold variant is CEBinaryAccuracyEvaluator."""

    def __init__(self, pairs: Sequence[Tuple[str, str]], labels: Sequence[int]):
        self.pairs, self.labels = list(pairs), np.asarray(labels, int)

    def __call__(self, model: CrossEncoderTrainable) -> float:
        pred = model.predict(self.pairs)
        pred = pred if pred.ndim == 1 else pred[:, -1]
        best = 0.0
        # a threshold above max(pred) too: the all-negative classification
        thresholds = np.concatenate([np.unique(pred), [pred.max() + 1.0]])
        for t in thresholds:
            best = max(best, float(np.mean((pred >= t).astype(int) == self.labels)))
        return best


class CEBinaryAccuracyEvaluator:
    """Fixed-threshold accuracy of a one-output cross-encoder (ST
    CEBinaryAccuracyEvaluator: predict > threshold against the gold labels,
    0.5 on the sigmoid scores by default)."""

    def __init__(self, pairs: Sequence[Tuple[str, str]], labels: Sequence[int],
                 threshold: float = 0.5):
        self.pairs, self.labels = list(pairs), np.asarray(labels, int)
        self.threshold = threshold

    def __call__(self, model: CrossEncoderTrainable) -> float:
        pred = model.predict(self.pairs)
        pred = pred if pred.ndim == 1 else pred[:, -1]
        return float(np.mean((pred > self.threshold).astype(int) == self.labels))


class CESoftmaxAccuracyEvaluator:
    """Argmax accuracy of a multi-output cross-encoder (ST
    CESoftmaxAccuracyEvaluator)."""

    def __init__(self, pairs: Sequence[Tuple[str, str]], labels: Sequence[int]):
        self.pairs, self.labels = list(pairs), np.asarray(labels, int)

    def __call__(self, model: CrossEncoderTrainable) -> float:
        logits = model.predict(self.pairs)
        if logits.ndim != 2:
            raise ValueError("CESoftmaxAccuracyEvaluator needs a multi-output "
                             "model (num_labels >= 2)")
        return float(np.mean(np.argmax(logits, axis=1) == self.labels))


class CERerankingEvaluator:
    """Mean MRR@k over rerank samples (ST CERerankingEvaluator). Each sample
    is {'query': str, 'positive': [docs], 'negative': [docs]}; samples
    missing either side are skipped, as the reference does. Every (query,
    doc) pair of every sample is scored in one `predict` call."""

    def __init__(self, samples, mrr_at_k: int = 10):
        if isinstance(samples, dict):
            samples = list(samples.values())
        self.samples = [s for s in samples if s["positive"] and s["negative"]]
        self.mrr_at_k = mrr_at_k

    def __call__(self, model) -> float:
        if not self.samples:
            return 0.0
        pairs, spans = [], []
        for s in self.samples:
            docs = list(s["positive"]) + list(s["negative"])
            spans.append((len(pairs), len(pairs) + len(docs), len(s["positive"])))
            pairs.extend((s["query"], d) for d in docs)
        pred = model.predict(pairs)
        pred = pred if pred.ndim == 1 else pred[:, -1]
        mrrs = []
        for lo, hi, n_pos in spans:
            order = np.argsort(-pred[lo:hi], kind="stable")
            mrr = 0.0
            for rank, idx in enumerate(order[: self.mrr_at_k]):
                if idx < n_pos:
                    mrr = 1.0 / (rank + 1)
                    break
            mrrs.append(mrr)
        return float(np.mean(mrrs))
