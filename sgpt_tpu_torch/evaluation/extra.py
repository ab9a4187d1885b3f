"""Remaining evaluator surface of the ST fork (sentence_transformers/evaluation/):

The port's own copy of `sgpt_tpu/evaluation/extra.py`, with the same behaviour: the
port imports nothing of the JAX package.
Triplet, BinaryClassification, Reranking, MSE, Translation, Sequential.
Each takes an `encode_fn(list[str]) -> (N, D)` and returns its main score
(higher is better), with `.compute()` for the full metric dict.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .metrics import mrr_at_k, map_at_k

logger = logging.getLogger(__name__)


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / np.clip(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12, None)


class TripletEvaluator:
    """Fraction of triplets where d(a, p) < d(a, n) (cosine distance)."""

    def __init__(self, anchors: Sequence[str], positives: Sequence[str],
                 negatives: Sequence[str], name: str = ""):
        self.anchors, self.positives, self.negatives = (
            list(anchors), list(positives), list(negatives))
        self.name = name

    def __call__(self, encode_fn) -> float:
        a = _normalize(np.asarray(encode_fn(self.anchors), np.float64))
        p = _normalize(np.asarray(encode_fn(self.positives), np.float64))
        n = _normalize(np.asarray(encode_fn(self.negatives), np.float64))
        return float(np.mean(np.sum(a * p, -1) > np.sum(a * n, -1)))


class BinaryClassificationEvaluator:
    """Is a pair a duplicate? Best-threshold accuracy + F1 + AP over cosine."""

    def __init__(self, sentences1, sentences2, labels, name: str = ""):
        self.s1, self.s2 = list(sentences1), list(sentences2)
        self.labels = np.asarray(labels, int)
        self.name = name

    def compute(self, encode_fn) -> Dict[str, float]:
        e1 = _normalize(np.asarray(encode_fn(self.s1), np.float64))
        e2 = _normalize(np.asarray(encode_fn(self.s2), np.float64))
        scores = np.sum(e1 * e2, -1)
        order = np.argsort(-scores)
        y = self.labels[order]
        n_pos = int(y.sum())

        # best accuracy over thresholds
        best_acc, best_f1 = 0.0, 0.0
        tp = 0
        for i in range(len(y) + 1):
            if i > 0:
                tp += y[i - 1]
            fp = i - tp
            fn = n_pos - tp
            tn = len(y) - i - fn
            acc = (tp + tn) / len(y)
            prec = tp / i if i else 0.0
            rec = tp / n_pos if n_pos else 0.0
            f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
            best_acc, best_f1 = max(best_acc, acc), max(best_f1, f1)

        hits = np.cumsum(y)
        precs = hits / np.arange(1, len(y) + 1)
        ap = float((precs * y).sum() / n_pos) if n_pos else 0.0
        return {"accuracy": best_acc, "f1": best_f1, "ap": ap}

    def __call__(self, encode_fn) -> float:
        return self.compute(encode_fn)["ap"]


class RerankingEvaluator:
    """samples: [{'query', 'positive': [...], 'negative': [...]}] → mean MRR@10/MAP."""

    def __init__(self, samples: Sequence[dict], mrr_at: int = 10, name: str = ""):
        self.samples = [s for s in samples if s["positive"] and s["negative"]]
        self.mrr_at = mrr_at
        self.name = name

    def compute(self, encode_fn) -> Dict[str, float]:
        mrrs, maps = [], []
        for s in self.samples:
            docs = list(s["positive"]) + list(s["negative"])
            q = _normalize(np.asarray(encode_fn([s["query"]]), np.float64))[0]
            d = _normalize(np.asarray(encode_fn(docs), np.float64))
            scores = d @ q
            qrels = {"q": {f"d{i}": 1 for i in range(len(s["positive"]))}}
            results = {"q": {f"d{i}": float(v) for i, v in enumerate(scores)}}
            mrrs.append(mrr_at_k(qrels, results, self.mrr_at))
            maps.append(map_at_k(qrels, results, len(docs)))
        return {"mrr": float(np.mean(mrrs)), "map": float(np.mean(maps))}

    def __call__(self, encode_fn) -> float:
        return self.compute(encode_fn)["map"]


class MSEEvaluator:
    """Negative MSE (×100) between student embeddings and teacher targets."""

    def __init__(self, sentences: Sequence[str], teacher_embeddings, name: str = ""):
        self.sentences = list(sentences)
        self.teacher = np.asarray(teacher_embeddings, np.float64)
        self.name = name

    def __call__(self, encode_fn) -> float:
        student = np.asarray(encode_fn(self.sentences), np.float64)
        return float(-np.mean((student - self.teacher) ** 2) * 100)


class TranslationEvaluator:
    """Bitext alignment accuracy: src_i's nearest neighbor among targets is tgt_i."""

    def __init__(self, source: Sequence[str], target: Sequence[str], name: str = ""):
        assert len(source) == len(target)
        self.source, self.target = list(source), list(target)
        self.name = name

    def compute(self, encode_fn) -> Dict[str, float]:
        s = _normalize(np.asarray(encode_fn(self.source), np.float64))
        t = _normalize(np.asarray(encode_fn(self.target), np.float64))
        scores = s @ t.T
        acc_src = float(np.mean(np.argmax(scores, axis=1) == np.arange(len(s))))
        acc_tgt = float(np.mean(np.argmax(scores, axis=0) == np.arange(len(t))))
        return {"src2tgt": acc_src, "tgt2src": acc_tgt,
                "mean": (acc_src + acc_tgt) / 2}

    def __call__(self, encode_fn) -> float:
        return self.compute(encode_fn)["mean"]


class LabelAccuracyEvaluator:
    """Argmax accuracy of a SoftmaxLoss classification head over labeled pairs
    — the ST fork's evaluation/LabelAccuracyEvaluator.py ("requires a model
    with LossFunction.SOFTMAX"). Functional form: __call__ takes
    `classify_fn(sentences1, sentences2) -> (N, num_labels) logits`; build one
    from an encode_fn plus the trained softmax_loss head with
    `softmax_head_classifier` (same [u; v; |u-v|] @ W features as
    losses.softmax_loss)."""

    def __init__(self, sentences1: Sequence[str], sentences2: Sequence[str],
                 labels: Sequence[int], name: str = ""):
        assert len(sentences1) == len(sentences2) == len(labels)
        self.s1, self.s2 = list(sentences1), list(sentences2)
        self.labels = np.asarray(labels, int)
        self.name = name

    @staticmethod
    def softmax_head_classifier(encode_fn, classifier_w, classifier_b=None):
        w = np.asarray(classifier_w, np.float64)
        b = None if classifier_b is None else np.asarray(classifier_b, np.float64)

        def classify(s1: Sequence[str], s2: Sequence[str]) -> np.ndarray:
            u = np.asarray(encode_fn(list(s1)), np.float64)
            v = np.asarray(encode_fn(list(s2)), np.float64)
            logits = np.concatenate([u, v, np.abs(u - v)], axis=-1) @ w
            return logits if b is None else logits + b

        return classify

    def __call__(self, classify_fn) -> float:
        logits = np.asarray(classify_fn(self.s1, self.s2))
        return float(np.mean(np.argmax(logits, axis=1) == self.labels))


class MSEEvaluatorFromDataFrame:
    """Multilingual distillation MSE over parallel rows — the ST fork's
    evaluation/MSEEvaluatorFromDataFrame.py. `rows` is a list of
    {lang: sentence} dicts; `combinations` is [(src_lang, trg_lang), ...].
    Teacher embeddings of the (deduped) source sentences are computed once at
    construction; __call__(encode_fn) embeds each combination's target
    sentences with the student and returns -mean(MSE x100) (higher is better,
    matching the reference's negated return). Rows where either side is
    empty/whitespace are skipped, as upstream."""

    def __init__(self, rows: Sequence[Dict[str, str]], teacher_encode_fn,
                 combinations: Sequence[Tuple[str, str]], name: str = ""):
        self.combinations = list(combinations)
        self.name = name
        self.data: Dict[Tuple[str, str], Tuple[List[str], List[str]]] = {}
        all_sources: List[str] = []
        seen = set()
        for src_lang, trg_lang in self.combinations:
            src, trg = [], []
            for row in rows:
                if row[src_lang].strip() and row[trg_lang].strip():
                    src.append(row[src_lang])
                    trg.append(row[trg_lang])
                    if row[src_lang] not in seen:
                        seen.add(row[src_lang])
                        all_sources.append(row[src_lang])
            self.data[(src_lang, trg_lang)] = (src, trg)
        embs = np.asarray(teacher_encode_fn(all_sources), np.float64)
        self.teacher = dict(zip(all_sources, embs))

    def compute(self, encode_fn) -> Dict[str, float]:
        out = {}
        for src_lang, trg_lang in self.combinations:
            src, trg = self.data[(src_lang, trg_lang)]
            t = np.asarray([self.teacher[s] for s in src])
            s = np.asarray(encode_fn(trg), np.float64)
            out[f"{src_lang}-{trg_lang}"] = float(np.mean((t - s) ** 2) * 100)
        return out

    def __call__(self, encode_fn) -> float:
        return -float(np.mean(list(self.compute(encode_fn).values())))


class SequentialEvaluator:
    """Run several evaluators; the score is main_score_function of their scores
    (default: the last one, like ST's SequentialEvaluator)."""

    def __init__(self, evaluators: Sequence[Callable],
                 main_score_function: Optional[Callable] = None):
        self.evaluators = list(evaluators)
        self.main_score_function = main_score_function or (lambda scores: scores[-1])

    def __call__(self, encode_fn) -> float:
        return self.main_score_function([ev(encode_fn) for ev in self.evaluators])
