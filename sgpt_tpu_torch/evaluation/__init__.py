"""The port's copies of the JAX package's evaluation modules that its CLIs
use (`sgpt_tpu/evaluation/`: metrics, beir, ir, aggregate, native)."""
from .metrics import (
    ndcg_at_k, map_at_k, recall_at_k, precision_at_k, mrr_at_k, accuracy_at_k,
    evaluate_retrieval, pearson, spearman,
)
from .beir import load_beir_dataset, EvaluateRetrieval
from .ir import InformationRetrievalEvaluator
from .aggregate import ResultsStore

__all__ = [
    "ndcg_at_k", "map_at_k", "recall_at_k", "precision_at_k", "mrr_at_k",
    "accuracy_at_k", "evaluate_retrieval", "pearson", "spearman",
    "load_beir_dataset", "EvaluateRetrieval", "InformationRetrievalEvaluator",
    "ResultsStore",
]
