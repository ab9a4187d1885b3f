"""The port's copies of the JAX package's evaluation modules
(`sgpt_tpu/evaluation/`: metrics, beir, sts, ir, extra, useb, aggregate,
native), exported under the JAX names."""
from .metrics import (
    ndcg_at_k, map_at_k, recall_at_k, precision_at_k, mrr_at_k, accuracy_at_k,
    evaluate_retrieval, pearson, spearman,
)
from .beir import load_beir_dataset, EvaluateRetrieval
from .sts import EmbeddingSimilarityEvaluator
from .ir import InformationRetrievalEvaluator
from .extra import (TripletEvaluator, BinaryClassificationEvaluator,
                    RerankingEvaluator, MSEEvaluator, TranslationEvaluator,
                    SequentialEvaluator, LabelAccuracyEvaluator,
                    MSEEvaluatorFromDataFrame)
from .aggregate import ResultsStore

__all__ = [
    "ndcg_at_k", "map_at_k", "recall_at_k", "precision_at_k", "mrr_at_k",
    "accuracy_at_k", "evaluate_retrieval", "pearson", "spearman",
    "load_beir_dataset", "EvaluateRetrieval",
    "EmbeddingSimilarityEvaluator", "InformationRetrievalEvaluator",
    "TripletEvaluator", "BinaryClassificationEvaluator", "RerankingEvaluator",
    "MSEEvaluator", "TranslationEvaluator", "SequentialEvaluator",
    "LabelAccuracyEvaluator", "MSEEvaluatorFromDataFrame",
    "ResultsStore",
]
