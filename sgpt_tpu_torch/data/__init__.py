"""The port's copies of the JAX package's data modules that its training
CLI and serving use (`sgpt_tpu/data/`: batching, msmarco, jsonl_native)."""
from .batching import InputExample, NoDuplicatesBatcher
from .msmarco import MSMARCOTriplets, filter_hard_negatives

__all__ = ["InputExample", "NoDuplicatesBatcher", "MSMARCOTriplets",
           "filter_hard_negatives"]
