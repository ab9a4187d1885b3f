"""The port's copies of the JAX package's data modules (`sgpt_tpu/data/`:
batching, msmarco, nli, datasets, readers, jsonl_native), exported under
the JAX names."""
from .batching import InputExample, NoDuplicatesBatcher
from .nli import build_nli_triplets, load_nli_tsv
from .msmarco import MSMARCOTriplets, filter_hard_negatives
from .datasets import (SentenceLabelBatcher, ParallelSentencesData,
                       denoise_text, contrastive_tension_batches,
                       DenoisingBatcher)
from .readers import STSDataReader, NLIDataReader, TripletReader

__all__ = ["InputExample", "NoDuplicatesBatcher", "build_nli_triplets",
           "load_nli_tsv", "MSMARCOTriplets", "filter_hard_negatives",
           "SentenceLabelBatcher", "ParallelSentencesData", "denoise_text",
           "contrastive_tension_batches", "DenoisingBatcher",
           "STSDataReader", "NLIDataReader", "TripletReader"]
